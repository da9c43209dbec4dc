// Nearest-centroid assignment (the k-means E-step), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py:
// kmeans_assign_pallas (body _assign_kernel), which walked centroid tiles
// as a sequential grid axis and carried the running (min, argmin) per row
// in VMEM scratch, with far-away sentinel centroids padding the last tile.
// The reference calls it the K=1 special case of the scan kernels, and here
// it is one: the two score passes of scan_common.cuh with the rows as the
// base and the centroids as the queries, and an argmin epilogue (AssignEpi)
// in place of the score write.
//
// What bounds it, at float32 accuracy on the tensor cores (3xTF32:
// 3 x 2 N C D operations at 495 TFLOP/s) against the bytes of the rows and
// centroids read once (3.35 TB/s), at the shapes the build paths launch:
// an IVF build's Lloyd step, 100,000 x 128 x 768, operations (0.119 ms;
// bytes 0.092 ms); the interim slice indexes' 2,048 x 16 x 768, bytes
// (1.9 us); the PQ subspaces' 131,072 x 256 x 16, operations (6.5 us).
// Measured there (device time, NVIDIA H100 80GB HBM3 at 700 W, chip_ab.py
// against the SIMT kernel this design replaced): 0.357 ms (1.003), 9.9 us
// (50.4) and 46.7 us (90.4).  The tensor-core pass stays ~3x its bound, as
// the scans' does: each 8-deep step waits for its wgmma group.
//
// Tensor-core path (C > small_c): wgmma_scores_kernel, 128 rows per block,
// 3xTF32 with each 8-deep step in a fresh fragment (the scans' accuracy
// rule) through the cp.async ring.  The epilogue computes d2 = (|x|^2 -
// 2 x.c) + |c|^2 in that order for each fragment element and keeps each
// thread's (min, index) per row.  Where C exceeds the 128-centroid tile the
// block walks the centroid tiles itself, in order, over the same rows
// (Epi::kWalk), carrying (min, index) in registers: no partials in device
// memory, no second pass, and the grid sets no limit on C.  After the last
// tile the four lanes that share a row combine by __shfl_xor, the smaller
// index winning equal d2.  Every thread visits its centroids in increasing
// index with a strict <, so the earliest centroid wins ties, as np.argmin
// does, and nothing depends on the order blocks run in: two builds from one
// seed save the same bytes.
//
// CUDA-core paths (C <= small_c).  Rows wider than kNarrowD floats take the
// byte-bound path, small_scores_kernel: one warp per row over every SM with
// the centroids staged in shared memory, 16-byte row loads and f32 FMAs per
// lane before a shuffle tree; lane 0 takes the argmin over the row's sums in
// index order.  It serves the interim slice indexes (nlist 16).
// Built for C up to kSmallCMax so that chip_smoke.py can time both paths at
// C = 8, 16 and 32.  By default it runs for C <= kSmallC where a row holds
// at least kRowFloatsPerC floats per centroid: its shuffle tree and shared
// reads grow with C, its row read with d, and on narrow rows most lanes idle.
// Timed against the tensor cores on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py's kmeans_assign score paths, C 8 / 16 / 32 at 2,048 rows,
// d 768 down to 32), it won at all 9 points with d >= 4 C and lost at all 3
// below.  Rows of at most kNarrowD floats (the PQ subspaces' 16) take
// narrow_assign_kernel at any C instead: one thread per row holds the row in
// registers and walks the centroids in index order, kNarrowChunk at a time
// broadcast from shared memory, x.c and the norms as f32 FMA chains over the
// row -- bound by its 2 N C d FMAs, where the tensor-core pass at d = 16 pays
// a tile's load, split and epilogue per 16 columns of work with one block
// per SM.  At 131,072 x C x 16 it beat the tensor cores 2-3x at C 8 to 256
// (47 us against 97 at C 256); at d = 32 it lost at 2,048 rows, so wider
// rows keep the rule above.
#include "scan_common.cuh"

namespace {

constexpr int kSmallC = 32;         // default threshold of the byte-bound path
constexpr int kRowFloatsPerC = 4;   // ... on rows of at least this many floats per centroid
constexpr int kSmallCMax = 32;      // largest C the byte-bound path is built for
constexpr int kNarrowD = 16;        // rows of at most this many floats: narrow_assign_kernel
constexpr int kNarrowThreads = 256;  // rows per block
constexpr int kNarrowChunk = 256;    // centroids per shared-memory pass (16 KB at DP = 16)

struct AssignEpi {
  long long* out_a;
  float* out_d;
  static constexpr bool kWalk = true;
  struct State {  // the thread's best (d2, centroid) for rows frag_row and frag_row + 8
    float d[2] = {INFINITY, INFINITY};
    int i[2] = {0, 0};
  };

  __device__ __forceinline__ bool x_norms() const { return true; }

  template <int BQ>
  __device__ __forceinline__ void tile(State& st, const float (&acc)[BQ / 2], const float* xn_s,
                                       const float* qn_s, int frag_row, int t4, const SegRows&,
                                       int q0, int nq) const {
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int ql = 8 * j + 2 * t4 + (i & 1);
        if (q0 + ql >= nq) continue;
        // (|x|^2 - 2 x.c) + |c|^2; the _rn intrinsics keep nvcc from
        // contracting it into an FMA.
        const float d2 = __fadd_rn(__fsub_rn(xn_s[frag_row + 8 * h], __fmul_rn(2.f, acc[4 * j + i])),
                                   qn_s[ql]);
        if (d2 < st.d[h]) {
          st.d[h] = d2;
          st.i[h] = q0 + ql;
        }
      }
  }

  __device__ __forceinline__ void finish(State& st, int frag_row, int t4, const SegRows& sg) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bd = st.d[h];
      int bi = st.i[h];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      const long long r = sg.r + frag_row + 8 * h;
      if (t4 == 0 && r < sg.n) {
        out_a[r] = bi;
        out_d[r] = bd;
      }
    }
  }

  template <int NQ>
  __device__ __forceinline__ void row(const float (&acc)[NQ], float xn, const float* qn_s, int nq,
                                      int lane, const SegRows& sg) const {
    if (lane != 0) return;  // every lane holds the sums
    float bd = INFINITY;
    int bi = 0;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (j >= nq) continue;
      const float d2 = __fadd_rn(__fsub_rn(xn, __fmul_rn(2.f, acc[j])), qn_s[j]);
      if (d2 < bd) {
        bd = d2;
        bi = j;
      }
    }
    out_a[sg.r] = bi;
    out_d[sg.r] = bd;
  }
};

// Rows of at most DP floats (d <= DP, zero-padded to DP): the nearest of nc
// centroids per row, one thread per row; vec: 16-byte row loads (d % 4 == 0,
// x 16-byte aligned).
template <int DP>
__global__ void __launch_bounds__(kNarrowThreads)
narrow_assign_kernel(const float* __restrict__ x, long long n, int d, int vec,
                     const float* __restrict__ cent, int nc, long long* __restrict__ out_a,
                     float* __restrict__ out_d) {
  __shared__ __align__(16) float cs[kNarrowChunk * DP];  // a chunk of centroids, [j][DP]
  __shared__ float cn[kNarrowChunk];                     // their |c|^2
  const long long r = (long long)blockIdx.x * kNarrowThreads + threadIdx.x;
  float xr[DP];
  if (vec && r < n) {
#pragma unroll
    for (int c4 = 0; c4 < DP / 4; ++c4) {
      const float4 v = 4 * c4 < d ? __ldg(reinterpret_cast<const float4*>(x + r * d) + c4)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      xr[4 * c4] = v.x;
      xr[4 * c4 + 1] = v.y;
      xr[4 * c4 + 2] = v.z;
      xr[4 * c4 + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < DP; ++c) xr[c] = r < n && c < d ? x[r * d + c] : 0.f;
  }
  float xn = 0.f;
#pragma unroll
  for (int c = 0; c < DP; ++c) xn = fmaf(xr[c], xr[c], xn);
  float bd = INFINITY;
  int bi = 0;
  for (int c0 = 0; c0 < nc; c0 += kNarrowChunk) {
    const int cnt = nc - c0 < kNarrowChunk ? nc - c0 : kNarrowChunk;
    __syncthreads();  // the last chunk's reads are done
    for (int i = threadIdx.x; i < cnt * DP; i += kNarrowThreads) {
      const int j = i / DP, c = i % DP;
      cs[i] = c < d ? cent[(long long)(c0 + j) * d + c] : 0.f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kNarrowThreads) {
      float p = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) p = fmaf(cs[j * DP + c], cs[j * DP + c], p);
      cn[j] = p;
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4* cj = reinterpret_cast<const float4*>(cs + j * DP);
      float dot = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < DP / 4; ++c4) {
        const float4 v = cj[c4];
        dot = fmaf(xr[4 * c4], v.x, dot);
        dot = fmaf(xr[4 * c4 + 1], v.y, dot);
        dot = fmaf(xr[4 * c4 + 2], v.z, dot);
        dot = fmaf(xr[4 * c4 + 3], v.w, dot);
      }
      const float d2 = __fadd_rn(__fsub_rn(xn, __fmul_rn(2.f, dot)), cn[j]);
      if (d2 < bd) {
        bd = d2;
        bi = c0 + j;
      }
    }
  }
  if (r < n) {
    out_a[r] = bi;
    out_d[r] = bd;
  }
}

template <int DP>
int launch_narrow(const float* x, long long n, int d, int xalign, const float* cent, int nc,
                  long long* out_a, float* out_d, cudaStream_t stream) {
  const long long blocks = (n + kNarrowThreads - 1) / kNarrowThreads;
  narrow_assign_kernel<DP><<<(unsigned int)blocks, kNarrowThreads, 0, stream>>>(
      x, n, d, d % 4 == 0 && xalign >= 16, cent, nc, out_a, out_d);
  return (int)cudaGetLastError();
}

}  // namespace

// The default C at or below which the byte-bound path runs, the row floats
// per centroid it needs by default, the largest C it is built for, and the
// widest rows the narrow-row kernel takes (at any C).
extern "C" int repro_kmeans_assign_small_c() { return kSmallC; }
extern "C" int repro_kmeans_assign_row_floats_per_c() { return kRowFloatsPerC; }
extern "C" int repro_kmeans_assign_small_c_max() { return kSmallCMax; }
extern "C" int repro_kmeans_assign_narrow_d() { return kNarrowD; }

// x [n, d] f32, centroids [nc, d] f32 (nc >= 1); xalign / calign: the largest
// power of two (<= 16) dividing each pointer; small_c: the nc at or below
// which a CUDA-core path runs (on rows wider than kNarrowD, at most
// kSmallCMax); outputs assign [n] int64 and the min squared distance [n] f32.
// Returns the CUDA error code of the launch.
extern "C" int repro_kmeans_assign(const float* x, long long n, int d, const float* cent, int nc,
                                   int xalign, int calign, int small_c, long long* out_a,
                                   float* out_d, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (d > kNarrowD && small_c > kSmallCMax) return (int)cudaErrorInvalidValue;
  const OneSeg segs{x, n};
  const AssignEpi epi{out_a, out_d};
  const F32Rows rows{};
  if (nc <= small_c && d <= kNarrowD) {
    if (d <= 4) return launch_narrow<4>(x, n, d, xalign, cent, nc, out_a, out_d, stream);
    if (d <= 8) return launch_narrow<8>(x, n, d, xalign, cent, nc, out_a, out_d, stream);
    return launch_narrow<16>(x, n, d, xalign, cent, nc, out_a, out_d, stream);
  }
  if (nc <= small_c) {
    if (nc == 1) return launch_small<1>(cent, nc, d, segs, n, calign, xalign, stream, rows, epi);
    if (nc == 2) return launch_small<2>(cent, nc, d, segs, n, calign, xalign, stream, rows, epi);
    if (nc <= 4) return launch_small<4>(cent, nc, d, segs, n, calign, xalign, stream, rows, epi);
    if (nc <= 8) return launch_small<8>(cent, nc, d, segs, n, calign, xalign, stream, rows, epi);
    if (nc <= 16) return launch_small<16>(cent, nc, d, segs, n, calign, xalign, stream, rows, epi);
    return launch_small<32>(cent, nc, d, segs, n, calign, xalign, stream, rows, epi);
  }
  const long long tiles = (n + BN - 1) / BN;
  const int vq = d % 4 == 0 && calign >= 16;
  const int vx = rows.tile_vec(d, xalign);
  switch (nc >= 128 ? 8 : (nc + 15) / 16) {
    case 1: return launch_wgmma<1>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
    case 2: return launch_wgmma<2>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
    case 3: return launch_wgmma<3>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
    case 4: return launch_wgmma<4>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
    case 5: return launch_wgmma<5>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
    case 6: return launch_wgmma<6>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
    case 7: return launch_wgmma<7>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
    default: return launch_wgmma<8>(cent, nc, d, segs, tiles, vq, vx, 0, stream, rows, epi);
  }
}
