// Nearest-centroid assignment (the k-means E-step), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/kmeans_assign.py:
// kmeans_assign_pallas (body _assign_kernel), which walked centroid tiles
// as a sequential grid axis and carried the running (min, argmin) per row
// in VMEM scratch, with far-away sentinel centroids padding the last tile.
//
// What bounds it: the f32 product 2*N*C*D.  At an IVF build's Lloyd step
// (100,000 sampled rows, 128 centroids, D = 768) that is 1.97e10 FLOP
// (0.29 ms at 67 TFLOP/s f32) against a 0.31 GB read of the rows
// (0.09 ms at 3.35 TB/s): compute-bound.
//
// Design.  One block owns 64 rows and walks every centroid in 64-wide
// tiles itself, so no carry crosses blocks.  A register-tiled f32 product
// (16 x 16 threads, each 4 rows x 4 centroids, no tensor cores, no TF32)
// gives x.c; the row and centroid norms come from the same shared-memory
// tiles, and d2 = (|x|^2 - 2 x.c) + |c|^2 is the host expression's order.
// Centroids past C in the last tile are masked, never padded.  The
// earliest centroid wins ties, as np.argmin does: each thread visits its
// centroids in increasing index with a strict <, and the 16 threads that
// share a row combine their (d2, index) pairs taking the smaller index on
// equal d2.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int BN = 64;         // rows per block
constexpr int BC = 64;         // centroids per tile
constexpr int BK = 16;         // depth step

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, int n, int d,
                     const float* __restrict__ cent, int nc,
                     long long* __restrict__ out_a, float* __restrict__ out_d) {
  __shared__ float Xs[BK][BN + 1];
  __shared__ float Cs[BK][BC + 1];
  __shared__ float xn_s[BN];
  __shared__ float cn_s[BC];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long r0 = (long long)blockIdx.x * BN;

  float best_d[4];
  long long best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_d[i] = INFINITY;
    best_i[i] = 0;
  }

  for (int c0 = 0; c0 < nc; c0 += BC) {
    float acc[4][4];
    float xpart[4], cpart[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xpart[i] = 0.f;
      cpart[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < d; k0 += BK) {
      // Thread (tx, ty) loads column k0 + tx of local rows (and centroids)
      // ty + 16 j: a half-warp reads 64 contiguous bytes of one row.
      const int col = k0 + tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long r = r0 + ty + 16 * j;
        const float v = (r < n && col < d) ? x[r * d + col] : 0.f;
        Xs[tx][ty + 16 * j] = v;
        xpart[j] = fmaf(v, v, xpart[j]);
        const int cc = c0 + ty + 16 * j;
        const float w = (cc < nc && col < d) ? cent[(long long)cc * d + col] : 0.f;
        Cs[tx][ty + 16 * j] = w;
        cpart[j] = fmaf(w, w, cpart[j]);
      }
      __syncthreads();
      // Each BK-deep chunk is summed apart, then added to the running total
      // (D/BK roundings at full magnitude instead of D).
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Xs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Cs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
      __syncthreads();
    }
    // Norms: each half-warp (fixed ty, tx = 0..15) holds the 16 column
    // partials of rows / centroids ty + 16 j.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = xpart[j], w = cpart[j];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, o);
        w += __shfl_xor_sync(0xffffffffu, w, o);
      }
      if (tx == 0) {
        xn_s[ty + 16 * j] = v;
        cn_s[ty + 16 * j] = w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = c0 + tx + 16 * j;
        if (cc >= nc) continue;
        // (|x|^2 - 2 x.c) + |c|^2; the _rn intrinsics keep nvcc from
        // contracting it into an FMA.
        const float d2 = __fadd_rn(__fsub_rn(xn_s[ty + 16 * i], __fmul_rn(2.f, acc[i][j])),
                                   cn_s[tx + 16 * j]);
        if (d2 < best_d[i]) {
          best_d[i] = d2;
          best_i[i] = cc;
        }
      }
    }
    __syncthreads();  // xn_s / cn_s are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bd = best_d[i];
    long long bi = best_i[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const long long oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const long long r = r0 + ty + 16 * i;
    if (tx == 0 && r < n) {
      out_a[r] = bi;
      out_d[r] = bd;
    }
  }
}

}  // namespace

// x [n, d] f32, centroids [nc, d] f32 (nc >= 1); outputs assign [n] int64 and
// min squared distance [n] f32.  Returns the CUDA error code of the launch.
extern "C" int repro_kmeans_assign(const float* x, long long n, int d, const float* cent,
                                   int nc, long long* out_a, float* out_d,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + BN - 1) / BN;
  kmeans_assign_kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, (int)n, d, cent, nc, out_a, out_d);
  return (int)cudaGetLastError();
}
