// Segmented brute-force distance scan with per-segment top-k, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/l2_topk.py:l2_topk_pallas (body
// _scan_kernel), which ran one launch per segment with a sequential grid over
// base tiles and a running [TQ, k] top-k carried in VMEM scratch.
//
// What bounds it, at float32 accuracy: the product 2*nq*N*D done as three
// TF32 tensor-core products (3xTF32), against the read of the base.  At
// nq=100 over 1M x 768 rows that is 3 x 1.5e11 FLOP (0.93 ms at 495 TFLOP/s
// TF32) against 3.07 GB (0.92 ms at 3.35 TB/s): the two bounds meet.  At
// nq=1 it is bound by the read of the base.
//
// Design (scan_common.cuh).  Blocks on Hopper run in no order, so the
// sequential carry becomes a score pass into a [nq, N] scratch and a
// two-stage select that reads each score once.  The score pass at nq > 4
// runs wgmma TF32 in 3xTF32 over a 4-stage cp.async ring, 128 rows x up to
// 128 queries per block (the base is read once at nq <= 128), each 8-deep
// step of the product summed in a fresh fragment before it joins the f32
// total; at nq <= 4 one warp per row streams the base with 16-byte loads
// and f32 FMAs.  The largest score error against the plain float32 version
// and against float64 is printed by chip_smoke.py's kernel phase and kept in
// PERF.md.  Here the rows are f32.
#include "scan_common.cuh"

namespace {

struct F32Rows {
  static constexpr bool kCodes = false;
  static constexpr int kXBytes = BN * kLdF * 4;  // 18 KB
  static constexpr int kParFloats = 0;
  static constexpr int kSmallQ = 4;  // measured: chip_smoke.py's path_crossover

  int tile_vec(int d, int xalign) const { return d % 4 == 0 && xalign >= 16; }
  int small_vec(int d, int xalign) const { return d % 4 == 0 && xalign >= 16; }

  // Rows r0 .. r0 + BN of columns k0 .. k0 + BK, zero past n and d; vec: 16
  // bytes per copy (d % 4 == 0, 16-byte aligned).
  __device__ __forceinline__ void load_tile(unsigned char* tile_bytes, const void* base,
                                            long long r0, long long n, int k0, int d, bool vec,
                                            int tid) const {
    float* tile = reinterpret_cast<float*>(tile_bytes);
    const float* src = reinterpret_cast<const float*>(base);
    if (vec) {
      for (int i = tid; i < BN * (BK / 4); i += kThreads) {
        const int row = i >> 3, c = (i & 7) * 4;
        const long long r = r0 + row;
        const bool ok = r < n && k0 + c < d;
        cp_async16(tile + row * kLdF + c, ok ? src + r * d + k0 + c : src, ok);
      }
    } else {
      for (int i = tid; i < BN * BK; i += kThreads) {
        const int row = i / BK, c = i % BK;
        const long long r = r0 + row;
        tile[row * kLdF + c] = (r < n && k0 + c < d) ? src[r * d + k0 + c] : 0.f;
      }
    }
  }

  __device__ __forceinline__ float at(const unsigned char* tile, int row, int c,
                                      const float* /*ps*/) const {
    return reinterpret_cast<const float*>(tile)[row * kLdF + c];
  }

  template <int NQ, bool kStaged>
  __device__ __forceinline__ void dot_row(const void* base, long long r, int d, bool vec, int lane,
                                          const float* const (&qrow)[NQ], const float* /*par*/,
                                          int /*dpad*/, float (&acc)[NQ], float& xn) const {
    const float* __restrict__ x = reinterpret_cast<const float*>(base) + r * d;
    if (vec) {
      const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
      for (int c = lane; c < d / 4; c += 32) {
        const float4 v = __ldg(x4 + c);
        xn = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, xn))));
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(qrow[j] + 4 * c);
          acc[j] = fmaf(v.x, w.x, fmaf(v.y, w.y, fmaf(v.z, w.z, fmaf(v.w, w.w, acc[j]))));
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float v = x[c];
        xn = fmaf(v, v, xn);
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[j] = fmaf(v, qrow[j][c], acc[j]);
      }
    }
  }
};

}  // namespace

extern "C" int repro_l2_topk_max_k() { return kMaxK; }
// The wrapper builds the table's tile and chunk offsets with these.
extern "C" int repro_l2_topk_tile_rows() { return BN; }
extern "C" int repro_l2_topk_chunk_rows() { return kChunkRows; }
// The default nq threshold of the byte-bound score path, and its largest.
extern "C" int repro_l2_topk_small_q() { return F32Rows::kSmallQ; }
extern "C" int repro_l2_topk_small_q_max() { return kSmallQMax; }

// queries [nq, d] f32; tab: the packed segment table on the device; n_rows:
// total rows of the class; qalign / xalign: the largest power of two (<= 16)
// dividing the query pointer / every segment pointer; small_q: nq at or
// below which the byte-bound score path runs; scores: [nq, ld] f32
// scratch, ld = max(n_rows, 1); cand: [nq, total_chunks * k] u64 scratch
// when multi_chunk; outputs [nq, S * k].  Returns the CUDA error code of the
// launches (0 = success).
extern "C" int repro_l2_topk(const float* q, int nq, int d, const long long* tab, int S,
                             long long total_tiles, long long n_rows, int qalign, int xalign,
                             int small_q, float* scores, long long ld, int k, int ip, long long total_chunks,
                             int multi_chunk, unsigned long long* cand, float* out_v,
                             long long* out_i, cudaStream_t stream) {
  return launch_scan(q, nq, d, tab, S, total_tiles, n_rows, qalign, xalign, 16, small_q, scores,
                     ld, k, ip, total_chunks, multi_chunk, cand, out_v, out_i, stream, F32Rows{});
}
