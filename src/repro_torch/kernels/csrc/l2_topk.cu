// Segmented brute-force distance scan with per-segment top-k, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/l2_topk.py:l2_topk_pallas (body
// _scan_kernel), which ran one launch per segment with a sequential grid over
// base tiles and a running [TQ, k] top-k carried in VMEM scratch.
//
// What bounds it: the f32 product 2*nq*N*D.  At nq=100 over 1M x 768 rows
// that is 1.5e11 FLOP (2.3 ms at 67 TFLOP/s f32) against a 3.07 GB read of
// the base (0.92 ms at 3.35 TB/s), so it is compute-bound; at nq=1 it is
// bound by the read of the base.
//
// Design.  Blocks on Hopper run in no order, so the sequential carry becomes
// two passes inside one call (scan_common.cuh): a register-tiled f32 score
// pass over every segment of the class into a [nq, N] scratch, then a
// per-(segment, query) radix select + bitonic sort.  Here the rows are f32.
#include "scan_common.cuh"

namespace {

struct F32Rows {
  __device__ __forceinline__ float load(const void* base, long long r, int c, int d) const {
    return reinterpret_cast<const float*>(base)[r * d + c];
  }
};

}  // namespace

extern "C" int repro_l2_topk_max_k() { return kMaxK; }
// The wrapper builds the table's tile offsets with this tile height.
extern "C" int repro_l2_topk_tile_rows() { return BN; }

// queries [nq, d] f32; tab: the packed segment table on the device;
// scores: [nq, ld] f32 scratch, ld = total rows of the class; outputs
// [nq, S * k].  Returns the CUDA error code of the launches (0 = success).
extern "C" int repro_l2_topk(const float* q, int nq, int d, const long long* tab,
                             int S, long long total_tiles, float* scores,
                             long long ld, int k, int ip, float* out_v,
                             long long* out_i, cudaStream_t stream) {
  return launch_scan(q, nq, d, tab, S, total_tiles, scores, ld, k, ip, out_v, out_i, stream,
                     F32Rows{});
}
