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
// PERF.md.  Here the rows are f32 (F32Rows in scan_common.cuh, shared with
// kmeans_assign.cu).
#include "scan_common.cuh"

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
