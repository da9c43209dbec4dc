// PQ asymmetric-distance (ADC) scan with top-k, for sm_90a.
//
// Replaces src/repro/kernels/pq_adc.py:pq_adc_topk_pallas (body
// _adc_kernel).  The TPU has no fast per-lane gather, so it turned each
// table lookup into a one-hot [TN, KSUB] x [KSUB, NQ] product per
// subquantizer and carried a running top-k over a sequential grid.  Hopper
// gathers from shared memory at full speed, so here the lookup is a lookup.
//
// What bounds it: by the roofline, the nq*N*M f32 adds (at nq=100 over
// 131,072 rows x 48 subquantizers, 6.3e8: 0.009 ms at 67 TFLOP/s) over the
// 11 MB of tables and uint8 codes.  In practice the shared-memory gathers
// bound it: one 4-byte lookup per add.
//
// Design.  Pass 1 (adc_scores_kernel): one block per (query, 4,096-row
// tile) copies the query's whole table [M, KSUB] into shared memory (48 KB
// at M = 48, KSUB = 256), then each thread walks its rows and sums
// LUT[m, code_m] for m = 0..M-1 in that order with IEEE adds, exactly as the
// host loop `scores += lut[:, m, codes[:, m]]` does, so the scores are
// bit-exact against the plain version.  Invalid rows score +inf.  Pass 2 is
// the two-stage select of scan_common.cuh over the [nq, N] scratch, which
// reads each score once: 16,384-row chunks give 8 blocks at nq=1 over a
// 131,072-row segment where one block walked it before.
// Codes are uint8 (KSUB <= 256, the device layout) or int32 (the saved
// layout) and must lie in [0, KSUB).
#include "scan_common.cuh"

namespace {

constexpr int kAdcThreads = 256;
constexpr int kAdcRows = 4096;  // rows per block: 16 per thread
constexpr int kMaxLutBytes = 232448;  // a block's shared-memory limit on sm_90

template <typename CodeT>
__global__ void __launch_bounds__(kAdcThreads)
adc_scores_kernel(const float* __restrict__ lut, const CodeT* __restrict__ codes,
                  const unsigned char* __restrict__ valid, long long n, int m, int ksub,
                  float* __restrict__ scores) {
  extern __shared__ float lut_s[];
  const long long qi = blockIdx.y;
  const float* __restrict__ lq = lut + qi * m * ksub;
  for (int i = threadIdx.x; i < m * ksub; i += kAdcThreads) lut_s[i] = lq[i];
  __syncthreads();
  const long long lo = (long long)blockIdx.x * kAdcRows;
  const long long hi = lo + kAdcRows < n ? lo + kAdcRows : n;
  float* __restrict__ out = scores + qi * n;
  for (long long r = lo + threadIdx.x; r < hi; r += kAdcThreads) {
    const CodeT* __restrict__ cr = codes + r * m;
    float acc = 0.f;
    for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, lut_s[j * ksub + (int)cr[j]]);
    if (valid != nullptr && valid[r] == 0) acc = INFINITY;
    out[r] = acc;
  }
}

template <typename CodeT>
int launch_adc(const float* lut, int nq, int m, int ksub, const CodeT* codes,
               const unsigned char* valid, long long n, const long long* tab, int k,
               float* scores, long long total_chunks, int multi_chunk, unsigned long long* cand,
               float* out_v, long long* out_i, cudaStream_t stream) {
  if (n > 0) {
    const int smem = m * ksub * (int)sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          adc_scores_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned int)((n + kAdcRows - 1) / kAdcRows), (unsigned int)nq);
    adc_scores_kernel<CodeT><<<grid, kAdcThreads, smem, stream>>>(lut, codes, valid, n, m, ksub,
                                                                  scores);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return select_topk(scores, n, tab, 1, nq, k, 0, total_chunks, multi_chunk, cand, out_v, out_i,
                     stream);
}

}  // namespace

extern "C" int repro_pq_adc_max_k() { return kMaxK; }
extern "C" int repro_pq_adc_max_lut_bytes() { return kMaxLutBytes; }

// luts [nq, m, ksub] f32; codes [n, m] uint8 (code_bytes = 1) or int32
// (code_bytes = 4); valid [n] uint8 or null; tab: a one-segment table
// (rows = n, column offset 0, chunks 0 .. total_chunks); scores: [nq, n] f32
// scratch; cand: [nq, total_chunks * k] u64 scratch when multi_chunk;
// outputs [nq, k] ascending.  Returns the CUDA error code of the launches.
extern "C" int repro_pq_adc_chunk_rows() { return kChunkRows; }

extern "C" int repro_pq_adc_topk(const float* lut, int nq, int m, int ksub, const void* codes,
                                 int code_bytes, const unsigned char* valid, long long n,
                                 const long long* tab, int k, float* scores,
                                 long long total_chunks, int multi_chunk,
                                 unsigned long long* cand, float* out_v, long long* out_i,
                                 cudaStream_t stream) {
  if (code_bytes == 1)
    return launch_adc(lut, nq, m, ksub, static_cast<const unsigned char*>(codes), valid, n, tab,
                      k, scores, total_chunks, multi_chunk, cand, out_v, out_i, stream);
  return launch_adc(lut, nq, m, ksub, static_cast<const int*>(codes), valid, n, tab, k, scores,
                    total_chunks, multi_chunk, cand, out_v, out_i, stream);
}
