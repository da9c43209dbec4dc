// k-way top-k merge with primary-key dedup, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/merge_topk.py:merge_topk_pallas
// (body _merge_kernel), a k-step min/argmin loop that retired every
// occurrence of each picked pk.  That kernel took int32 pks only; this one
// takes int64 pks and matches the host merge (src/repro/kernels/ops.py:
// merge_topk): candidates with pk < 0 or a non-finite score are dropped,
// -0.0 compares equal to +0.0, each pk keeps its best occurrence, and ties
// break by pool column.
//
// What bounds it: the pools are tiny (nq x M x 12 bytes, M = partials x k),
// so a launch is bound by its latency, not by bytes or operations.
//
// Design: one block per query row, the whole row in shared memory.
//   1. Each candidate becomes a pair (orderable pk, key<<32 | column), dead
//      candidates carrying key 0xffffffff.
//   2. A bitonic sort of the pairs groups each pk with its occurrences in
//      (key, column) order; the first of a group is the pk's best occurrence.
//   3. Survivors keep their (key, column) compound, the rest become ~0; a
//      second bitonic sort orders the survivors and the first k are written
//      with their original score and pk.  Missing slots carry the metric's
//      fill (+inf L2, -inf IP) and pk -1.
// M is limited to kMaxM (16 bytes of shared memory per candidate); the
// wrapper raises above it.
#include <cuda_runtime.h>
#include <math.h>

#include "topk_common.cuh"

namespace {

using repro_torch::bitonic_sort;
using repro_torch::bitonic_sort_pairs;
using repro_torch::float_key;

constexpr int kThreads = 512;
constexpr int kMaxM = 8192;
constexpr int kPerThread = kMaxM / kThreads;

__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(const float* __restrict__ s, const long long* __restrict__ p,
                  int m, int p2, int k, int ip, float* __restrict__ out_v,
                  long long* __restrict__ out_p) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* hk = smem;       // [p2] orderable pk
  unsigned long long* lk = smem + p2;  // [p2] key << 32 | column
  const long long qi = blockIdx.x;
  const float* __restrict__ srow = s + qi * m;
  const long long* __restrict__ prow = p + qi * m;

  for (int c = threadIdx.x; c < p2; c += kThreads) {
    if (c < m) {
      const float sc = srow[c];
      const long long pk = prow[c];
      const bool alive = pk >= 0 && isfinite(sc);
      const unsigned int key = alive ? float_key(ip ? -sc : sc) : 0xffffffffu;
      hk[c] = (unsigned long long)pk ^ 0x8000000000000000ull;
      lk[c] = ((unsigned long long)key << 32) | (unsigned long long)c;
    } else {
      hk[c] = ~0ull;
      lk[c] = ~0ull;
    }
  }
  __syncthreads();
  bitonic_sort_pairs(hk, lk, p2);

  unsigned long long keep[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < p2) {
      const bool first = c == 0 || hk[c] != hk[c - 1];
      const bool alive = (lk[c] >> 32) != 0xffffffffull;
      keep[i] = (first && alive) ? lk[c] : ~0ull;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < p2) lk[c] = keep[i];
  }
  __syncthreads();
  bitonic_sort(lk, p2);

  const float fill = ip ? -INFINITY : INFINITY;
  for (int j = threadIdx.x; j < k; j += kThreads) {
    const unsigned long long w = j < p2 ? lk[j] : ~0ull;
    if (w != ~0ull) {
      const int c = (int)(w & 0xffffffffull);
      out_v[qi * k + j] = srow[c];
      out_p[qi * k + j] = prow[c];
    } else {
      out_v[qi * k + j] = fill;
      out_p[qi * k + j] = -1;
    }
  }
}

}  // namespace

extern "C" int repro_merge_topk_max_m() { return kMaxM; }

// scores [nq, m] f32, pks [nq, m] i64 -> out [nq, k] f32 / i64.  Returns the
// CUDA error code of the launch (0 = success).
extern "C" int repro_merge_topk(const float* s, const long long* p, int nq, int m,
                                int k, int ip, float* out_v, long long* out_p,
                                cudaStream_t stream) {
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  const size_t smem = 2 * sizeof(unsigned long long) * (size_t)p2;
  cudaError_t e = cudaFuncSetAttribute(
      merge_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * sizeof(unsigned long long) * kMaxM));
  if (e != cudaSuccess) return (int)e;
  merge_topk_kernel<<<(unsigned int)nq, kThreads, smem, stream>>>(s, p, m, p2, k, ip,
                                                                 out_v, out_p);
  return (int)cudaGetLastError();
}
