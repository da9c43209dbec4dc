// The segmented distance scan shared by l2_topk.cu (f32 rows) and
// sq_codec.cu (uint8 SQ codes, dequantized on load), and the per-segment
// top-k select that l2_topk.cu, sq_codec.cu and pq_adc.cu all run over a
// [nq, N] score scratch.  Included by exactly one translation unit per
// shared library, so everything here has internal linkage.
//
// Score pass (scores_kernel): one block per (query tile, 64-row base tile)
// over every segment of the call at once (segments are addressed through a
// small device table, never copied together).  A register-tiled f32
// product (no tensor cores, no TF32) computes q.x, the row norms are
// accumulated from the same shared-memory tiles, and the score
// (|q|^2 - 2 q.x) + |x|^2 (L2) or -q.x (IP) is written with invalid rows at
// +inf into the scratch row.  Query tiles are 16 rows for nq <= 16 (the
// base is then read once) and 64 rows otherwise; each 16-deep chunk of the
// product is summed apart before it joins the running total.  The row
// loader is a template parameter: it returns base element (r, c) as a float.
//
// Select pass (topk_select_kernel): one block per (segment, query).  An
// 8-bit MSB radix select finds the k-th smallest key in four histogram
// passes, a gather pass takes every key below it plus the lowest-indexed
// keys equal to it, and a bitonic sort in shared memory orders the k
// survivors by (key, row).  Rows past the segment's live count carry
// (+inf L2 / -inf IP, -1), and |score| >= 1e38 maps to index -1, as in
// src/repro/kernels/ops.py:topk_scan.  k is limited to kMaxK (the
// shared-memory candidate buffer).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cub/block/block_scan.cuh>

#include "topk_common.cuh"

namespace {

using repro_torch::bitonic_sort;
using repro_torch::float_key;

constexpr int kThreads = 256;  // score kernel: 16 x 16 threads
constexpr int BN = 64;         // base rows per tile
constexpr int BK = 16;         // depth step
constexpr int kSelThreads = 1024;
constexpr int kMaxK = 1024;

// Packed int64 segment table, column-major over S segments:
// rows[S] | base ptr[S] | valid ptr[S] (0 = all valid) | score column offset[S]
// | first tile[S + 1].
struct SegTable {
  const long long* rows;
  const long long* base;
  const long long* valid;
  const long long* col_off;
  const long long* tile_start;
};

__device__ __forceinline__ SegTable seg_table(const long long* tab, int S) {
  SegTable t;
  t.rows = tab;
  t.base = tab + S;
  t.valid = tab + 2 * S;
  t.col_off = tab + 3 * S;
  t.tile_start = tab + 4 * S;
  return t;
}

// Largest s with tile_start[s] <= tile: the segment owning a tile (segments
// without rows share their successor's start and are never chosen).
__device__ __forceinline__ int owner_segment(const long long* tile_start, int S,
                                             long long tile) {
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <int MQ, class Rows>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ q, int nq, int d,
              const long long* __restrict__ tab, int S,
              float* __restrict__ scores, long long ld, int ip, Rows rows_of) {
  constexpr int BQ = 16 * MQ;
  __shared__ float Qs[BK][BQ + 1];
  __shared__ float Xs[BK][BN + 1];
  __shared__ float qn_s[BQ];
  __shared__ float xn_s[BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const SegTable t = seg_table(tab, S);
  const long long tile = blockIdx.x;
  const int s = owner_segment(t.tile_start, S, tile);
  const long long n_s = t.rows[s];
  const long long r0 = (tile - t.tile_start[s]) * BN;
  const void* base = reinterpret_cast<const void*>(t.base[s]);
  const unsigned char* __restrict__ valid =
      reinterpret_cast<const unsigned char*>(t.valid[s]);
  const int q0 = blockIdx.y * BQ;

  float acc[MQ][4];
  float qpart[MQ], xpart[4];
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    qpart[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) xpart[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    // Thread (tx, ty) loads column k0 + tx of local rows ty + 16 j: a
    // half-warp reads one row's 16 contiguous elements.
    const int c = k0 + tx;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = r0 + ty + 16 * j;
      const float v = (r < n_s && c < d) ? rows_of.load(base, r, c, d) : 0.f;
      Xs[tx][ty + 16 * j] = v;
      xpart[j] = fmaf(v, v, xpart[j]);
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      const int r = q0 + ty + 16 * i;
      const float v = (r < nq && c < d) ? q[(long long)r * d + c] : 0.f;
      Qs[tx][ty + 16 * i] = v;
      qpart[i] = fmaf(v, v, qpart[i]);
    }
    __syncthreads();
    // Each BK-deep chunk is summed apart, then added to the running total:
    // the long sum takes D/BK roundings at full magnitude instead of D
    // (q.x of correlated vectors grows large, and so would its error).
    float part[MQ][4];
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[MQ], b[4];
#pragma unroll
      for (int i = 0; i < MQ; ++i) a[i] = Qs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Xs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  // Row norms: each half-warp (fixed ty, tx = 0..15) holds the 16 column
  // partials of its rows.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = xpart[j];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tx == 0) xn_s[ty + 16 * j] = v;
  }
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    float v = qpart[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (tx == 0) qn_s[ty + 16 * i] = v;
  }
  __syncthreads();

  const long long col0 = t.col_off[s] + r0;
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int ql = ty + 16 * i;
    if (q0 + ql >= nq) continue;
    float* __restrict__ out = scores + (long long)(q0 + ql) * ld + col0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx + 16 * j;
      if (r0 + rl >= n_s) continue;
      // Same operation order as the host expression q_norm - 2 q.x + x_norm;
      // the _rn intrinsics keep nvcc from contracting it into an FMA.
      float sc = ip ? -acc[i][j]
                    : __fadd_rn(__fsub_rn(qn_s[ql], __fmul_rn(2.f, acc[i][j])),
                                xn_s[rl]);
      if (valid != nullptr && valid[r0 + rl] == 0) sc = INFINITY;
      out[rl] = sc;
    }
  }
}

__global__ void __launch_bounds__(kSelThreads)
topk_select_kernel(const float* __restrict__ scores, long long ld,
                   const long long* __restrict__ tab, int S, int k, int ip,
                   float* __restrict__ out_v, long long* __restrict__ out_i) {
  typedef cub::BlockScan<int, kSelThreads> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ unsigned int hist[256];
  __shared__ unsigned long long cand[kMaxK];
  __shared__ unsigned int sh_prefix;
  __shared__ int sh_need;
  __shared__ int sh_count;

  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const long long qi = blockIdx.y;
  const SegTable t = seg_table(tab, S);
  const long long n_s = t.rows[s];
  const float* __restrict__ row = scores + qi * ld + t.col_off[s];
  float* __restrict__ ov = out_v + (qi * S + s) * k;
  long long* __restrict__ oi = out_i + (qi * S + s) * k;
  const int k_eff = (int)(n_s < (long long)k ? n_s : (long long)k);

  if (k_eff > 0) {
    // Radix select of the k_eff-th smallest key, 8 bits per pass.
    unsigned int prefix = 0u, mask = 0u;
    int need = k_eff;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = tid; b < 256; b += kSelThreads) hist[b] = 0u;
      __syncthreads();
      for (long long r = tid; r < n_s; r += kSelThreads) {
        const unsigned int key = float_key(row[r]);
        if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        int below = 0, b = 0;
        for (; b < 255; ++b) {
          const int h = (int)hist[b];
          if (below + h >= need) break;
          below += h;
        }
        sh_prefix = prefix | ((unsigned int)b << shift);
        sh_need = need - below;
      }
      __syncthreads();
      prefix = sh_prefix;
      need = sh_need;
      mask |= 255u << shift;
      __syncthreads();
    }
    // prefix is the threshold key T; take every key < T and the first
    // `need` keys == T in row order (exactly k_eff candidates).
    if (tid == 0) sh_count = 0;
    __syncthreads();
    int eq_seen = 0;
    for (long long r0 = 0; r0 < n_s; r0 += kSelThreads) {
      const long long r = r0 + tid;
      unsigned int key = 0u;
      int lt = 0, eq = 0;
      if (r < n_s) {
        key = float_key(row[r]);
        lt = key < prefix;
        eq = key == prefix;
      }
      int eq_rank, eq_total;
      Scan(scan_tmp).ExclusiveSum(eq, eq_rank, eq_total);
      if (lt || (eq && eq_seen + eq_rank < need)) {
        const int pos = atomicAdd(&sh_count, 1);
        cand[pos] = ((unsigned long long)key << 32) | (unsigned long long)r;
      }
      eq_seen += eq_total;
      __syncthreads();
    }
    int p2 = 1;
    while (p2 < k_eff) p2 <<= 1;
    for (int i = k_eff + tid; i < p2; i += kSelThreads) cand[i] = ~0ull;
    __syncthreads();
    bitonic_sort(cand, p2);
    for (int j = tid; j < k_eff; j += kSelThreads) {
      const long long r = (long long)(cand[j] & 0xffffffffull);
      const float v = row[r];
      oi[j] = fabsf(v) >= 1e38f ? -1 : r;
      ov[j] = ip ? -v : v;
    }
  }
  const float fill = ip ? -INFINITY : INFINITY;
  for (int j = k_eff + tid; j < k; j += kSelThreads) {
    ov[j] = fill;
    oi[j] = -1;
  }
}

// The per-segment select over a filled score scratch; returns the CUDA
// error code of the launch (0 = success).
inline int select_topk(const float* scores, long long ld, const long long* tab, int S,
                       int nq, int k, int ip, float* out_v, long long* out_i,
                       cudaStream_t stream) {
  dim3 grid((unsigned int)S, (unsigned int)nq);
  topk_select_kernel<<<grid, kSelThreads, 0, stream>>>(scores, ld, tab, S, k, ip, out_v, out_i);
  return (int)cudaGetLastError();
}

// Score pass over every tile of the table, then the per-segment select.
// Returns the CUDA error code of the launches (0 = success).
template <class Rows>
int launch_scan(const float* q, int nq, int d, const long long* tab, int S,
                long long total_tiles, float* scores, long long ld, int k,
                int ip, float* out_v, long long* out_i, cudaStream_t stream,
                Rows rows_of) {
  if (total_tiles > 0) {
    if (nq <= 16) {
      dim3 grid((unsigned int)total_tiles, (unsigned int)((nq + 15) / 16));
      scores_kernel<1, Rows><<<grid, kThreads, 0, stream>>>(q, nq, d, tab, S, scores, ld, ip,
                                                            rows_of);
    } else {
      dim3 grid((unsigned int)total_tiles, (unsigned int)((nq + 63) / 64));
      scores_kernel<4, Rows><<<grid, kThreads, 0, stream>>>(q, nq, d, tab, S, scores, ld, ip,
                                                            rows_of);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return select_topk(scores, ld, tab, S, nq, k, ip, out_v, out_i, stream);
}

}  // namespace
