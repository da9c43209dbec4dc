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
// What bounds it: the pools are tiny (nq x M x 12 bytes, M = partials x k:
// 200 to 8,192 columns on the main path, mostly at nq = 1), so a launch is
// bound by its latency -- the chain of dependent steps one query takes --
// not by bytes or operations.  The design shortens that chain.
//
// Each candidate becomes a compound key << 32 | column (float_key of the
// score, or of -score for IP; dead candidates key 0xffffffff), so one
// ascending order is (key, column) order.  A warp merges up to 32 R
// candidates: it reads them once, coalesced, stages their scores and pks in
// shared memory (every later lookup by column is a shared-memory read),
// holds R compounds per lane in registers and sorts them with a bitonic
// network that needs no block barrier: strides below R swap registers,
// wider ones exchange them between lanes with __shfl_xor_sync.  Dedup then
// walks the sorted compounds in rank order, 32 at a time, and stops once k
// survivors are out: a candidate survives if it is the first of its pk in
// its round (__match_any_sync) and its pk is not yet in the warp's table of
// accepted pks (open addressing in shared memory); the round's survivors
// enter the table and take the next output ranks (__ballot_sync, __popc).
// Its cost follows k, not M.
//
// Regimes, by pool width:
// - M <= kWarpMaxM: one warp per query, several queries per block.
// - wider: one block per query, a warp per C-column chunk (C = 256, 512 or
//   1,024, the smallest that keeps the chunks' lists within one warp) that
//   keeps its chunk's first min(k, C) survivors, then one warp merging
//   those lists.  Exact: a pk's best occurrence is its chunk's best, and it
//   is in the final top-k only if fewer than k distinct pks precede it, so
//   fewer than k of its chunk's survivors do.
// - pools whose lists would not fit (k above ~128 on the widest pools): one
//   512-thread block per query, the row in shared memory, two block-wide
//   bitonic sorts: by (orderable pk, compound), which groups each pk with
//   its occurrences in (key, column) order so the first of a group is its
//   best; then of the survivors' compounds.
// Dynamic shared memory above 48 KB is opted into once per device and
// kernel, not per launch.  Missing slots carry the metric's fill (+inf L2,
// -inf IP) and pk -1.
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "topk_common.cuh"

namespace {

using repro_torch::bitonic_sort;
using repro_torch::bitonic_sort_pairs;
using repro_torch::float_key;

constexpr int kThreads = 512;
constexpr int kMaxM = 8192;
constexpr int kPerThread = kMaxM / kThreads;
constexpr int kWarpMaxM = 256;        // one warp per query up to this width
constexpr int kListMax = 1024;        // the second level's pool: one warp's sort
constexpr int kMaxChunkWarps = 16;
constexpr int kWarpSmem = 48 * 1024;  // a one-warp block's shared memory (no opt-in)
constexpr int kMaxSmem = 232448;      // a block's largest opt-in on sm_90
constexpr unsigned int kAll = 0xffffffffu;
constexpr unsigned long long kDeadKey = 0xffffffffull;
constexpr int kMaxDevices = 64;

// The compound of one candidate at pool column c.
__device__ __forceinline__ unsigned long long compound(float sc, long long pk, int c, int ip) {
  const bool alive = pk >= 0 && isfinite(sc);
  const unsigned long long key = alive ? float_key(ip ? -sc : sc) : kDeadKey;
  return (key << 32) | (unsigned long long)c;
}

// Columns c0 + r * 32 + lane (r < R) of a row: staged in shared memory
// (below c1; sc_s / pk_s indexed by column), their compounds in v (~0 past
// c1).  All R loads issue before the first store, so their latencies
// overlap.
template <int R>
__device__ __forceinline__ void stage(const float* __restrict__ srow,
                                      const long long* __restrict__ prow, int c0, int c1, int ip,
                                      float* sc_s, long long* pk_s, unsigned long long (&v)[R],
                                      int lane) {
  float sc[R];
  long long pk[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = c0 + r * 32 + lane;
    sc[r] = c < c1 ? srow[c] : 0.f;
    pk[r] = c < c1 ? prow[c] : -1;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = c0 + r * 32 + lane;
    if (c < c1) {
      sc_s[c] = sc[r];
      pk_s[c] = pk[r];
      v[r] = compound(sc[r], pk[r], c, ip);
    } else {
      v[r] = ~0ull;
    }
  }
}

// Ascending bitonic sort of the warp's 32 * R compounds; v[r] of lane l is
// element l * R + r.
template <int R>
__device__ __forceinline__ void warp_bitonic_sort(unsigned long long (&v)[R], int lane) {
  constexpr int N = 32 * R;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= R) {  // partner: same register of lane ^ (stride / R)
        const int lstride = stride / R;
        const bool up = ((lane * R) & size) == 0;
        const bool keep_min = ((lane & lstride) == 0) == up;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned long long o = __shfl_xor_sync(kAll, v[r], lstride);
          v[r] = (keep_min == (o < v[r])) ? o : v[r];
        }
      } else {  // partner: register r ^ stride of this lane
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & stride) == 0) {
            const bool up = ((lane * R + r) & size) == 0;
            const unsigned long long a = v[r], b = v[r | stride];
            const bool swap = (a > b) == up;
            v[r] = swap ? b : a;
            v[r | stride] = swap ? a : b;
          }
        }
      }
    }
  }
}

__device__ __forceinline__ unsigned int pk_hash(long long pk, int log_h) {
  return (unsigned int)(((unsigned long long)pk * 0x9E3779B97F4A7C15ull) >> (64 - log_h));
}

// The sorted compounds v (lane l holds ranks l * R + r), walked in rank
// order through S [32 R], 32 per round: emit(rank, compound) for the first
// `limit` live candidates whose pk no earlier candidate has, stopping once
// `limit` are out.  tab: 2^log_h slots of accepted pks.  Returns the count
// emitted.
template <int R, class Emit>
__device__ __forceinline__ int first_survivors(const unsigned long long (&v)[R],
                                               const long long* pk_s, unsigned long long* S,
                                               long long* tab, int log_h, int lane, int limit,
                                               Emit emit) {
  const int H = 1 << log_h;
  for (int i = lane; i < H; i += 32) tab[i] = -1;  // empty: live pks are >= 0
#pragma unroll
  for (int r = 0; r < R; ++r) S[lane * R + r] = v[r];
  __syncwarp();
  int total = 0;
  for (int base = 0; base < 32 * R && total < limit; base += 32) {
    const unsigned long long w = S[base + lane];
    const bool live = (w >> 32) != kDeadKey;
    if (!__any_sync(kAll, live)) break;  // dead candidates sort last
    const long long pk = live ? pk_s[w & 0xffffffffull] : -1;
    const unsigned int same = __match_any_sync(kAll, pk);  // every lane takes part
    bool first = live && __ffs(same) - 1 == lane;
    unsigned int h = pk_hash(pk, log_h);
    if (first) {
      for (long long t; (t = tab[h]) != -1; h = (h + 1) & (H - 1)) {
        if (t == pk) {
          first = false;
          break;
        }
      }
    }
    const unsigned int out = __ballot_sync(kAll, first);  // every lookup is done
    if (first) {  // distinct pks: each claims the first free slot from h on
      while (atomicCAS(reinterpret_cast<unsigned long long*>(tab + h), ~0ull,
                       (unsigned long long)pk) != ~0ull) {
        h = (h + 1) & (H - 1);
      }
      const int rank = total + __popc(out & ((1u << lane) - 1));
      if (rank < limit) emit(rank, w);
    }
    total += __popc(out);
    __syncwarp();
  }
  return min(total, limit);
}

// Writes a merged row from the staged columns: out[rank] = the compound's
// score and pk, the slots from `total` on the fill and -1.
struct RowOut {
  const float* sc_s;
  const long long* pk_s;
  float* ov;
  long long* op;

  __device__ __forceinline__ void operator()(int rank, unsigned long long w) const {
    const int c = (int)(w & 0xffffffffull);
    ov[rank] = sc_s[c];
    op[rank] = pk_s[c];
  }

  __device__ __forceinline__ void fill(int total, int k, int ip, int lane) const {
    const float f = ip ? -INFINITY : INFINITY;
    for (int j = total + lane; j < k; j += 32) {
      ov[j] = f;
      op[j] = -1;
    }
  }
};

// Shared memory of one warp of the one-warp regime: staged pks, the
// rank-order buffer S and staged scores (the table, 8 * 2^log_h bytes,
// sits between S and the scores).
template <int R>
struct WarpSmem {
  static constexpr int kCols = 32 * R;
  static constexpr int kBytes = kCols * (int)(2 * sizeof(long long) + sizeof(float));
};

// M <= kWarpMaxM: one warp per query, blockDim / 32 queries per block.
template <int R>
__global__ void __launch_bounds__(256)
merge_topk_warp_kernel(const float* __restrict__ s, const long long* __restrict__ p,
                       long long nq, int m, int k, int ip, int log_h,
                       float* __restrict__ out_v, long long* __restrict__ out_p) {
  using W = WarpSmem<R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qi = (long long)blockIdx.x * warps + warp;
  if (qi >= nq) return;  // the whole warp: no block barrier here
  unsigned char* base = smem_raw + warp * (W::kBytes + 8 * (1 << log_h));
  long long* pk_s = reinterpret_cast<long long*>(base);
  unsigned long long* S = reinterpret_cast<unsigned long long*>(pk_s + W::kCols);
  long long* tab = reinterpret_cast<long long*>(S + W::kCols);
  float* sc_s = reinterpret_cast<float*>(tab + (1 << log_h));
  const float* __restrict__ srow = s + qi * m;
  const long long* __restrict__ prow = p + qi * m;
  unsigned long long v[R];
  stage<R>(srow, prow, 0, m, ip, sc_s, pk_s, v, lane);
  warp_bitonic_sort<R>(v, lane);
  const RowOut out{sc_s, pk_s, out_v + qi * k, out_p + qi * k};
  const int total = first_survivors<R>(v, pk_s, S, tab, log_h, lane, k, out);
  out.fill(total, k, ip, lane);
}

// M > kWarpMaxM: one block of W = ceil(M / C) warps per query, C = 32 R1.
// Warp w stages and merges columns [w C, (w + 1) C) into its list of
// min(k, C) compounds; warp 0 then merges the W lists (32 R2 >= W min(k, C)).
template <int R1, int R2>
__global__ void __launch_bounds__(R1 == 32 ? 256 : kMaxChunkWarps * 32)  // 1,024-column chunks: W <= 8
merge_topk_chunked_kernel(const float* __restrict__ s, const long long* __restrict__ p, int m,
                          int k, int ip, int log_h, float* __restrict__ out_v,
                          long long* __restrict__ out_p) {
  constexpr int C = 32 * R1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = warps * C;
  const int H = 1 << log_h;
  const int keep = min(k, C);
  long long* pk_s = reinterpret_cast<long long*>(smem_raw);                          // [cols]
  unsigned long long* S = reinterpret_cast<unsigned long long*>(pk_s + cols);        // [cols]
  long long* tabs = reinterpret_cast<long long*>(S + cols);                          // [W H]
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(tabs + warps * H);  // [kListMax]
  float* sc_s = reinterpret_cast<float*>(lists + kListMax);                          // [cols]
  const long long qi = blockIdx.x;
  const float* __restrict__ srow = s + qi * m;
  const long long* __restrict__ prow = p + qi * m;

  unsigned long long* mine = lists + warp * keep;
  for (int j = lane; j < keep; j += 32) mine[j] = ~0ull;
  {
    const int c0 = warp * C;
    unsigned long long v[R1];
    stage<R1>(srow, prow, c0, min(m, c0 + C), ip, sc_s, pk_s, v, lane);
    warp_bitonic_sort<R1>(v, lane);
    first_survivors<R1>(v, pk_s, S + c0, tabs + warp * H, log_h, lane, keep,
                        [&](int rank, unsigned long long w) { mine[rank] = w; });
  }
  __syncthreads();
  if (warp != 0) return;
  const int n = warps * keep;
  unsigned long long v[R2];
#pragma unroll
  for (int r = 0; r < R2; ++r) v[r] = r * 32 + lane < n ? lists[r * 32 + lane] : ~0ull;
  warp_bitonic_sort<R2>(v, lane);  // (its shuffles: every lane has read the lists)
  const RowOut out{sc_s, pk_s, out_v + qi * k, out_p + qi * k};
  const int total = first_survivors<R2>(v, pk_s, lists, tabs, log_h, lane, k, out);
  out.fill(total, k, ip, lane);
}

__global__ void __launch_bounds__(kThreads)
merge_topk_block_kernel(const float* __restrict__ s, const long long* __restrict__ p,
                        int m, int p2, int k, int ip, float* __restrict__ out_v,
                        long long* __restrict__ out_p) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* hk = smem;       // [p2] orderable pk
  unsigned long long* lk = smem + p2;  // [p2] compound
  const long long qi = blockIdx.x;
  const float* __restrict__ srow = s + qi * m;
  const long long* __restrict__ prow = p + qi * m;

  for (int c = threadIdx.x; c < p2; c += kThreads) {
    hk[c] = c < m ? (unsigned long long)prow[c] ^ 0x8000000000000000ull : ~0ull;
    lk[c] = c < m ? compound(srow[c], prow[c], c, ip) : ~0ull;
  }
  __syncthreads();
  bitonic_sort_pairs(hk, lk, p2);

  unsigned long long keep[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < p2) {
      const bool first = c == 0 || hk[c] != hk[c - 1];
      const bool alive = (lk[c] >> 32) != kDeadKey;
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

// The largest dynamic shared memory a launch of `kernel` takes, opted into
// once per device and kernel (above 48 KB it must be), not per launch.
template <class Kernel>
cudaError_t opt_in_once(Kernel kernel, int bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return e;
}

// log2 of the accepted-pk table: a power of two >= 2 (limit + 32) slots.
int table_log(int limit) {
  int log_h = 6;
  while ((1 << log_h) < 2 * (limit + 32)) ++log_h;
  return log_h;
}

template <int R>
cudaError_t launch_warp(const float* s, const long long* p, long long nq, int m, int k, int ip,
                        float* out_v, long long* out_p, cudaStream_t stream) {
  const int log_h = table_log(k < m ? k : m);
  const int per_warp = WarpSmem<R>::kBytes + 8 * (1 << log_h);
  int warps = kWarpSmem / per_warp;
  warps = warps < 1 ? 1 : warps > 8 ? 8 : warps;
  const long long blocks = (nq + warps - 1) / warps;
  merge_topk_warp_kernel<R><<<(unsigned int)blocks, 32 * warps, (size_t)warps * per_warp,
                              stream>>>(s, p, nq, m, k, ip, log_h, out_v, out_p);
  return cudaGetLastError();
}

template <int R1, int R2>
cudaError_t launch_chunked(const float* s, const long long* p, int nq, int m, int k, int ip,
                           int log_h, size_t smem, float* out_v, long long* out_p,
                           cudaStream_t stream) {
  static std::atomic<bool> opted[kMaxDevices];
  const cudaError_t e = opt_in_once(merge_topk_chunked_kernel<R1, R2>, kMaxSmem, opted);
  if (e != cudaSuccess) return e;
  const int warps = (m + 32 * R1 - 1) / (32 * R1);
  merge_topk_chunked_kernel<R1, R2><<<(unsigned int)nq, 32 * warps, smem, stream>>>(
      s, p, m, k, ip, log_h, out_v, out_p);
  return cudaGetLastError();
}

template <int R1>
cudaError_t launch_chunked_r2(int r2, const float* s, const long long* p, int nq, int m, int k,
                              int ip, int log_h, size_t smem, float* out_v, long long* out_p,
                              cudaStream_t stream) {
  if (r2 <= 4) return launch_chunked<R1, 4>(s, p, nq, m, k, ip, log_h, smem, out_v, out_p, stream);
  if (r2 <= 8) return launch_chunked<R1, 8>(s, p, nq, m, k, ip, log_h, smem, out_v, out_p, stream);
  if (r2 <= 16)
    return launch_chunked<R1, 16>(s, p, nq, m, k, ip, log_h, smem, out_v, out_p, stream);
  return launch_chunked<R1, 32>(s, p, nq, m, k, ip, log_h, smem, out_v, out_p, stream);
}

std::atomic<bool> g_block_opted[kMaxDevices];

}  // namespace

extern "C" int repro_merge_topk_max_m() { return kMaxM; }

// scores [nq, m] f32, pks [nq, m] i64 -> out [nq, k] f32 / i64.  Returns the
// CUDA error code of the launch (0 = success).
extern "C" int repro_merge_topk(const float* s, const long long* p, int nq, int m, int k, int ip,
                                float* out_v, long long* out_p, cudaStream_t stream) {
  if (m <= kWarpMaxM) {
    const int per_lane = (m + 31) / 32;
    if (per_lane <= 1) return (int)launch_warp<1>(s, p, nq, m, k, ip, out_v, out_p, stream);
    if (per_lane <= 2) return (int)launch_warp<2>(s, p, nq, m, k, ip, out_v, out_p, stream);
    if (per_lane <= 4) return (int)launch_warp<4>(s, p, nq, m, k, ip, out_v, out_p, stream);
    return (int)launch_warp<8>(s, p, nq, m, k, ip, out_v, out_p, stream);
  }
  // The smallest chunk whose lists fit one warp's sort and the block's
  // shared memory.
  for (int chunk = 256; chunk <= 1024; chunk *= 2) {
    const int warps = (m + chunk - 1) / chunk;
    const int keep = k < chunk ? k : chunk;
    if (warps > kMaxChunkWarps || warps * keep > kListMax) continue;
    const int log_h = table_log(k < warps * keep ? k : warps * keep);
    const size_t smem = (size_t)warps * chunk * 20 + (size_t)warps * 8 * (1 << log_h) +
                        (size_t)kListMax * 8;
    if (smem > (size_t)kMaxSmem) continue;
    const int r2 = (warps * keep + 31) / 32;
    if (chunk == 256)
      return (int)launch_chunked_r2<8>(r2, s, p, nq, m, k, ip, log_h, smem, out_v, out_p, stream);
    if (chunk == 512)
      return (int)launch_chunked_r2<16>(r2, s, p, nq, m, k, ip, log_h, smem, out_v, out_p, stream);
    return (int)launch_chunked_r2<32>(r2, s, p, nq, m, k, ip, log_h, smem, out_v, out_p, stream);
  }
  cudaError_t e = opt_in_once(merge_topk_block_kernel, (int)(2 * sizeof(unsigned long long) * kMaxM),
                              g_block_opted);
  if (e != cudaSuccess) return (int)e;
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  const size_t smem = 2 * sizeof(unsigned long long) * (size_t)p2;
  merge_topk_block_kernel<<<(unsigned int)nq, kThreads, smem, stream>>>(s, p, m, p2, k, ip, out_v,
                                                                        out_p);
  return (int)cudaGetLastError();
}
