// The segmented distance scan shared by l2_topk.cu (f32 rows) and
// sq_codec.cu (uint8 SQ codes, dequantized on load), and the two-stage
// per-segment top-k select that l2_topk.cu, sq_codec.cu and pq_adc.cu all
// run over a [nq, N] score scratch.  kmeans_assign.cu runs the same two
// score passes with the rows as the base and the centroids as the queries,
// through another epilogue (Epi: ScoreEpi here writes the score scratch)
// and one segment passed by value (Segs: TableSegs here reads the packed
// device table).  Included by exactly one translation unit per shared
// library, so everything here has internal linkage.
//
// Score pass, nq > Rows::kSmallQ (wgmma_scores_kernel): one block per (base tile
// of BN = 128 rows, query tile of BQ = 16 * NT <= 128 queries) over every
// segment of the call at once (segments are addressed through a small
// device table, never copied together), so at nq <= 128 the base is read
// from device memory once.  Base and query k-slices of BK = 32 floats pass
// through a kStages = 4 ring in shared memory, filled by 16-byte cp.async
// (zero-filled past the edges) while the tensor cores work on the slice
// before.  The product q.x runs on the tensor cores in 3xTF32: each float v
// is split into hi = tf32_rna(v) and lo = tf32_rna(v - hi) (integer
// rounding, bit-equal to cvt.rna.tf32 on finite values), and
// wgmma.m64nNk8.tf32 accumulates lo_x.hi_q + hi_x.lo_q + hi_x.hi_q in f32,
// which keeps float32 accuracy (plain TF32 misses SCORE_TOL by 30x).  Each
// 8-deep step of the product goes into a fresh fragment that is then added
// to the running f32 total: the tensor cores round their sums toward zero,
// so a partial carried across many steps drifts one way -- with 64-deep
// partials a query against its own row missed SCORE_TOL (2.3e-3 against
// 2.0e-3 allowed).  wgmma, not
// mma.sync: the two warpgroups each own 64 base rows whose splits are the A
// operand in registers (each base element split once), and the query tile
// is split once per stage into hi and lo tiles in 128-byte-swizzled shared
// memory that wgmma reads as B.  A first mma.sync version of this design
// ran slower on the card: every warp re-split the query fragments it
// read, four times over.  |x|^2 and |q|^2 are summed with f32 FMAs on
// CUDA cores from the same shared tiles (16-deep partials), once per block,
// while the other warpgroup's products run.  The epilogue writes
// (|q|^2 - 2 q.x) + |x|^2 (L2) or -q.x (IP) in the host's operation order,
// invalid rows at +inf.
//
// Score pass, nq <= Rows::kSmallQ (small_scores_kernel): bound by the bytes
// of the base.  No tensor cores: the queries sit in shared memory, one warp
// per row streams the row with 16-byte loads (f32) or 4-byte loads of 4
// codes (SQ) over every SM, and f32 FMAs accumulate per lane before a
// shuffle tree.  Each row's shared-memory reads grow with nq, so past a few
// queries the tensor-core path, which stages the base through shared memory
// once per 128 rows, is the faster one.  chip_smoke.py times both paths at
// nq = 4 and 8 (the caller may pick the threshold, up to 8, to time them):
// on an H100 the f32 scan's small path won at 4 and lost at 8, so f32 rows
// switch above 4; the SQ scan's small path, which reads a quarter of the
// bytes, won at both, so SQ rows switch above 8, the largest built.  Rows too wide for the queries (and SQ's scale /
// vmin) to fit in shared memory read them from global memory instead, so
// neither path limits d.
//
// Select, stage A (select_chunk_kernel): one block per (chunk of
// kChunkRows rows of one segment, query).  It reads the chunk's scores from
// device memory once into shared memory as order-preserving keys, finds the
// k_eff-th smallest key by an MSB radix select over shared memory (11-bit
// digits below the bits all keys share), gathers every key below it plus the
// lowest-indexed keys equal to it, and sorts the k_eff survivors by (key,
// row).  A segment of one chunk is written out directly; otherwise the
// chunk's sorted list goes to a candidate buffer.  Stage B
// (select_merge_kernel): one block per (segment of more than one chunk,
// query) selects the same way over the segment's chunk lists, whose list
// order is row order among equal keys, so ties break by row across chunk
// edges.  Rows past the segment's live count carry (+inf L2 / -inf IP,
// -1), and |score| >= 1e38 maps to index -1, as in
// src/repro/kernels/ops.py:topk_scan.  k is limited to kMaxK.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "topk_common.cuh"
#include "wgmma_tf32.cuh"

namespace {

using repro_torch::bitonic_sort;
using repro_torch::float_key;

constexpr int kThreads = 256;   // score kernels: 8 warps
constexpr int BN = 128;         // base rows per score tile
constexpr int BK = 32;          // k per ring stage
constexpr int kStages = 4;      // ring depth
constexpr int kLdF = BK + 4;    // shared row stride of a float tile (conflict-free fragments)
constexpr int kLdB = BK + 16;   // shared row stride of a code tile, bytes
constexpr int kSmallQMax = 8;   // largest NQ the byte-bound path is built for
constexpr int kSelThreads = 512;
constexpr int kChunkRows = 16384;  // select chunk: 64 KB of keys in shared memory
constexpr int kMaxK = 1024;
constexpr int kMaxSmem = 232448;  // a block's shared-memory limit on sm_90

// Packed int64 segment table, column-major over S segments:
// rows[S] | base ptr[S] | valid ptr[S] (0 = all valid) | score column offset[S]
// | first score tile[S + 1] | first select chunk[S + 1].
struct SegTable {
  const long long* rows;
  const long long* base;
  const long long* valid;
  const long long* col_off;
  const long long* tile_start;
  const long long* chunk_start;
};

__device__ __forceinline__ SegTable seg_table(const long long* tab, int S) {
  SegTable t;
  t.rows = tab;
  t.base = tab + S;
  t.valid = tab + 2 * S;
  t.col_off = tab + 3 * S;
  t.tile_start = tab + 4 * S;
  t.chunk_start = tab + 5 * S + 1;
  return t;
}

// Largest s < S with start[s] <= v: the segment owning a tile, chunk or
// column (an empty segment shares its successor's tile and column start and
// is never chosen for those).
__device__ __forceinline__ int owner_segment(const long long* start, int S, long long v) {
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= v) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The rows one score tile (or one small-path row) belongs to: the segment's
// base and valid mask (null = all valid), its row count, the first local
// row r of the tile (or the row), and the score column of local row r.
struct SegRows {
  const void* base;
  const unsigned char* valid;
  long long n;
  long long r;
  long long col;
};

// Every segment of the packed device table (the scans).
struct TableSegs {
  const long long* tab;
  int S;

  __device__ __forceinline__ SegRows tile(long long t) const {
    const SegTable tb = seg_table(tab, S);
    const int s = owner_segment(tb.tile_start, S, t);
    const long long r0 = (t - tb.tile_start[s]) * BN;
    return {reinterpret_cast<const void*>(tb.base[s]),
            reinterpret_cast<const unsigned char*>(tb.valid[s]), tb.rows[s], r0,
            tb.col_off[s] + r0};
  }
  // Row `col` of the class, by its score column.
  __device__ __forceinline__ SegRows row(long long col) const {
    const SegTable tb = seg_table(tab, S);
    const int s = owner_segment(tb.col_off, S, col);
    return {reinterpret_cast<const void*>(tb.base[s]),
            reinterpret_cast<const unsigned char*>(tb.valid[s]), tb.rows[s], col - tb.col_off[s],
            col};
  }
};

// One segment of n rows, every row valid, passed by value (no table copy).
struct OneSeg {
  const void* base;
  long long n;

  __device__ __forceinline__ SegRows tile(long long t) const { return {base, nullptr, n, t * BN, t * BN}; }
  __device__ __forceinline__ SegRows row(long long r) const { return {base, nullptr, n, r, r}; }
};

// Inverse of float_key.
__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ------------------------------------------------------------ PTX helpers

// Round to TF32 (10-bit mantissa), to nearest with ties away from zero, as
// cvt.rna.tf32.f32 does for finite values, in two integer operations, which
// issue at a higher rate than the conversion instruction.
__device__ __forceinline__ unsigned int tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, unsigned int& hi, unsigned int& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));  // exact difference
}

// 16-byte asynchronous copy; zero-fills the destination when !pred (src is
// then not read but must be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* src, bool pred) {
  const unsigned int dst = (unsigned int)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}


// ----------------------------------------------- score pass, wgmma

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins the accumulator registers in program order around the asynchronous
// wgmma (no read or write of them moves across this point).
template <int N>
__device__ __forceinline__ void fence_operands(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Makes this thread's shared-memory stores visible to wgmma's operand reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)),
// 1024-byte aligned: 8-row groups 1024 bytes apart.
__device__ __forceinline__ unsigned long long sw128_desc(const void* tile) {
  const unsigned long long addr = (unsigned long long)__cvta_generic_to_shared(tile);
  return ((addr & 0x3ffffull) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

// Float offset of element (row, col < 32) in a swizzled 128-byte-row tile.
__device__ __forceinline__ int sw128_at(int row, int col) {
  return row * 32 + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

// Query k-slice [rows, BK] into a swizzled tile, zero past n and d.
__device__ __forceinline__ void load_q_sw128(float* tile, int rows, const float* q, long long n,
                                             int k0, int d, bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < rows * (BK / 4); i += kThreads) {
      const int row = i >> 3, c = (i & 7) * 4;
      const bool ok = row < n && k0 + c < d;
      cp_async16(tile + sw128_at(row, c), ok ? q + (long long)row * d + k0 + c : q, ok);
    }
  } else {
    for (int i = tid; i < rows * BK; i += kThreads) {
      const int row = i / BK, c = i % BK;
      tile[sw128_at(row, c)] = (row < n && k0 + c < d) ? q[(long long)row * d + k0 + c] : 0.f;
    }
  }
}

// Rows (the row loader) provides, for a tile of BN base rows:
//   kCodes            the tile holds uint8 codes (kXBytes bytes), decoded
//                     through per-column (scale, vmin) kept in shared memory,
//                     BK columns per ring stage (kParFloats floats)
//   kXBytes           bytes of one stage's base tile (a multiple of 1024)
//   load_stage_params(ps, k0, d, vec, tid)   (kCodes only) issue the copies of
//                     the stage's raw vmax | vmin, zero past d
//   finish_stage_params(ps, tid)   (kCodes only) vmax -> scale in place,
//                     once the stage's copies have landed
//   load_tile(tile, base, r0, n, k0, d, vec, tid)   issue one stage's copies
//   at(tile, row, c, ps)              base element (row, k0 + c) as f32
//   tile_vec(d, xalign)               whether load_tile may copy 16 bytes
//   kSmallQ           the nq at or below which the small-nq path runs by default
// and, for the small-nq path (below), load_params, dot_row and small_vec.

// f32 rows (l2_topk.cu, kmeans_assign.cu).
struct F32Rows {
  static constexpr bool kCodes = false;
  static constexpr int kXBytes = BN * kLdF * 4;  // 18 KB
  static constexpr int kParFloats = 0;
  static constexpr int kSmallQ = 4;  // l2_topk, measured: chip_smoke.py's path_crossover

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

// Epi (the epilogue) provides
//   kWalk        false: a block serves one query tile (blockIdx.y); true: one
//                block walks every query tile in order (grid.y = 1)
//   State        per-thread state carried across the walked tiles
//   x_norms()    whether the pass needs |x|^2
//   tile<BQ>(st, acc, xn_s, qn_s, frag_row, t4, seg, q0, nq)   one tile's
//                fragments (tensor-core path)
//   finish(st, frag_row, t4, seg)   after the last tile
//   row<NQ>(acc, xn, qn_s, nq, lane, seg)   one row's sums, in every lane
//                (small-nq path)
// The scans' epilogue writes (|q|^2 - 2 q.x) + |x|^2 (L2) or -q.x (IP) in
// the host's operation order, invalid rows at +inf, into the score scratch.
struct ScoreEpi {
  float* scores;
  long long ld;
  int ip;
  static constexpr bool kWalk = false;
  struct State {};

  __device__ __forceinline__ bool x_norms() const { return !ip; }

  template <int BQ>
  __device__ __forceinline__ void tile(State&, const float (&acc)[BQ / 2], const float* xn_s,
                                       const float* qn_s, int frag_row, int t4, const SegRows& sg,
                                       int q0, int nq) const {
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rl = frag_row + (i >> 1) * 8;
        const int ql = 8 * j + 2 * t4 + (i & 1);
        if (sg.r + rl >= sg.n || q0 + ql >= nq) continue;
        const float qx = acc[4 * j + i];
        float sc = ip ? -qx : __fadd_rn(__fsub_rn(qn_s[ql], __fmul_rn(2.f, qx)), xn_s[rl]);
        if (sg.valid != nullptr && sg.valid[sg.r + rl] == 0) sc = INFINITY;
        scores[(long long)(q0 + ql) * ld + sg.col + rl] = sc;
      }
  }

  __device__ __forceinline__ void finish(State&, int, int, const SegRows&) const {}

  template <int NQ>
  __device__ __forceinline__ void row(const float (&acc)[NQ], float xn, const float* qn_s, int nq,
                                      int lane, const SegRows& sg) const {
    const bool dead = sg.valid != nullptr && sg.valid[sg.r] == 0;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (j != lane || j >= nq) continue;
      float sc = ip ? -acc[j] : __fadd_rn(__fsub_rn(qn_s[j], __fmul_rn(2.f, acc[j])), xn);
      scores[(long long)j * ld + sg.col] = dead ? INFINITY : sc;
    }
  }
};

// Tensor-core score pass through wgmma: the block's two warpgroups each own
// 64 base rows, whose TF32 splits go in registers as the A operand; the
// query tile (BQ = 16 * NT rows) is split once per stage in shared memory
// into a hi and a lo tile that wgmma reads as B.  With Epi::kWalk the block
// runs the whole pass once per query tile, in order, over the same rows (a
// ring that ran on across tile edges instead cost the scans 7% on an NVIDIA
// H100 80GB HBM3 at 700 W, chip_ab.py).
template <int NT, class Rows, class Segs, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_scores_kernel(const float* __restrict__ q, int nq, int d, Segs segs, int vec_q, int vec_x,
                    int vec_p, Rows rows_of, Epi epi) {
  constexpr int BQ = 16 * NT;
  constexpr int kQTile = BQ * BK * 4;                  // one swizzled tile, 1024-byte multiple
  constexpr int kSlot = 2 * kQTile + Rows::kXBytes;    // q hi | q lo | base tile
  extern __shared__ unsigned char smem_raw[];
  const unsigned int raw_addr = (unsigned int)__cvta_generic_to_shared(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023u) & ~1023u) - raw_addr);
  float* par = reinterpret_cast<float*>(smem + kStages * kSlot);  // kStages x kParFloats
  __shared__ float norm_part[2][BN + BQ];
  __shared__ float xn_s[BN];
  __shared__ float qn_s[BQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int frag_row = warp * 16 + g;  // warpgroup warp / 4 owns rows 64 (warp / 4) ..
  const SegRows sg = segs.tile(blockIdx.x);
  const long long n_s = sg.n;
  const long long r0 = sg.r;
  const void* base = sg.base;
  const int KT = (d + BK - 1) / BK;
  typename Epi::State es{};

  for (int q0 = blockIdx.y * BQ; q0 < nq; q0 += gridDim.y * BQ) {
    const float* qb = q + (long long)q0 * d;
    auto qhi = [&](int slot) { return reinterpret_cast<float*>(smem + slot * kSlot); };
    auto qlo = [&](int slot) { return reinterpret_cast<float*>(smem + slot * kSlot + kQTile); };
    auto xtile = [&](int slot) { return smem + slot * kSlot + 2 * kQTile; };
    auto pslot = [&](int slot) { return par + slot * Rows::kParFloats; };
    auto load_stage = [&](int slot, int k0) {
      rows_of.load_tile(xtile(slot), base, r0, n_s, k0, d, vec_x != 0, tid);
      load_q_sw128(qhi(slot), BQ, qb, nq - q0, k0, d, vec_q != 0, tid);
      if constexpr (Rows::kCodes) rows_of.load_stage_params(pslot(slot), k0, d, vec_p != 0, tid);
    };
    // Thread (nrow, half) owns 16 columns of one row of each stage: it sums
    // their squares for the norms, and splits the query row's in place.  (SQ:
    // the first warp also turns the stage's vmax into scale.)
    const int nrow = tid >> 1, half = tid & 1;
    float xnorm = 0.f, qnorm = 0.f;
    auto split_q = [&](int slot) {
      if constexpr (Rows::kCodes) rows_of.finish_stage_params(pslot(slot), tid);
      if (nrow >= BQ) return;
      float* hi = qhi(slot);
      float* lo = qlo(slot);
      float p = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int at = sw128_at(nrow, half * 16 + c4 * 4);
        float4 v = *reinterpret_cast<float4*>(hi + at);
        float4 h, l;
        unsigned int uh, ul;
        split_tf32(v.x, uh, ul); h.x = __uint_as_float(uh); l.x = __uint_as_float(ul);
        split_tf32(v.y, uh, ul); h.y = __uint_as_float(uh); l.y = __uint_as_float(ul);
        split_tf32(v.z, uh, ul); h.z = __uint_as_float(uh); l.z = __uint_as_float(ul);
        split_tf32(v.w, uh, ul); h.w = __uint_as_float(uh); l.w = __uint_as_float(ul);
        p = fmaf(v.x, v.x, p); p = fmaf(v.y, v.y, p); p = fmaf(v.z, v.z, p); p = fmaf(v.w, v.w, p);
        *reinterpret_cast<float4*>(hi + at) = h;
        *reinterpret_cast<float4*>(lo + at) = l;
      }
      qnorm += p;
      fence_async_smem();
    };

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < KT) load_stage(st, st * BK);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
    split_q(0);

    float acc[BQ / 2], part[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) acc[i] = part[i] = 0.f;

    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 3>();
      __syncthreads();  // stage kt + 1 landed, stage kt split, stage kt - 1's slot free
      if (kt + kStages - 1 < KT) load_stage((kt + kStages - 1) % kStages, (kt + kStages - 1) * BK);
      cp_async_commit();
      const int slot = kt % kStages;
      const unsigned char* xt = xtile(slot);
      const float* ps = pslot(slot);
      unsigned int ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        const int c = ks * 8 + t4;
        split_tf32(rows_of.at(xt, frag_row, c, ps), ahi[ks][0], alo[ks][0]);
        split_tf32(rows_of.at(xt, frag_row + 8, c, ps), ahi[ks][1], alo[ks][1]);
        split_tf32(rows_of.at(xt, frag_row, c + 4, ps), ahi[ks][2], alo[ks][2]);
        split_tf32(rows_of.at(xt, frag_row + 8, c + 4, ps), ahi[ks][3], alo[ks][3]);
      }
      const unsigned long long dh = sw128_desc(qhi(slot)), dl = sw128_desc(qlo(slot));
      // CUDA-core work first: the next stage's query split and this stage's
      // row norms (the tensor cores run the other warpgroup meanwhile).
      if (kt + 1 < KT) split_q((kt + 1) % kStages);
      if (epi.x_norms()) {
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float v = rows_of.at(xt, nrow, half * 16 + j, ps);
          p = fmaf(v, v, p);
        }
        xnorm += p;
      }
      // Each 8-deep step goes into a fresh fragment (small terms first) that
      // is then added to the running total; the other warpgroup's products
      // keep the tensor cores busy meanwhile.  32 bytes of K per step: +2 in
      // the descriptors.
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        fence_operands<BQ / 2>(part);
        wgmma_fence();
        wgmma_tf32<BQ>(part, alo[ks], dh + 2 * ks, 0);
        wgmma_tf32<BQ>(part, ahi[ks], dl + 2 * ks, 1);
        wgmma_tf32<BQ>(part, ahi[ks], dh + 2 * ks, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands<BQ / 2>(part);
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) acc[i] += part[i];
      }
    }
    cp_async_wait<0>();

    norm_part[half][nrow] = xnorm;
    if (nrow < BQ) norm_part[half][BN + nrow] = qnorm;
    __syncthreads();
    if (tid < BN) xn_s[tid] = norm_part[0][tid] + norm_part[1][tid];
    if (tid < BQ) qn_s[tid] = norm_part[0][BN + tid] + norm_part[1][BN + tid];
    __syncthreads();
    // Every thread is past its last read of the ring and of norm_part here, so
    // a walked next tile may refill them; its first barrier comes before any
    // write to xn_s / qn_s.
    epi.template tile<BQ>(es, acc, xn_s, qn_s, frag_row, t4, sg, q0, nq);
    if constexpr (!Epi::kWalk) break;
  }
  epi.finish(es, frag_row, t4, sg);
}

// ------------------------------------------------ score pass, small nq
//
// Rows also provides
//   load_params(par, d, dpad, tid)   (kCodes only) scale | vmin, zero past d
//   dot_row<NQ, kStaged>(base, r, d, vec, lane, qrow, par, dpad, acc, xn)
// which adds this lane's share of q_j . x_r (query j's row at qrow[j]) into
// acc[j] and of |x_r|^2 into xn -- with kStaged the queries and SQ's par
// are in shared memory, otherwise both come from global memory (SQ then
// computes scale from vmin / vmax per element); and small_vec(d, xalign):
// whether dot_row may use its wide loads.

template <int NQ, bool kStaged, class Rows, class Segs, class Epi>
__global__ void __launch_bounds__(kThreads)
small_scores_kernel(const float* __restrict__ q, int nq, int d, Segs segs, long long n_rows,
                    int vec_q, int vec_x, Rows rows_of, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qn_s[NQ];
  const int dpad = (d + BK - 1) / BK * BK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* q_s = reinterpret_cast<float*>(smem);  // [NQ, dpad], zero past nq and d
  const float* par = nullptr;
  const float* qrow[NQ];
  if constexpr (kStaged) {
    if (vec_q) {  // d % 4 == 0 and q 16-byte aligned: a float4 per load
      float4* q4 = reinterpret_cast<float4*>(q_s);
      for (int i = tid; i < NQ * dpad / 4; i += kThreads) {
        const int j = 4 * i / dpad, c = 4 * i % dpad;
        q4[i] = (j < nq && c < d) ? __ldg(reinterpret_cast<const float4*>(q + (long long)j * d + c))
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = tid; i < NQ * dpad; i += kThreads) {
        const int j = i / dpad, c = i % dpad;
        q_s[i] = (j < nq && c < d) ? q[(long long)j * d + c] : 0.f;
      }
    }
    if constexpr (Rows::kCodes) {
      rows_of.load_params(q_s + NQ * dpad, d, dpad, tid);
      par = q_s + NQ * dpad;
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) qrow[j] = q_s + j * dpad;
    __syncthreads();
  } else {  // rows past nq repeat row 0 (their sums are never written)
#pragma unroll
    for (int j = 0; j < NQ; ++j) qrow[j] = q + (long long)(j < nq ? j : 0) * d;
  }
  for (int j = warp; j < NQ; j += kThreads / 32) {  // |q_j|^2, one warp per query
    const float* qw = kStaged ? q_s + j * dpad : q + (long long)(j < nq ? j : 0) * d;
    float p = 0.f;
    for (int c = lane; c < d; c += 32) p = fmaf(qw[c], qw[c], p);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (lane == 0) qn_s[j] = p;
  }
  __syncthreads();

  const long long nwarps = (long long)gridDim.x * (kThreads / 32);
  for (long long r = (long long)blockIdx.x * (kThreads / 32) + warp; r < n_rows; r += nwarps) {
    const SegRows sg = segs.row(r);
    float acc[NQ], xn = 0.f;
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[j] = 0.f;
    rows_of.template dot_row<NQ, kStaged>(sg.base, sg.r, d, vec_x != 0, lane, qrow, par, dpad,
                                          acc, xn);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      xn += __shfl_xor_sync(0xffffffffu, xn, o);
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    }
    epi.template row<NQ>(acc, xn, qn_s, nq, lane, sg);
  }
}

// ------------------------------------------------------------- select

constexpr int kDigitBits = 11;  // radix digit: 2,048 bins, 4 per thread
constexpr int kBins = 1 << kDigitBits;

struct __align__(16) SelectSmem {
  unsigned int hist[kBins];
  int warp_total[kSelThreads / 32];
  unsigned int warp_min[kSelThreads / 32];
  unsigned int warp_max[kSelThreads / 32];
  unsigned int prefix;
  int need;
  int count_eq;
  int count;
  unsigned long long sel[kMaxK];
};

// Inclusive block-wide sum of v over thread order, and the block's total;
// warp_total is scratch.
__device__ __forceinline__ int block_scan(int v, int* warp_total, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  total = 0;
  for (int w = 0; w < kSelThreads / 32; ++w) {
    const int c = warp_total[w];
    v += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  return v;
}

// Ascending sort of a[0 .. n), n <= 128, by one warp: a bitonic network
// over 128 slots (4 per lane, padded with the largest word), exchanging
// across lanes by shuffles.
__device__ __forceinline__ void warp_sort128(unsigned long long* a, int n) {
  const int lane = threadIdx.x & 31;
  unsigned long long v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = 4 * lane + e < n ? a[4 * lane + e] : ~0ull;
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * lane + e;
          const unsigned long long p = __shfl_xor_sync(0xffffffffu, v[e], stride >> 2);
          const bool keep_min = ((idx & stride) == 0) == ((idx & size) == 0);
          v[e] = keep_min ? (v[e] < p ? v[e] : p) : (v[e] < p ? p : v[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e & stride) continue;
          const int e2 = e | stride;
          const bool up = ((4 * lane + e) & size) == 0;
          if ((v[e] > v[e2]) == up) {
            const unsigned long long t = v[e];
            v[e] = v[e2];
            v[e2] = t;
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (4 * lane + e < n) a[4 * lane + e] = v[e];
}

// The k_eff (>= 1) smallest of n items by (key, item order) into sm.sel,
// sorted ascending by word = (key << 32 | row).  Items: key(i) -> uint32,
// word(i) -> uint64; among equal keys item order must be row order.  Every
// thread of the block calls it.
//
// The bits that the smallest and the largest key share are the threshold's
// too, so the radix select starts below them: clustered scores (L2
// distances of one binade) share their top ten or so bits, which leaves two
// passes of 11-bit digits.  Histogram counts are combined per thread while
// a thread's matching keys fall in one bin, so a crowded bin costs one
// atomic per thread, not one per key.
template <class Items>
__device__ void block_select(const Items& it, long long n, int k_eff, SelectSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned int lo = 0xffffffffu, hi = 0u;
  for (long long i = tid; i < n; i += kSelThreads) {
    const unsigned int key = it.key(i);
    lo = min(lo, key);
    hi = max(hi, key);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    sm.warp_min[warp] = lo;
    sm.warp_max[warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < kSelThreads / 32; ++w) {
    lo = min(lo, sm.warp_min[w]);
    hi = max(hi, sm.warp_max[w]);
  }
  unsigned int prefix = lo, mask = 0xffffffffu;
  int need = k_eff, count_eq = (int)n;  // all keys equal: T = lo
  int left = lo == hi ? 0 : 32 - __clz(lo ^ hi);  // bits still to decide
  if (left > 0) {
    mask = ~(0xffffffffu >> (32 - left));
    prefix = lo & mask;
  }
  while (left > 0) {
    const int bits = left < kDigitBits ? left : kDigitBits;
    const int shift = left - bits;
    const unsigned int digit = (1u << bits) - 1u;
    for (int b = tid; b < kBins; b += kSelThreads) sm.hist[b] = 0u;
    __syncthreads();
    unsigned int cur = 0u, run = 0u;
    for (long long i = tid; i < n; i += kSelThreads) {
      const unsigned int key = it.key(i);
      if ((key & mask) != prefix) continue;
      const unsigned int b = (key >> shift) & digit;
      if (b != cur && run) {
        atomicAdd(&sm.hist[cur], run);
        run = 0u;
      }
      cur = b;
      ++run;
    }
    if (run) atomicAdd(&sm.hist[cur], run);
    __syncthreads();
    // Thread t holds bins 4t .. 4t + 3; the bin where the running count
    // reaches `need` holds the threshold.
    const uint4 h = reinterpret_cast<const uint4*>(sm.hist)[tid];
    const int sum = (int)(h.x + h.y + h.z + h.w);
    int total;
    const int incl = block_scan(sum, sm.warp_total, total);
    const int excl = incl - sum;
    if (excl < need && need <= incl) {
      const int hb[4] = {(int)h.x, (int)h.y, (int)h.z, (int)h.w};
      int below = excl, j = 0;
      for (; j < 3; ++j) {
        if (below + hb[j] >= need) break;
        below += hb[j];
      }
      sm.prefix = prefix | ((unsigned int)(4 * tid + j) << shift);
      sm.need = need - below;
      sm.count_eq = hb[j];
    }
    __syncthreads();
    prefix = sm.prefix;
    need = sm.need;
    count_eq = sm.count_eq;
    mask |= digit << shift;
    left = shift;
  }
  // prefix is the threshold key T: take every key < T and the first `need`
  // keys == T in item order (exactly k_eff items).
  if (tid == 0) sm.count = 0;
  __syncthreads();
  const bool all_eq = count_eq == need;
  for (long long i = tid; i < n; i += kSelThreads) {
    const unsigned int key = it.key(i);
    if (key < prefix || (all_eq && key == prefix)) sm.sel[atomicAdd(&sm.count, 1)] = it.word(i);
  }
  if (!all_eq) {  // more keys tie at T than are needed: take them in order
    int seen = 0;
    for (long long i0 = 0; i0 < n && seen < need; i0 += kSelThreads) {
      const long long i = i0 + tid;
      const int eq = i < n && it.key(i) == prefix;
      int total;
      const int incl = block_scan(eq, sm.warp_total, total);
      if (eq && seen + incl - 1 < need) sm.sel[atomicAdd(&sm.count, 1)] = it.word(i);
      seen += total;
    }
  }
  __syncthreads();
  if (k_eff <= 128) {  // the common k: one warp sorts in registers, no block barriers
    if (warp == 0) warp_sort128(sm.sel, k_eff);
    __syncthreads();
    return;
  }
  int p2 = 1;
  while (p2 < k_eff) p2 <<= 1;
  for (int i = k_eff + tid; i < p2; i += kSelThreads) sm.sel[i] = ~0ull;
  __syncthreads();
  bitonic_sort(sm.sel, p2);
}

struct ChunkItems {  // a chunk's keys in shared memory, rows r0..
  const unsigned int* keys;
  long long r0;
  __device__ __forceinline__ unsigned int key(long long i) const { return keys[i]; }
  __device__ __forceinline__ unsigned long long word(long long i) const {
    return ((unsigned long long)keys[i] << 32) | (unsigned long long)(r0 + i);
  }
};

struct ListItems {  // a segment's sorted chunk lists, chunk after chunk
  const unsigned long long* list;
  __device__ __forceinline__ unsigned int key(long long i) const {
    return (unsigned int)(list[i] >> 32);
  }
  __device__ __forceinline__ unsigned long long word(long long i) const { return list[i]; }
};

// Segment s's output block for query qi from the sorted words in sm.sel.
__device__ __forceinline__ void write_topk(const SelectSmem& sm, int k_eff, int k, int ip,
                                           float* __restrict__ ov, long long* __restrict__ oi) {
  for (int j = threadIdx.x; j < k_eff; j += kSelThreads) {
    const unsigned long long w = sm.sel[j];
    const float v = key_float((unsigned int)(w >> 32));
    oi[j] = fabsf(v) >= 1e38f ? -1 : (long long)(w & 0xffffffffull);
    ov[j] = ip ? -v : v;
  }
  const float fill = ip ? -INFINITY : INFINITY;
  for (int j = k_eff + threadIdx.x; j < k; j += kSelThreads) {
    ov[j] = fill;
    oi[j] = -1;
  }
}

__global__ void __launch_bounds__(kSelThreads)
select_chunk_kernel(const float* __restrict__ scores, long long ld,
                    const long long* __restrict__ tab, int S, int k, int ip,
                    unsigned long long* __restrict__ cand, long long cand_ld,
                    float* __restrict__ out_v, long long* __restrict__ out_i) {
  extern __shared__ unsigned int keys[];  // kChunkRows
  __shared__ SelectSmem sm;
  const SegTable tb = seg_table(tab, S);
  const long long chunk = blockIdx.x, qi = blockIdx.y;
  const int s = owner_segment(tb.chunk_start, S, chunk);
  const long long n_chunks = tb.chunk_start[s + 1] - tb.chunk_start[s];
  const long long r0 = (chunk - tb.chunk_start[s]) * kChunkRows;
  const long long left = tb.rows[s] - r0;
  const int n = (int)(left < kChunkRows ? (left > 0 ? left : 0) : kChunkRows);
  const float* __restrict__ row = scores + qi * ld + tb.col_off[s] + r0;
  for (int i = threadIdx.x; i < n; i += kSelThreads) keys[i] = float_key(row[i]);
  __syncthreads();
  const int k_eff = n < k ? n : k;
  if (k_eff > 0) block_select(ChunkItems{keys, r0}, n, k_eff, sm);
  if (n_chunks == 1) {
    write_topk(sm, k_eff, k, ip, out_v + (qi * S + s) * k, out_i + (qi * S + s) * k);
  } else {
    unsigned long long* dst = cand + qi * cand_ld + chunk * k;
    for (int j = threadIdx.x; j < k; j += kSelThreads) dst[j] = j < k_eff ? sm.sel[j] : ~0ull;
  }
}

__global__ void __launch_bounds__(kSelThreads)
select_merge_kernel(const unsigned long long* __restrict__ cand, long long cand_ld,
                    const long long* __restrict__ tab, int S, int k, int ip,
                    float* __restrict__ out_v, long long* __restrict__ out_i) {
  __shared__ SelectSmem sm;
  const SegTable tb = seg_table(tab, S);
  const int s = blockIdx.x;
  const long long qi = blockIdx.y;
  const long long n_chunks = tb.chunk_start[s + 1] - tb.chunk_start[s];
  if (n_chunks <= 1) return;
  const long long n_s = tb.rows[s];
  const int k_eff = n_s < (long long)k ? (int)n_s : k;
  block_select(ListItems{cand + qi * cand_ld + tb.chunk_start[s] * k}, n_chunks * k, k_eff, sm);
  write_topk(sm, k_eff, k, ip, out_v + (qi * S + s) * k, out_i + (qi * S + s) * k);
}

// Dynamic shared memory past 48 KB (static included) needs the opt-in.
// A refusal is returned and cleared, so no later launch reads it as its own.
template <class K>
int set_smem(K kernel, int bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// The per-segment select over a filled score scratch: stage A over every
// chunk, then (multi_chunk: some segment has more than one chunk) stage B.
// cand: [nq, total_chunks * k] words (unused when !multi_chunk).  Returns
// the CUDA error code of the launches (0 = success).
inline int select_topk(const float* scores, long long ld, const long long* tab, int S, int nq,
                       int k, int ip, long long total_chunks, int multi_chunk,
                       unsigned long long* cand, float* out_v, long long* out_i,
                       cudaStream_t stream) {
  const long long cand_ld = total_chunks * k;
  const int keys_bytes = kChunkRows * 4;
  cudaError_t e = (cudaError_t)set_smem(select_chunk_kernel, keys_bytes);
  if (e != cudaSuccess) return (int)e;
  select_chunk_kernel<<<dim3((unsigned int)total_chunks, (unsigned int)nq), kSelThreads,
                        keys_bytes, stream>>>(scores, ld, tab, S, k, ip, cand, cand_ld, out_v,
                                              out_i);
  e = cudaGetLastError();
  if (e != cudaSuccess || !multi_chunk) return (int)e;
  select_merge_kernel<<<dim3((unsigned int)S, (unsigned int)nq), kSelThreads, 0, stream>>>(
      cand, cand_ld, tab, S, k, ip, out_v, out_i);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- launch

// grid.y: one block per query tile, or (Epi::kWalk) one block walking them all.
template <int NT, class Rows, class Segs, class Epi>
int launch_wgmma(const float* q, int nq, int d, Segs segs, long long total_tiles, int vec_q,
                 int vec_x, int vec_p, cudaStream_t stream, Rows rows_of, Epi epi) {
  constexpr int BQ = 16 * NT;
  constexpr int smem = 1024 + kStages * (2 * BQ * BK * 4 + Rows::kXBytes + 4 * Rows::kParFloats);
  const int e = set_smem(wgmma_scores_kernel<NT, Rows, Segs, Epi>, smem);
  if (e != 0) return e;
  dim3 grid((unsigned int)total_tiles, Epi::kWalk ? 1u : (unsigned int)((nq + BQ - 1) / BQ));
  wgmma_scores_kernel<NT, Rows, Segs, Epi><<<grid, kThreads, smem, stream>>>(
      q, nq, d, segs, vec_q, vec_x, vec_p, rows_of, epi);
  return (int)cudaGetLastError();
}

// A warp per row, grid-stride over at most max_blocks blocks of 8 warps.
template <int NQ, bool kStaged, class Rows, class Segs, class Epi>
int launch_small_as(const float* q, int nq, int d, Segs segs, long long n_rows, int vec_q,
                    int vec_x, int smem, long long max_blocks, cudaStream_t stream, Rows rows_of,
                    Epi epi) {
  const int e = set_smem(small_scores_kernel<NQ, kStaged, Rows, Segs, Epi>, smem);
  if (e != 0) return e;
  long long blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > max_blocks) blocks = max_blocks;
  small_scores_kernel<NQ, kStaged, Rows, Segs, Epi>
      <<<(unsigned int)blocks, kThreads, smem, stream>>>(q, nq, d, segs, n_rows, vec_q, vec_x,
                                                         rows_of, epi);
  return (int)cudaGetLastError();
}

// The queries (and SQ's scale / vmin) go to shared memory where they fit
// beside the kernel's static arrays, else each row reads them from global
// memory (16-byte query loads then need an aligned q).  The scans launch at
// most 132 x 8 blocks (8 of 8 warps per SM).
template <int NQ, class Rows, class Segs, class Epi>
int launch_small(const float* q, int nq, int d, Segs segs, long long n_rows, int qalign,
                 int xalign, cudaStream_t stream, Rows rows_of, Epi epi,
                 long long max_blocks = 132 * 8) {
  const int dpad = (d + BK - 1) / BK * BK;
  const long long staged = 4ll * NQ * dpad + (Rows::kCodes ? 8ll * dpad : 0);
  const int vx = rows_of.small_vec(d, xalign);
  const int vq = d % 4 == 0 && qalign >= 16;
  if (staged + 1024 <= kMaxSmem)
    return launch_small_as<NQ, true>(q, nq, d, segs, n_rows, vq, vx, (int)staged, max_blocks,
                                     stream, rows_of, epi);
  return launch_small_as<NQ, false>(q, nq, d, segs, n_rows, vq, vx && vq, 0, max_blocks, stream,
                                    rows_of, epi);
}

// Score pass over every row of the table, then the select.  qalign /
// xalign / palign: the largest power of two (<= 16) dividing the query
// pointer / every base pointer / SQ's vmin and vmax pointers (16 for f32
// rows).  small_q (0 .. 8): nq at or below which the byte-bound path runs.
// Returns the CUDA error code of the launches (0 = success).
template <class Rows>
int launch_scan(const float* q, int nq, int d, const long long* tab, int S,
                long long total_tiles, long long n_rows, int qalign, int xalign, int palign,
                int small_q, float* scores, long long ld, int k, int ip, long long total_chunks,
                int multi_chunk, unsigned long long* cand, float* out_v, long long* out_i,
                cudaStream_t stream, Rows rows_of) {
  if (n_rows > 0) {
    const TableSegs segs{tab, S};
    const ScoreEpi epi{scores, ld, ip};
    int e;
    if (nq <= small_q) {
      if (nq == 1) e = launch_small<1>(q, nq, d, segs, n_rows, qalign, xalign, stream, rows_of, epi);
      else if (nq == 2) e = launch_small<2>(q, nq, d, segs, n_rows, qalign, xalign, stream, rows_of, epi);
      else if (nq <= 4) e = launch_small<4>(q, nq, d, segs, n_rows, qalign, xalign, stream, rows_of, epi);
      else e = launch_small<8>(q, nq, d, segs, n_rows, qalign, xalign, stream, rows_of, epi);
    } else {
      const int vq = d % 4 == 0 && qalign >= 16;
      const int vx = rows_of.tile_vec(d, xalign);
      const int vp = d % 4 == 0 && palign >= 16;
      const int nt = nq >= 128 ? 8 : (nq + 15) / 16;
      switch (nt) {
        case 1: e = launch_wgmma<1>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
        case 2: e = launch_wgmma<2>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
        case 3: e = launch_wgmma<3>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
        case 4: e = launch_wgmma<4>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
        case 5: e = launch_wgmma<5>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
        case 6: e = launch_wgmma<6>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
        case 7: e = launch_wgmma<7>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
        default: e = launch_wgmma<8>(q, nq, d, segs, total_tiles, vq, vx, vp, stream, rows_of, epi); break;
      }
    }
    if (e != 0) return e;
  }
  return select_topk(scores, ld, tab, S, nq, k, ip, total_chunks, multi_chunk, cand, out_v, out_i,
                     stream);
}

}  // namespace
