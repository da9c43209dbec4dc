// PQ asymmetric-distance (ADC) scan with top-k, for sm_90a.
//
// Replaces src/repro/kernels/pq_adc.py:pq_adc_topk_pallas (body
// _adc_kernel).  The TPU has no fast per-lane gather, so it turned each
// table lookup into a one-hot [TN, KSUB] x [KSUB, NQ] product per
// subquantizer and carried a running top-k over a sequential grid.  Hopper
// gathers from shared memory, so here the lookup is a lookup.
//
// What bounds it: the nq*N*M table lookups.  Shared memory serves at most
// 32 four-byte entries per clock per SM, so at nq=100 over 131,072 rows x 48
// subquantizers (6.3e8 lookups) the least time is ~75 us on 132 SMs at
// 1.98 GHz, above the f32 adds (9.4 us at 67 TFLOP/s) and the bytes of the
// tables and codes (~7 MB, 2 us).  Random codes collide in the banks (a
// quarter-warp's eight 16-byte lookups fall on eight bank groups at random),
// so the lookups run below that rate: at nq=100 the call took 0.295 ms
// (score pass and select, device time, NVIDIA H100 80GB HBM3 at 700 W,
// chip_ab.py; 0.716 ms with one block per (query, row tile) reading each
// row's codes once per query, byte by byte), at nq=1 0.033 ms (0.054).
//
// Design.  Pass 1 (adc_scores_kernel): a block serves a group of G queries
// at once, G = 4 where four tables fit in a block's shared memory (196,608
// bytes at M = 48, KSUB = 256), else 2 or 1, so a lone table may still take
// the whole 232,448 bytes.  The G tables sit in shared memory interleaved as
// [M][KSUB][G]: one 16-byte load returns the G entries of one code.  Each
// row's codes are read from device memory once per group, with 16-byte loads
// where a row is a multiple of 16 bytes and the pointer allows it (4-byte or
// single-code loads otherwise).  The G sums are independent add chains, each
// over m = 0..M-1 in order with IEEE adds, exactly as the host loop
// `scores += lut[:, m, codes[:, m]]` does, so the scores are bit-exact
// against the plain version.  Invalid rows score +inf.  Work items are
// (group, 512-row tile) pairs in group-major order; the grid holds as many
// blocks as the SMs hold at once, each block takes a contiguous run of items
// and reloads the tables only where its group changes: at nq = 1 every SM
// scores rows (the old grid made 32 blocks), at nq = 100 a block loads at
// most two groups' tables for ~50 tiles of rows.  Pass 2 is the two-stage
// select of scan_common.cuh over the [nq, N] scratch, which reads each score
// once.  Codes are uint8 (KSUB <= 256, the device layout) or int32 (the saved
// layout) and must lie in [0, KSUB).
#include "scan_common.cuh"

namespace {

constexpr int kAdcThreads = 512;      // one row per thread per work item
constexpr int kMaxLutBytes = kMaxSmem;  // one table alone (G = 1)

// The G entries of one code, added to the G chains.
template <int G>
__device__ __forceinline__ void add_entries(float (&acc)[G], const float* e) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(e);
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
    acc[2] = __fadd_rn(acc[2], v.z);
    acc[3] = __fadd_rn(acc[3], v.w);
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(e);
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
  } else {
    acc[0] = __fadd_rn(acc[0], *e);
  }
}

// The tables of queries q0 .. q0 + G into lut_s as [mk][G], zero past nq.
// vec (mk % 4 == 0, a 16-byte aligned lut): a float4 of each table per
// thread, transposed in registers into G-wide stores.
template <int G>
__device__ __forceinline__ void load_group(float* lut_s, const float* __restrict__ lut, int nq,
                                           int q0, int mk, bool vec) {
  if (vec) {
    for (int e4 = threadIdx.x; e4 < mk / 4; e4 += kAdcThreads) {
      float v[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 t = q0 + g < nq
            ? __ldg(reinterpret_cast<const float4*>(lut + (long long)(q0 + g) * mk) + e4)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[g][0] = t.x;
        v[g][1] = t.y;
        v[g][2] = t.z;
        v[g][3] = t.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* dst = lut_s + (4 * e4 + c) * G;
        if constexpr (G == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
        } else if constexpr (G == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0][c], v[1][c]);
        } else {
          *dst = v[0][c];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < G * mk; i += kAdcThreads) {
      const int g = i / mk, e = i - g * mk;
      lut_s[e * G + g] = q0 + g < nq ? lut[(long long)(q0 + g) * mk + e] : 0.f;
    }
  }
}

// One row's M codes, read W bytes at a time (16, 4, or one code), each
// code's G entries added in m order.
template <int G, class CodeT, int W>
__device__ __forceinline__ void adc_row(const float* lut_s, const CodeT* __restrict__ cr, int m,
                                        int ksub, float (&acc)[G]) {
  constexpr int kPer = W / (int)sizeof(CodeT);  // codes per load
  for (int j0 = 0; j0 < m; j0 += kPer) {
    unsigned int w[W >= 4 ? W / 4 : 1];
    if constexpr (W == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(cr + j0));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (W == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(cr + j0));
    } else {
      w[0] = (unsigned int)__ldg(cr + j0);
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int code = sizeof(CodeT) == 1 ? (int)((w[t / 4] >> (8 * (t % 4))) & 0xffu) : (int)w[t];
      add_entries<G>(acc, lut_s + ((j0 + t) * ksub + code) * G);
    }
  }
}

template <int G, class CodeT, int W>
__global__ void __launch_bounds__(kAdcThreads)
adc_scores_kernel(const float* __restrict__ lut, int nq, int m, int ksub, int vec_lut,
                  const CodeT* __restrict__ codes, const unsigned char* __restrict__ valid,
                  long long n, long long tiles, long long items, float* __restrict__ scores) {
  extern __shared__ float4 lut_s4[];
  float* lut_s = reinterpret_cast<float*>(lut_s4);
  const int mk = m * ksub;
  const long long lo = items * blockIdx.x / gridDim.x;
  const long long hi = items * (blockIdx.x + 1) / gridDim.x;
  long long grp = -1;
  for (long long it = lo; it < hi; ++it) {
    if (it / tiles != grp) {  // the same for the whole block
      if (grp >= 0) __syncthreads();  // the last group's lookups are done
      grp = it / tiles;
      load_group<G>(lut_s, lut, nq, (int)grp * G, mk, vec_lut != 0);
      __syncthreads();
    }
    const long long r = (it - grp * tiles) * kAdcThreads + threadIdx.x;
    if (r >= n) continue;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    adc_row<G, CodeT, W>(lut_s, codes + r * m, m, ksub, acc);
    const bool dead = valid != nullptr && valid[r] == 0;
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (grp * G + g < nq) scores[(grp * G + g) * n + r] = dead ? INFINITY : acc[g];
  }
}

template <int G, class CodeT, int W>
int launch_scores(const float* lut, int nq, int m, int ksub, int vec_lut, const CodeT* codes,
                  const unsigned char* valid, long long n, float* scores, cudaStream_t stream) {
  const auto kernel = adc_scores_kernel<G, CodeT, W>;
  const int smem = G * m * ksub * (int)sizeof(float);
  int e = set_smem(kernel, smem);
  if (e != 0) return e;
  // Blocks the card holds at once at this shared-memory size, queried once
  // per (device, size), not per call.
  static int seen_dev = -1, seen_smem = -1, resident = 0;
  int dev = 0;
  if ((e = (int)cudaGetDevice(&dev)) != 0) return e;
  if (dev != seen_dev || smem != seen_smem) {
    int sms = 0, per_sm = 0;
    if ((e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != 0) return e;
    e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kAdcThreads, smem);
    if (e != 0) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    seen_dev = dev;
    seen_smem = smem;
  }
  const long long tiles = (n + kAdcThreads - 1) / kAdcThreads;
  const long long items = tiles * ((nq + G - 1) / G);
  const long long blocks = items < resident ? items : resident;
  kernel<<<(unsigned int)blocks, kAdcThreads, smem, stream>>>(lut, nq, m, ksub, vec_lut, codes,
                                                              valid, n, tiles, items, scores);
  return (int)cudaGetLastError();
}

template <int G, class CodeT>
int launch_width(int width, const float* lut, int nq, int m, int ksub, int vec_lut,
                 const CodeT* codes, const unsigned char* valid, long long n, float* scores,
                 cudaStream_t stream) {
  if (width == 16)
    return launch_scores<G, CodeT, 16>(lut, nq, m, ksub, vec_lut, codes, valid, n, scores, stream);
  if (width == 4)
    return launch_scores<G, CodeT, 4>(lut, nq, m, ksub, vec_lut, codes, valid, n, scores, stream);
  return launch_scores<G, CodeT, sizeof(CodeT)>(lut, nq, m, ksub, vec_lut, codes, valid, n, scores,
                                                stream);
}

template <class CodeT>
int launch_group(int group, int width, const float* lut, int nq, int m, int ksub, int vec_lut,
                 const CodeT* codes, const unsigned char* valid, long long n, float* scores,
                 cudaStream_t stream) {
  if (group == 4)
    return launch_width<4>(width, lut, nq, m, ksub, vec_lut, codes, valid, n, scores, stream);
  if (group == 2)
    return launch_width<2>(width, lut, nq, m, ksub, vec_lut, codes, valid, n, scores, stream);
  return launch_width<1>(width, lut, nq, m, ksub, vec_lut, codes, valid, n, scores, stream);
}

}  // namespace

extern "C" int repro_pq_adc_max_k() { return kMaxK; }
extern "C" int repro_pq_adc_max_lut_bytes() { return kMaxLutBytes; }
extern "C" int repro_pq_adc_chunk_rows() { return kChunkRows; }

// luts [nq, m, ksub] f32; group: queries per score block (1, 2 or 4, with
// group * m * ksub * 4 <= kMaxLutBytes); lalign / calign: the largest power
// of two (<= 16) dividing the luts / codes pointer; codes [n, m] uint8
// (code_bytes = 1) or int32 (code_bytes = 4); valid [n] uint8 or null; tab: a
// one-segment table (rows = n, column offset 0, chunks 0 .. total_chunks);
// scores: [nq, n] f32 scratch; cand: [nq, total_chunks * k] u64 scratch when
// multi_chunk; outputs [nq, k] ascending.  Returns the CUDA error code of the
// launches.
extern "C" int repro_pq_adc_topk(const float* lut, int nq, int m, int ksub, int group, int lalign,
                                 const void* codes, int code_bytes, int calign,
                                 const unsigned char* valid, long long n, const long long* tab,
                                 int k, float* scores, long long total_chunks, int multi_chunk,
                                 unsigned long long* cand, float* out_v, long long* out_i,
                                 cudaStream_t stream) {
  if ((group != 1 && group != 2 && group != 4) || 4ll * group * m * ksub > kMaxLutBytes)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int vec_lut = (m * ksub) % 4 == 0 && lalign >= 16;
    const int row_bytes = m * code_bytes;
    const int width = row_bytes % 16 == 0 && calign >= 16 ? 16
                      : row_bytes % 4 == 0 && calign >= 4 ? 4 : code_bytes;
    const int e = code_bytes == 1
        ? launch_group(group, width, lut, nq, m, ksub, vec_lut,
                       static_cast<const unsigned char*>(codes), valid, n, scores, stream)
        : launch_group(group, width, lut, nq, m, ksub, vec_lut, static_cast<const int*>(codes),
                       valid, n, scores, stream);
    if (e != 0) return e;
  }
  return select_topk(scores, n, tab, 1, nq, k, 0, total_chunks, multi_chunk, cand, out_v, out_i,
                     stream);
}
