// Scalar-quantization codec kernels, for sm_90a: the encoder, the decoder
// and the scan over uint8 codes with the dequantization fused in.
//
// sq_encode replaces src/repro/kernels/sq_codec.py:sq_encode_pallas (body
// _encode_kernel): code = clip(round((x - vmin) / scale), 0, 255) per
// element, with scale = max(vmax - vmin, 1e-12) / 255 computed in the
// kernel from vmin / vmax with ops.sq_scale's expression and roundings
// (sq_scale_of), so a call is one launch.  The division is IEEE
// (__fdiv_rn, never a reciprocal multiply), x - vmin is __fsub_rn and the
// conversion rounds half to even, as np.round and jnp.round do, so codes
// are bit-exact against the host.  What bounds it: bytes, 4 in and 1 out per
// element (0.50 GB for a 131,072 x 768 segment: 0.150 ms at 3.35 TB/s; 1.01
// GB for a bucket index's 262,144 x 768 payload: 0.300 ms); the ~1e8 IEEE
// divisions of a segment take far less.  Where d % 4 == 0 (and d <= 4096,
// x 16-byte and the codes 4-byte aligned) a thread encodes 4 elements of
// one row per step from one streaming float4 load (__ldcs: x is read once)
// into one 4-byte store, so a warp loads 512 contiguous bytes and stores
// 128; scale and vmin sit in shared memory, the column advances by the
// grid stride's, mod d, with no division in the loop, and the grid is one
// wave of resident blocks.  Otherwise one
// element per thread and step, the column tracked the same way.  Indices
// are 64-bit: n * d passes 2^31 above ~2.8M rows at d = 768.
//
// sq_decode replaces src/repro/kernels/sq_codec.py:sq_decode_pallas (body
// _decode_kernel): out = code * scale[c] + vmin[c] in f32 per element.
// __fadd_rn(__fmul_rn(.)) keeps the two roundings of the host decode
// (numpy, sq_decode_plain) and of the scan's row loader below: an
// FMA-contracted code * scale + vmin, which nvcc's default --fmad=true would
// emit, differs in the last bit.  The scale is computed in the kernel from
// vmin / vmax with ops.sq_scale's expression and roundings (sq_scale_of), so
// a call is one launch.  What bounds it: bytes, 1 in and 4 out per element
// (0.25 GB for the 65,536 x 768 chunks an IVF-SQ index decodes its codes
// in: 0.075 ms at 3.35 TB/s).  Where d % 4 == 0 (and d <= 4096, codes
// 4-byte and out 16-byte aligned) a thread decodes 4 codes of one row per
// step from one 4-byte load, so a warp loads 128 contiguous bytes and
// stores 512 (one float4 per lane, streaming); scale and vmin sit in
// shared memory.  Otherwise one element per thread and step.  Indices are
// 64-bit: n * d passes 2^31 above ~2.8M rows at d = 768.
//
// sq_l2_topk replaces src/repro/kernels/sq_codec.py:sq_l2_topk_pallas (body
// _sq_scan_kernel): the l2_topk scan (scan_common.cuh) whose row loader
// reads uint8 codes and dequantizes them as __fadd_rn(__fmul_rn(code,
// scale), vmin) (the host decode's two roundings) before the 3xTF32 split.
// In the tensor-core path (nq > 8) each 16-byte cp.async brings 16 codes of
// a row into the shared ring, and the stage's vmin / vmax ride along in the
// same ring (scale computed once per stage and block); in the small-nq path
// each lane reads 4 codes per 4-byte load against scale / vmin staged in
// shared memory (or, for rows too wide for that, read from global memory).  What bounds it, at float32 accuracy: at nq=100
// over 131,072 x 768 codes, 3 x 2.0e10 TF32 FLOP (0.122 ms at 495 TFLOP/s)
// against the 0.10 GB read of the codes (0.030 ms): operations; at nq=1 the
// read of the codes.
#include "scan_common.cuh"

namespace {

__device__ __forceinline__ float sq_decode_one(unsigned int code, float scale, float vmin) {
  return __fadd_rn(__fmul_rn((float)code, scale), vmin);
}

// scale = max(vmax - vmin, 1e-12) / 255 in f32: the expression and the
// roundings of the wrapper's sq_scale (IEEE division, no contraction).
__device__ __forceinline__ float sq_scale_of(float vmax, float vmin) {
  return __fdiv_rn(fmaxf(__fsub_rn(vmax, vmin), 1e-12f), 255.f);
}

// rint, then clip to [0, 255]: one conversion that rounds half to even and
// saturates below 0 (cvt.rni.u32.f32; NaN -> 0, as fmaxf(NaN, 0) gives),
// and a min.
__device__ __forceinline__ unsigned int sq_encode_one(float x, float scale, float vmin) {
  return min(__float2uint_rn(__fdiv_rn(__fsub_rn(x, vmin), scale)), 255u);
}

// Widest row whose scale | vmin the vec4 encoder and decoder stage in shared
// memory (32 KB); wider rows take the scalar kernels.
constexpr int kStageD = 4096;
constexpr int kEncodeThreads = 256;
constexpr int kEncodeUnroll = 4;
// Blocks per SM of the 4-element path's grid: one wave of resident blocks
// (the kernel's registers leave room for 5 blocks of 256 threads, so a grid
// of 8 per SM ran in two waves).  Measured against 5 and 8 on an NVIDIA
// H100 80GB HBM3 at 700 W: 4 is fastest at 131,072 and 262,144 x 768
// (chip_smoke.py's sq_encode rows).
constexpr int kEncodeBlocksPerSm = 4;

// d % 4 == 0, x 16-byte and codes 4-byte aligned, d <= kStageD:
// element group t (one float4 of x, 4 codes, never straddling a row) per
// thread and step.  Each block computes the row's scale and stages it with
// vmin in shared memory once; the group's column advances by the grid
// stride's, mod d.  kEncodeUnroll loads are in flight per thread before
// the first store; stores stream (__stcs), as the loads do.
__global__ void __launch_bounds__(kEncodeThreads)
sq_encode_vec4_kernel(const float4* __restrict__ x, const float* __restrict__ vmin,
                      const float* __restrict__ vmax, unsigned int* __restrict__ out,
                      long long n_groups, int d) {
  extern __shared__ __align__(16) float par[];  // scale [d] | vmin [d]
  for (int c = threadIdx.x; c < d; c += kEncodeThreads) {
    const float mn = vmin[c];
    par[c] = sq_scale_of(vmax[c], mn);
    par[d + c] = mn;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kEncodeThreads;
  const int step_c = (int)((4 * stride) % d);
  long long t = (long long)blockIdx.x * kEncodeThreads + threadIdx.x;
  int c = (int)((4 * t) % d);
  for (; t < n_groups; t += kEncodeUnroll * stride) {
    float4 v[kEncodeUnroll];
    int cs[kEncodeUnroll];
#pragma unroll
    for (int u = 0; u < kEncodeUnroll; ++u) {
      const long long g = t + u * stride;
      v[u] = g < n_groups ? __ldcs(x + g) : make_float4(0.f, 0.f, 0.f, 0.f);
      cs[u] = c;
      c += step_c;
      if (c >= d) c -= d;
    }
#pragma unroll
    for (int u = 0; u < kEncodeUnroll; ++u) {
      const long long g = t + u * stride;
      if (g < n_groups) {
        const float4 sc = *reinterpret_cast<const float4*>(par + cs[u]);
        const float4 mn = *reinterpret_cast<const float4*>(par + d + cs[u]);
        __stcs(out + g, sq_encode_one(v[u].x, sc.x, mn.x) |
                            (sq_encode_one(v[u].y, sc.y, mn.y) << 8) |
                            (sq_encode_one(v[u].z, sc.z, mn.z) << 16) |
                            (sq_encode_one(v[u].w, sc.w, mn.w) << 24));
      }
    }
  }
}

// Any d and alignment: one element per thread and step, the column's scale
// computed from vmin / vmax in global memory; the column advances by the
// grid stride's, mod d, with no division in the loop.
__global__ void __launch_bounds__(kEncodeThreads)
sq_encode_kernel(const float* __restrict__ x, const float* __restrict__ vmin,
                 const float* __restrict__ vmax, unsigned char* __restrict__ out,
                 long long n_elem, int d) {
  const long long stride = (long long)gridDim.x * kEncodeThreads;
  const int step_c = (int)(stride % d);
  long long i = (long long)blockIdx.x * kEncodeThreads + threadIdx.x;
  int c = (int)(i % d);
  for (; i < n_elem; i += stride) {
    const float mn = __ldg(vmin + c);
    out[i] = (unsigned char)sq_encode_one(__ldcs(x + i), sq_scale_of(__ldg(vmax + c), mn), mn);
    c += step_c;
    if (c >= d) c -= d;
  }
}

constexpr int kDecodeThreads = 256;
constexpr int kDecodeUnroll = 4;

// d % 4 == 0, codes 4-byte and out 16-byte aligned, d <= kStageD:
// element group t (4 codes, one float4 of output, never straddling a row)
// per thread and step, so a warp loads 128 contiguous bytes of codes and
// stores 512 contiguous bytes.  Each block computes the row's scale and
// stages it with vmin in shared memory once.  The group's column advances
// by the grid stride's, mod d, with no division in the loop; stores
// stream (__stcs), since the caller reads the rows once.
__global__ void __launch_bounds__(kDecodeThreads)
sq_decode_vec4_kernel(const unsigned int* __restrict__ codes, const float* __restrict__ vmin,
                      const float* __restrict__ vmax, float4* __restrict__ out, long long n_groups,
                      int d) {
  extern __shared__ __align__(16) float par[];  // scale [d] | vmin [d]
  for (int c = threadIdx.x; c < d; c += kDecodeThreads) {
    const float mn = vmin[c];
    par[c] = sq_scale_of(vmax[c], mn);
    par[d + c] = mn;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kDecodeThreads;
  const int step_c = (int)((4 * stride) % d);
  long long t = (long long)blockIdx.x * kDecodeThreads + threadIdx.x;
  int c = (int)((4 * t) % d);
  for (; t < n_groups; t += kDecodeUnroll * stride) {
    unsigned int w[kDecodeUnroll];
    int cs[kDecodeUnroll];
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const long long g = t + u * stride;
      w[u] = g < n_groups ? __ldcs(codes + g) : 0u;
      cs[u] = c;
      c += step_c;
      if (c >= d) c -= d;
    }
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const long long g = t + u * stride;
      if (g < n_groups) {
        const float4 sc = *reinterpret_cast<const float4*>(par + cs[u]);
        const float4 mn = *reinterpret_cast<const float4*>(par + d + cs[u]);
        __stcs(out + g, make_float4(sq_decode_one(w[u] & 0xffu, sc.x, mn.x),
                                    sq_decode_one((w[u] >> 8) & 0xffu, sc.y, mn.y),
                                    sq_decode_one((w[u] >> 16) & 0xffu, sc.z, mn.z),
                                    sq_decode_one(w[u] >> 24, sc.w, mn.w)));
      }
    }
  }
}

// Any d and alignment: one element per thread and step, the column's
// scale computed from vmin / vmax in global memory.
__global__ void sq_decode_kernel(const unsigned char* __restrict__ codes,
                                 const float* __restrict__ vmin,
                                 const float* __restrict__ vmax, float* __restrict__ out,
                                 long long n_elem, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_elem; i += stride) {
    const int c = (int)(i % d);
    const float mn = __ldg(vmin + c);
    out[i] = sq_decode_one(codes[i], sq_scale_of(__ldg(vmax + c), mn), mn);
  }
}

struct SQRows {
  const float* vmin;
  const float* vmax;
  static constexpr bool kCodes = true;
  static constexpr int kXBytes = BN * kLdB;
  static constexpr int kParFloats = 2 * BK;  // a ring stage's scale (vmax until finished) | vmin
  static constexpr int kSmallQ = 8;  // measured: chip_smoke.py's path_crossover

  int tile_vec(int d, int xalign) const { return d % 16 == 0 && xalign >= 16; }
  int small_vec(int d, int xalign) const { return d % 4 == 0 && xalign >= 4; }

  // scale = max(vmax - vmin, 1e-12) / 255 in f32: the expression and the
  // roundings of the wrapper's sq_scale (computed here, it costs the call no
  // launch).
  __device__ __forceinline__ float scale_of(float vmax_k, float vmin_k) const {
    return sq_scale_of(vmax_k, vmin_k);
  }

  // par = scale[dpad] | vmin[dpad], zero past d (so padded columns decode to
  // 0): the small-nq path's whole row.
  __device__ __forceinline__ void load_params(float* par, int d, int dpad, int tid) const {
    for (int k = tid; k < dpad; k += kThreads) {
      par[k] = k < d ? scale_of(vmax[k], vmin[k]) : 0.f;
      par[dpad + k] = k < d ? vmin[k] : 0.f;
    }
  }

  // The tensor-core path's BK columns per ring stage: vmax | vmin copied
  // with the stage (16 bytes per copy where vec), zero past d; vmax turns
  // into scale in place once landed.  Padded columns decode to 0 * scale +
  // 0 = 0.
  __device__ __forceinline__ void load_stage_params(float* ps, int k0, int d, bool vec,
                                                    int tid) const {
    if (vec) {
      if (tid < 2 * BK / 4) {
        const float* src = tid < BK / 4 ? vmax : vmin;
        const int c = (tid % (BK / 4)) * 4;
        const bool ok = k0 + c < d;
        cp_async16(ps + (tid / (BK / 4)) * BK + c, ok ? src + k0 + c : src, ok);
      }
    } else {
      for (int i = tid; i < 2 * BK; i += kThreads) {
        const float* src = i < BK ? vmax : vmin;
        const int c = i % BK;
        ps[i] = k0 + c < d ? src[k0 + c] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void finish_stage_params(float* ps, int tid) const {
    if (tid < BK) ps[tid] = scale_of(ps[tid], ps[BK + tid]);
  }

  __device__ __forceinline__ void load_tile(unsigned char* tile, const void* base, long long r0,
                                            long long n, int k0, int d, bool vec, int tid) const {
    const unsigned char* codes = reinterpret_cast<const unsigned char*>(base);
    if (vec) {  // 16 codes per 16-byte copy, two per row
      for (int i = tid; i < BN * 2; i += kThreads) {
        const int row = i >> 1, c = (i & 1) * 16;
        const long long r = r0 + row;
        const bool ok = r < n && k0 + c < d;
        cp_async16(tile + row * kLdB + c, ok ? codes + r * d + k0 + c : codes, ok);
      }
    } else {
      for (int i = tid; i < BN * BK; i += kThreads) {
        const int row = i / BK, c = i % BK;
        const long long r = r0 + row;
        tile[row * kLdB + c] = (r < n && k0 + c < d) ? codes[r * d + k0 + c] : 0;
      }
    }
  }

  __device__ __forceinline__ float at(const unsigned char* tile, int row, int c,
                                      const float* ps) const {
    return sq_decode_one(tile[row * kLdB + c], ps[c], ps[BK + c]);
  }

  // Column k's (scale, vmin): from par where staged, else from global memory.
  template <bool kStaged>
  __device__ __forceinline__ void param(const float* par, int dpad, int k, float& sc,
                                        float& mn) const {
    if constexpr (kStaged) {
      sc = par[k];
      mn = par[dpad + k];
    } else {
      mn = __ldg(vmin + k);
      sc = scale_of(__ldg(vmax + k), mn);
    }
  }

  template <int NQ, bool kStaged>
  __device__ __forceinline__ void dot_row(const void* base, long long r, int d, bool vec, int lane,
                                          const float* const (&qrow)[NQ], const float* par,
                                          int dpad, float (&acc)[NQ], float& xn) const {
    const unsigned char* __restrict__ x = reinterpret_cast<const unsigned char*>(base) + r * d;
    if (vec) {  // 4 codes per 4-byte load
      const unsigned int* __restrict__ x4 = reinterpret_cast<const unsigned int*>(x);
#pragma unroll 2
      for (int c = lane; c < d / 4; c += 32) {
        const unsigned int w = __ldg(x4 + c);
        float4 sc, mn;
        if constexpr (kStaged) {
          sc = *reinterpret_cast<const float4*>(par + 4 * c);
          mn = *reinterpret_cast<const float4*>(par + dpad + 4 * c);
        } else {
          param<false>(par, dpad, 4 * c, sc.x, mn.x);
          param<false>(par, dpad, 4 * c + 1, sc.y, mn.y);
          param<false>(par, dpad, 4 * c + 2, sc.z, mn.z);
          param<false>(par, dpad, 4 * c + 3, sc.w, mn.w);
        }
        const float v0 = sq_decode_one(w & 0xffu, sc.x, mn.x);
        const float v1 = sq_decode_one((w >> 8) & 0xffu, sc.y, mn.y);
        const float v2 = sq_decode_one((w >> 16) & 0xffu, sc.z, mn.z);
        const float v3 = sq_decode_one(w >> 24, sc.w, mn.w);
        xn = fmaf(v0, v0, fmaf(v1, v1, fmaf(v2, v2, fmaf(v3, v3, xn))));
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float4 qq = *reinterpret_cast<const float4*>(qrow[j] + 4 * c);
          acc[j] = fmaf(v0, qq.x, fmaf(v1, qq.y, fmaf(v2, qq.z, fmaf(v3, qq.w, acc[j]))));
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        float sc, mn;
        param<kStaged>(par, dpad, c, sc, mn);
        const float v = sq_decode_one(x[c], sc, mn);
        xn = fmaf(v, v, xn);
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[j] = fmaf(v, qrow[j][c], acc[j]);
      }
    }
  }
};

}  // namespace

static int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return sms;
}

// x [n, d] f32, vmin / vmax [d] f32 -> codes [n, d] uint8, one launch (the
// scale is computed in the kernel).  Returns the CUDA error code of the
// launch.
extern "C" int repro_sq_encode(const float* x, const float* vmin, const float* vmax,
                               unsigned char* out, long long n, int d, cudaStream_t stream) {
  const long long n_elem = n * (long long)d;
  if (n_elem <= 0) return 0;
  const bool vec = d % 4 == 0 && d <= kStageD && (unsigned long long)x % 16 == 0 &&
                   (unsigned long long)out % 4 == 0;
  const long long work = vec ? n_elem / 4 : n_elem;
  long long blocks = (work + kEncodeThreads - 1) / kEncodeThreads;
  const long long max_blocks = (long long)sm_count() * (vec ? kEncodeBlocksPerSm : 8);
  if (blocks > max_blocks) blocks = max_blocks;
  if (vec) {
    sq_encode_vec4_kernel<<<(unsigned int)blocks, kEncodeThreads, 2 * sizeof(float) * d, stream>>>(
        reinterpret_cast<const float4*>(x), vmin, vmax, reinterpret_cast<unsigned int*>(out), work,
        d);
  } else {
    sq_encode_kernel<<<(unsigned int)blocks, kEncodeThreads, 0, stream>>>(x, vmin, vmax, out,
                                                                         n_elem, d);
  }
  return (int)cudaGetLastError();
}

// codes [n, d] uint8, vmin / vmax [d] f32 -> out [n, d] f32, one launch
// (the scale is computed in the kernel).  Returns the CUDA error code of
// the launch.
extern "C" int repro_sq_decode(const unsigned char* codes, const float* vmin, const float* vmax,
                               float* out, long long n, int d, cudaStream_t stream) {
  const long long n_elem = n * (long long)d;
  if (n_elem <= 0) return 0;
  const int sms = sm_count();
  const bool vec = d % 4 == 0 && d <= kStageD && (unsigned long long)codes % 4 == 0 &&
                   (unsigned long long)out % 16 == 0;
  const long long work = vec ? n_elem / 4 : n_elem;
  long long blocks = (work + kDecodeThreads - 1) / kDecodeThreads;
  if (blocks > (long long)sms * 8) blocks = (long long)sms * 8;
  if (vec) {
    sq_decode_vec4_kernel<<<(unsigned int)blocks, kDecodeThreads, 2 * sizeof(float) * d, stream>>>(
        reinterpret_cast<const unsigned int*>(codes), vmin, vmax, reinterpret_cast<float4*>(out),
        work, d);
  } else {
    sq_decode_kernel<<<(unsigned int)blocks, kDecodeThreads, 0, stream>>>(codes, vmin, vmax, out,
                                                                         n_elem, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_sq_l2_topk_max_k() { return kMaxK; }
extern "C" int repro_sq_l2_topk_tile_rows() { return BN; }
extern "C" int repro_sq_l2_topk_chunk_rows() { return kChunkRows; }
extern "C" int repro_sq_l2_topk_small_q() { return SQRows::kSmallQ; }
extern "C" int repro_sq_l2_topk_small_q_max() { return kSmallQMax; }

// queries [nq, d] f32; tab: the packed segment table (base pointers are
// uint8 codes [n_s, d]); vmin / vmax [d] f32, shared by every segment of
// the call, palign the largest power of two (<= 16) dividing both; other
// arguments as repro_l2_topk.  Returns the CUDA error code of the launches
// (0 = success).
extern "C" int repro_sq_l2_topk(const float* q, int nq, int d, const long long* tab, int S,
                                long long total_tiles, long long n_rows, int qalign, int xalign,
                                int palign, int small_q, const float* vmin, const float* vmax,
                                float* scores,
                                long long ld, int k, int ip, long long total_chunks,
                                int multi_chunk, unsigned long long* cand, float* out_v,
                                long long* out_i, cudaStream_t stream) {
  return launch_scan(q, nq, d, tab, S, total_tiles, n_rows, qalign, xalign, palign, small_q,
                     scores, ld, k, ip, total_chunks, multi_chunk, cand, out_v, out_i, stream,
                     SQRows{vmin, vmax});
}
