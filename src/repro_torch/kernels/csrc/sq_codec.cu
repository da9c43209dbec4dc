// Scalar-quantization codec kernels, for sm_90a: the encoder, the decoder
// and the scan over uint8 codes with the dequantization fused in.
//
// sq_encode replaces src/repro/kernels/sq_codec.py:sq_encode_pallas (body
// _encode_kernel): code = clip(round((x - vmin) / scale), 0, 255) per
// element, with scale = max(vmax - vmin, 1e-12) / 255 passed in by the
// wrapper (one definition, ops.sq_scale).  The division is IEEE
// (__fdiv_rn, never a reciprocal multiply) and rintf rounds half to even,
// as np.round and jnp.round do, so codes are bit-exact against the host.
// What bounds it: bytes, 4 in and 1 out per element (0.50 GB for a
// 131,072 x 768 segment: 0.15 ms at 3.35 TB/s).  A grid-stride loop with
// one element per thread and step.
//
// sq_decode replaces src/repro/kernels/sq_codec.py:sq_decode_pallas (body
// _decode_kernel): out = code * scale[c] + vmin[c] in f32 per element, with
// the scale of ops.sq_scale.  __fadd_rn(__fmul_rn(.)) keeps the two
// roundings of the host decode (numpy, sq_decode_plain) and of the scan's
// row loader below: an FMA-contracted code * scale + vmin, which nvcc's
// default --fmad=true would emit, differs in the last bit.  What bounds it:
// bytes, 1 in and 4 out per element (0.50 GB for a 131,072 x 768 segment:
// 0.15 ms at 3.35 TB/s).  Where d % 16 == 0 and every pointer is 16-byte
// aligned, each thread decodes 16 codes of one row from one 16-byte load
// (scale and vmin as float4, four float4 stores); otherwise one element per
// thread and step.  Indices are 64-bit: n * d passes 2^31 above ~2.8M rows
// at d = 768.
//
// sq_l2_topk replaces src/repro/kernels/sq_codec.py:sq_l2_topk_pallas (body
// _sq_scan_kernel): the l2_topk scan (scan_common.cuh) whose row loader
// reads a uint8 code and dequantizes it in registers as
// code * scale + vmin (two roundings, as the host decode), before the f32
// product.  What bounds it: the f32 product 2*nq*N*D (at nq=100 over
// 131,072 x 768 codes, 2.0e10 FLOP: 0.30 ms at 67 TFLOP/s) against the
// 0.10 GB read of the codes (0.03 ms) -- compute-bound at nq=100, byte-bound
// at nq=1, where the codes are 4x fewer bytes than f32 rows.
#include "scan_common.cuh"

namespace {

__global__ void sq_encode_kernel(const float* __restrict__ x, const float* __restrict__ vmin,
                                 const float* __restrict__ scale,
                                 unsigned char* __restrict__ out, long long n_elem, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_elem; i += stride) {
    const int c = (int)(i % d);
    const float v = rintf(__fdiv_rn(__fsub_rn(x[i], vmin[c]), scale[c]));
    out[i] = (unsigned char)fminf(fmaxf(v, 0.f), 255.f);
  }
}

__device__ __forceinline__ float sq_decode_one(unsigned int code, float scale, float vmin) {
  return __fadd_rn(__fmul_rn((float)code, scale), vmin);
}

// d % 16 == 0, all pointers 16-byte aligned: one 16-code chunk of one row
// per thread and step (chunks never straddle a row).
__global__ void sq_decode_vec16_kernel(const uint4* __restrict__ codes,
                                       const float4* __restrict__ vmin,
                                       const float4* __restrict__ scale,
                                       float4* __restrict__ out, long long n_chunks,
                                       int chunks_per_row) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n_chunks; t += stride) {
    const int c4 = (int)(t % chunks_per_row) * 4;  // float4 index of the chunk's first column
    const uint4 raw = codes[t];
    const unsigned int words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float4 s = scale[c4 + w];
      const float4 m = vmin[c4 + w];
      const unsigned int b = words[w];
      out[t * 4 + w] = make_float4(sq_decode_one(b & 0xffu, s.x, m.x),
                                   sq_decode_one((b >> 8) & 0xffu, s.y, m.y),
                                   sq_decode_one((b >> 16) & 0xffu, s.z, m.z),
                                   sq_decode_one(b >> 24, s.w, m.w));
    }
  }
}

__global__ void sq_decode_kernel(const unsigned char* __restrict__ codes,
                                 const float* __restrict__ vmin,
                                 const float* __restrict__ scale, float* __restrict__ out,
                                 long long n_elem, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n_elem; i += stride) {
    const int c = (int)(i % d);
    out[i] = sq_decode_one(codes[i], scale[c], vmin[c]);
  }
}

struct SQRows {
  const float* vmin;
  const float* scale;
  __device__ __forceinline__ float load(const void* base, long long r, int c, int d) const {
    const float code = (float)reinterpret_cast<const unsigned char*>(base)[r * d + c];
    return __fadd_rn(__fmul_rn(code, scale[c]), vmin[c]);
  }
};

}  // namespace

// x [n, d] f32, vmin / scale [d] f32 -> codes [n, d] uint8.  Returns the
// CUDA error code of the launch.
extern "C" int repro_sq_encode(const float* x, const float* vmin, const float* scale,
                               unsigned char* out, long long n, int d, cudaStream_t stream) {
  const long long n_elem = n * (long long)d;
  if (n_elem <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_elem + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  sq_encode_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(x, vmin, scale, out, n_elem, d);
  return (int)cudaGetLastError();
}

// codes [n, d] uint8, vmin / scale [d] f32 -> out [n, d] f32.  Returns the
// CUDA error code of the launch.
extern "C" int repro_sq_decode(const unsigned char* codes, const float* vmin, const float* scale,
                               float* out, long long n, int d, cudaStream_t stream) {
  const long long n_elem = n * (long long)d;
  if (n_elem <= 0) return 0;
  const int threads = 256;
  const unsigned long long addr_bits = (unsigned long long)codes | (unsigned long long)vmin |
                                       (unsigned long long)scale | (unsigned long long)out;
  const bool vec = d % 16 == 0 && addr_bits % 16 == 0;
  const long long work = vec ? n_elem / 16 : n_elem;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (vec) {
    sq_decode_vec16_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
        reinterpret_cast<const uint4*>(codes), reinterpret_cast<const float4*>(vmin),
        reinterpret_cast<const float4*>(scale), reinterpret_cast<float4*>(out), work, d / 16);
  } else {
    sq_decode_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(codes, vmin, scale, out,
                                                                   n_elem, d);
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_sq_l2_topk_max_k() { return kMaxK; }
extern "C" int repro_sq_l2_topk_tile_rows() { return BN; }

// queries [nq, d] f32; tab: the packed segment table (base pointers are
// uint8 codes [n_s, d]); vmin / scale [d] f32, shared by every segment of
// the call; scores: [nq, ld] f32 scratch; outputs [nq, S * k].  Returns the
// CUDA error code of the launches (0 = success).
extern "C" int repro_sq_l2_topk(const float* q, int nq, int d, const long long* tab, int S,
                                long long total_tiles, const float* vmin, const float* scale,
                                float* scores, long long ld, int k, int ip, float* out_v,
                                long long* out_i, cudaStream_t stream) {
  return launch_scan(q, nq, d, tab, S, total_tiles, scores, ld, k, ip, out_v, out_i, stream,
                     SQRows{vmin, scale});
}
