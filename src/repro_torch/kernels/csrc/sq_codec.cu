// Scalar-quantization codec kernels, for sm_90a: the encoder and the scan
// over uint8 codes with the dequantization fused in.
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
