// Helpers shared by the top-k kernels: an order-preserving float key and
// in-shared-memory bitonic sorts.  Every function here is called by all
// threads of a block (the sorts synchronise).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Order-preserving float -> uint32 map (IEEE trick: flip every bit of a
// negative value, only the sign bit of a non-negative one).  -0.0 is first
// canonicalised to +0.0 so the two compare equal, as they do on the host.
__device__ __forceinline__ unsigned int float_key(float f) {
  const unsigned int u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Ascending bitonic sort of a[0..n), n a power of two.
__device__ __forceinline__ void bitonic_sort(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long x = a[lo], y = a[hi];
        if ((x > y) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Ascending bitonic sort of pairs (h[i], l[i]) in lexicographic order.
__device__ __forceinline__ void bitonic_sort_pairs(unsigned long long* h,
                                                   unsigned long long* l,
                                                   int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long hx = h[lo], hy = h[hi];
        const unsigned long long lx = l[lo], ly = l[hi];
        const bool gt = hx > hy || (hx == hy && lx > ly);
        if (gt == up) {
          h[lo] = hy;
          h[hi] = hx;
          l[lo] = ly;
          l[hi] = lx;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace repro_torch
