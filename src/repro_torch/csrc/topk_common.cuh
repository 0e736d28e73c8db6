// Device helpers of the top-k scans: the (score desc, key asc) total
// order, the stored element types (fp32, bf16, int8) and the bitonic sort
// of candidate segments, which fused_score_topk.cu and ivf_score.cu share.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

// a is better than b: higher score, or equal score and smaller key. This is
// the TPU kernels' first-occurrence rule written as a total order.
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Stored element types of the scanned rows (the storage ladder), passed to
// the C entry points as an int: fp32, bf16 (raw 16-bit words: the upper half
// of an fp32) and int8 codes. Casting each up to fp32 is exact.
enum : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int ET> struct Elem;
template <> struct Elem<kF32> {
  using T = float;
  __device__ static float at(const T* p, long long i) { return p[i]; }
};
template <> struct Elem<kBF16> {
  using T = unsigned short;
  __device__ static float at(const T* p, long long i) {
    return __uint_as_float((unsigned)p[i] << 16);
  }
};
template <> struct Elem<kI8> {
  using T = signed char;
  __device__ static float at(const T* p, long long i) { return (float)p[i]; }
};

// Bitonic sort, best first, of `segs` independent segments of `cap` (a power
// of two) entries each. Every thread of the block must call it.
__device__ void sort_segments(float* s, int* id, int segs, int cap) {
  const int total = segs * cap;
  for (int k = 2; k <= cap; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (k == cap) || ((i & k) == 0);
          const float si = s[i], sj = s[ixj];
          const int ii = id[i], ij = id[ixj];
          if (up ? better(sj, ij, si, ii) : better(si, ii, sj, ij)) {
            s[i] = sj;
            s[ixj] = si;
            id[i] = ij;
            id[ixj] = ii;
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace
