// Device helpers shared by the top-k scans (fused_score_topk.cu and
// ivf_score.cu): the (score desc, key asc) total order, 16-byte cp.async
// staging, and the thresholded candidate buffers' bitonic trim.
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

// Asynchronous 16-byte global -> shared copy (sm_80+); src_bytes = 0 writes
// zeros without reading.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

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

// Sort every buffer, keep its best kk entries, and raise its admission
// threshold to its kk-th entry once it holds kk. Every thread must call it.
__device__ void trim(float* s, int* id, int* cnt, float* thr_s, int* thr_i,
                     int segs, int cap, int kk) {
  sort_segments(s, id, segs, cap);
  for (int i = threadIdx.x; i < segs * cap; i += blockDim.x) {
    if ((i & (cap - 1)) >= kk) {
      s[i] = -INFINITY;
      id[i] = INT_MAX;
    }
  }
  if (threadIdx.x < segs) {
    const int q = threadIdx.x;
    const int c = cnt[q] < kk ? cnt[q] : kk;
    cnt[q] = c;
    if (c >= kk) {
      thr_s[q] = s[q * cap + kk - 1];
      thr_i[q] = id[q * cap + kk - 1];
    }
  }
  __syncthreads();
}

}  // namespace
