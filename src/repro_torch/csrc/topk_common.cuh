// Device helpers of the top-k scans: the (score desc, key asc) total
// order, the stored element types (fp32, bf16, int8) and the bitonic sort
// of candidate segments, which fused_score_topk.cu and ivf_score.cu share;
// 16-byte cp.async staging, the column chunk width, the staging cast up to
// fp32 and the thresholded candidate buffers' trim, which ivf_score.cu
// uses.
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

// Columns of a row staged per chunk by the scans: rows of any width are
// staged kDC columns at a time (d rounded up to 4, at most kDC), so shared
// memory does not grow with d.
constexpr int kDC = 128;

__host__ __device__ __forceinline__ int staged_cols(int d) {
  const int d4 = (d + 3) & ~3;
  return d4 < kDC ? d4 : kDC;
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

// 16 bytes of bf16 or int8 values (8 or 16 of them) cast up to fp32 and
// stored at dst, which is 16-byte aligned in shared memory.
__device__ __forceinline__ void store_up(float* dst, uint4 w, Elem<kBF16>) {
  const unsigned v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<float4*>(dst + 4 * h) = make_float4(
        __uint_as_float(v[2 * h] << 16), __uint_as_float(v[2 * h] & 0xffff0000u),
        __uint_as_float(v[2 * h + 1] << 16),
        __uint_as_float(v[2 * h + 1] & 0xffff0000u));
  }
}

__device__ __forceinline__ void store_up(float* dst, uint4 w, Elem<kI8>) {
  const unsigned v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    // byte j (little-endian) sign-extended: shift it to the top, then down
    const unsigned u = v[h];
    *reinterpret_cast<float4*>(dst + 4 * h) = make_float4(
        (float)((int)(u << 24) >> 24), (float)((int)(u << 16) >> 24),
        (float)((int)(u << 8) >> 24), (float)((int)u >> 24));
  }
}

// Stage a tile of bf16 or int8 rows, cast up to fp32, into the shared-memory
// layout the inner loop reads (row r at dst + r * ds): `cw` columns of each
// row, row r starting at src + r * ld (src is the first staged column of the
// tile's first row). cw * sizeof(T), ld * sizeof(T) and the address of src
// are multiples of 16 bytes. Rows r with live(r) false, and rows from `rows`
// up to kTileRows, are zero-filled without a read. Each thread loads up to
// kLoads 16-byte words into registers before it converts any, so those loads
// are in flight together. The caller synchronises before the rows are read.
template <int ET, int kTileRows, int kThreadsPerBlock, typename Live>
__device__ __forceinline__ void stage_up(float* dst, int ds,
                                         const typename Elem<ET>::T* src,
                                         long long ld, int rows, int cw,
                                         Live live) {
  using T = typename Elem<ET>::T;
  constexpr int kPer = 16 / sizeof(T);                     // values a word
  constexpr int kLoads = 8;
  const int cpr = cw / kPer;                               // words a row
  const int total = kTileRows * cpr;
  for (int base = 0; base < total; base += kLoads * kThreadsPerBlock) {
    uint4 w[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreadsPerBlock + (int)threadIdx.x;
      const int r = i / cpr;
      w[j] = (i < total && r < rows && live(r))
                 ? __ldg(reinterpret_cast<const uint4*>(
                       src + r * ld + (i - r * cpr) * kPer))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = base + j * kThreadsPerBlock + (int)threadIdx.x;
      if (i < total) {
        const int r = i / cpr;
        store_up(dst + r * ds + (i - r * cpr) * kPer, w[j], Elem<ET>());
      }
    }
  }
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
