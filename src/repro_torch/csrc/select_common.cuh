// Device helpers for the top-k selections that do not fit the thresholded
// candidate buffers of topk_common.cuh: (score, key) pairs packed into one
// 64-bit word, a block-wide bitonic sort of such words, and a block-wide
// radix select of the kk best words among a query's entries.
//
// The selection path (used by fused_score_topk.cu, ivf_score.cu and
// pq_lut.cu when kk is past what the buffers hold in shared memory, or when
// a caller forces it): the scan writes every score to scratch, then one
// block per query
//   1. finds the kk-th best packed word by a most-significant-digit-first
//      radix select, 8 bits a pass, over the query's entries (each pass
//      reads the entries once and builds a 256-bin histogram of the digit
//      under the prefix fixed so far; it stops as soon as the chosen bin
//      holds exactly the entries still wanted);
//   2. gathers the entries at or above it (exactly min(kk, live) of them:
//      the words are unique, since each carries its key);
//   3. bitonic-sorts them, best first, in shared memory (in device memory
//      past 16,384 entries).
// A packed word is (order-preserving score bits << 32) | ~key, so a larger
// word is a higher score, then a smaller key: the first-occurrence rule.
#pragma once

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

// Order-preserving unsigned image of a float's bits: -0.0 ranks below +0.0,
// as lax.top_k and the packed-key top-k of the plain PQ path rank them.
__device__ __forceinline__ unsigned ord_bits(float s) {
  const unsigned b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The same with -0.0 taken as +0.0: the order of better() (topk_common.cuh),
// which counts the two zeros equal and breaks the tie by key.
__device__ __forceinline__ unsigned ord_bits_eq0(float s) {
  const unsigned b = __float_as_uint(s);
  return b == 0x80000000u ? 0x80000000u : ord_bits(s);
}

__device__ __forceinline__ float from_ord(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// key in [0, 2^31): every packed word of a real entry is > 0, so 0 marks an
// empty slot.
__device__ __forceinline__ u64 pack(unsigned ord, int key) {
  return ((u64)ord << 32) | (u64)(~(unsigned)key);
}

__device__ __forceinline__ int key_of(u64 w) {
  return (int)(~(unsigned)(w & 0xffffffffu));
}

// Bitonic sort, largest first, of `segs` independent segments of `len` (a
// power of two) words each, moving the optional payload `pay` with them.
// Every thread of the block must call it.
__device__ void sort_desc(u64* w, int* pay, int segs, int len) {
  const int total = segs * len;
  for (int k = 2; k <= len; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool desc = (k == len) || ((i & k) == 0);
          const u64 a = w[i], b = w[ixj];
          if (desc ? a < b : a > b) {
            w[i] = b;
            w[ixj] = a;
            if (pay != nullptr) {
              const int t = pay[i];
              pay[i] = pay[ixj];
              pay[ixj] = t;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// Sort every segment, keep its best kk words (0 after them), and raise its
// admission threshold to its kk-th word once it holds kk. All segments at
// once: a cut costs its sort's barriers whatever its size, and cutting every
// buffer whenever one is full keeps them in step, so cuts stay rare (cutting
// only the full ones measured 1.5x slower). The u64 twin of trim() in
// topk_common.cuh. Every thread must call it.
__device__ void trim_words(u64* w, int* cnt, u64* thr, int segs, int cap,
                           int kk) {
  sort_desc(w, nullptr, segs, cap);
  for (int i = threadIdx.x; i < segs * cap; i += blockDim.x)
    if ((i & (cap - 1)) >= kk) w[i] = 0;
  if ((int)threadIdx.x < segs) {
    const int q = threadIdx.x;
    const int c = cnt[q] < kk ? cnt[q] : kk;
    cnt[q] = c;
    if (c >= kk) thr[q] = w[q * cap + kk - 1];
  }
  __syncthreads();
}

constexpr int kSelThreads = 512;   // threads of a selection block
// entries a thread reads before using any: one block per query streams its
// entries from device memory, so its loads in flight set its rate
constexpr int kSelUnroll = 16;

struct SelectState {
  unsigned hist[256];
  u64 prefix;        // the digits of the kk-th word fixed so far
  u64 fixed;         // the bits they occupy
  long long want;    // rank of the kk-th word among the entries under prefix
  int done;
  int count;
};

// Select and sort, best first, the kk largest packed words among src's
// entries: src.size() entries, src.get(e, &w) false for an entry that does
// not compete. Leaves min(kk, competing) words in w[0..) with their entry
// index in pos[], and 0 / -1 in the rest of the `len` (a power of two >= kk)
// slots; returns that count. w and pos are shared or device memory of this
// block alone. Every thread of the block must call it.
template <class Src>
__device__ int select_sorted(const Src& src, int kk, u64* w, int* pos,
                             int len, SelectState* st) {
  const int tid = threadIdx.x;
  const long long n = src.size();
  const long long step = (long long)blockDim.x * kSelUnroll;
  if (tid == 0) {
    st->prefix = 0;
    st->fixed = 0;
    st->want = kk;
    st->done = 0;
    st->count = 0;
  }
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) st->hist[i] = 0;
    __syncthreads();
    const u64 prefix = st->prefix, fixed = st->fixed;
    // each thread counts runs of equal digits in a register and adds a run
    // to the histogram when its digit changes: the first passes put nearly
    // every entry in one or two bins, where an atomic per entry would queue
    // on one address, and the later ones skip the entries off the prefix
    int run_dig = 0;
    unsigned run = 0;
    for (long long base = 0; base < n; base += step) {
      u64 v[kSelUnroll];
      bool in[kSelUnroll];
#pragma unroll
      for (int u = 0; u < kSelUnroll; ++u) {
        const long long e = base + (long long)u * blockDim.x + tid;
        in[u] = e < n && src.get(e, &v[u]);
      }
#pragma unroll
      for (int u = 0; u < kSelUnroll; ++u) {
        if (!in[u] || (v[u] & fixed) != prefix) continue;
        const int dig = (int)((v[u] >> shift) & 255u);
        if (dig != run_dig) {
          if (run) atomicAdd(&st->hist[run_dig], run);
          run_dig = dig;
          run = 0;
        }
        ++run;
      }
    }
    if (run) atomicAdd(&st->hist[run_dig], run);
    __syncthreads();
    if (tid == 0) {
      long long above = 0;
      if (shift == 56) {
        long long total = 0;
        for (int d = 0; d < 256; ++d) total += st->hist[d];
        if (total <= kk) st->done = 1;   // every competing entry is kept
      }
      if (!st->done) {
        int dsel = 0;
        for (int d = 255; d >= 0; --d) {
          if (above + st->hist[d] >= st->want) {
            dsel = d;
            break;
          }
          above += st->hist[d];
        }
        st->prefix |= (u64)dsel << shift;
        st->fixed |= (u64)255 << shift;
        st->want -= above;
        // the chosen bin holds exactly the entries still wanted: every
        // word at or above prefix (its lower bits 0) is in the top kk
        if (st->hist[dsel] == st->want) st->done = 1;
      }
    }
    __syncthreads();
    if (st->done) break;
  }
  const u64 thr = st->prefix;   // 0 when every competing entry is kept
  for (long long base = 0; base < n; base += step) {
    u64 v[kSelUnroll];
    bool in[kSelUnroll];
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      const long long e = base + (long long)u * blockDim.x + tid;
      in[u] = e < n && src.get(e, &v[u]);
    }
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      if (in[u] && v[u] >= thr) {
        const int at = atomicAdd(&st->count, 1);
        if (at < len) {
          w[at] = v[u];
          pos[at] = (int)(base + (long long)u * blockDim.x + tid);
        }
      }
    }
  }
  __syncthreads();
  const int count = st->count < len ? st->count : len;
  for (int i = count + tid; i < len; i += blockDim.x) {
    w[i] = 0;
    pos[i] = -1;
  }
  __syncthreads();
  sort_desc(w, pos, 1, len);
  return count;
}

// Dynamic shared memory of a selection block that sorts `len` words there
// (0 when it sorts in device memory).
inline size_t select_smem(int len, bool in_smem) {
  return in_smem ? (size_t)len * (sizeof(u64) + sizeof(int)) : 0;
}

}  // namespace
