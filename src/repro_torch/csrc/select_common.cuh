// Device helpers for the top-k selections that do not fit the thresholded
// candidate buffers of topk_common.cuh: (score, key) pairs packed into one
// 64-bit word, a block-wide bitonic sort of such words, and a multi-block
// radix select of each query's kk best words.
//
// The selection path (used by fused_score_topk.cu, ivf_score.cu and
// pq_lut.cu when kk is past what the buffers hold in shared memory, or when
// a caller forces it): the scan writes every score to scratch, then
//   1. pass blocks over (query, chunk) (sel_pass_kernel, kPassThreads
//      threads each, enough chunks that the grid covers the SMs twice)
//      build a histogram of one 16-bit digit of the query's packed words
//      under the digits fixed so far, in 16-bit counters in shared memory
//      (a chunk holds at most 65,535 entries; each thread adds runs of
//      equal digits, so a hot bin takes one atomic a run), and add their
//      non-zero bins to the query's histogram in device memory. The last
//      block of each query (a completion counter) picks the bin that holds
//      the kk-th word, from coarse sums of 256 bins first (coalesced reads:
//      a scan of all 65,536 bins by one block set the pass's pace). A
//      float's top 16 bits are its sign, exponent and 7 mantissa bits, so
//      where the scores spread, that bin is small: the words above it and
//      in it (their count is known exactly from the histogram) fit the
//      query's candidate buffer in device memory, and
//   2. the next launch of the same kernel compacts them into it (one read
//      of the scratch; warp-aggregated appends). Where the bin does not
//      fit (mass ties), the next launch histograms the next digit over the
//      full row under the prefix instead: the same kernel, launched
//      kSelPasses times, does a histogram, a compaction or nothing per
//      query as the query's state says, so the pass count follows the
//      data (one histogram and one compaction where the scores spread, at
//      most four histograms). An entry set no larger than the buffer is
//      compacted at once, with no histogram.
//   3. one block per query (select_finish, in each caller's finish kernel)
//      radix-selects the kk-th word among the buffer's words by 11-bit
//      digits below the fixed ones (2048 bins in shared memory), gathers
//      the words at or above it (exactly min(kk, live): the words are
//      unique, since each carries its key) and bitonic-sorts them, best
//      first, in shared memory (in device memory past 16,384 words); the
//      caller's epilogue follows.
// A packed word is (order-preserving score bits << 32) | ~key, so a larger
// word is a higher score, then a smaller key: the first-occurrence rule.
// Bound: bytes. Each query's live entries are read once by the histogram
// and once by the compaction (the bound counts one read); the buffer
// passes and the sort touch some thousands of words a query.
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

// The selection path's launch shapes. kSelThreads: a finish block (one a
// query); kPassThreads: a pass block; kPassUnroll: 16-byte loads a pass
// thread issues before testing any entry (its loads in flight).
constexpr int kSelThreads = 1024;
constexpr int kPassThreads = 1024;
constexpr int kPassUnroll = 4;
constexpr int kDigit = 16;                 // bits of a full-row pass's digit
constexpr int kBins = 1 << kDigit;
constexpr int kCoarse = 256;               // bins of a digit's top 8 bits
constexpr int kHistWords = kBins + kCoarse;  // a query's histogram
constexpr long long kMaxChunk = 65535;   // a pass block's entries (16-bit bins)
constexpr int kSelPasses = 64 / kDigit + 1;  // four digits, a compaction
constexpr int kFinDigit = 11;      // the buffer's digits (select_finish)
constexpr int kFinBins = 1 << kFinDigit;
// a query's state between the passes (mode)
enum : int { kModeHist = 0, kModeCompact = 1, kModeDone = 2 };
// the optional profile: for each launch (the passes, then the finish) the
// first block's start and the last block's end (globaltimer ns) and the
// modes its blocks ran (bit 1 << mode)
constexpr int kSelStatSlots = 3 * (kSelPasses + 1);

// One query's state, 64 bytes. The words at or above `prefix` in the bits
// `fixed` are the candidates; `want` is the kk-th word's rank among those
// equal to prefix in those bits (the words above them are all in the top
// kk). `shift` is the next full-row digit's lowest bit.
struct SelQuery {
  u64 prefix;
  u64 fixed;
  unsigned want;
  unsigned nbuf;       // words compacted into the candidate buffer
  unsigned arrived;    // blocks of the current launch that are done
  int shift;
  int mode;
  unsigned pad[7];
};

// The selection path's plan and device scratch (kernels/_build.py's
// SelectArgs fills it: the same fields in the same order).
struct SelectArgs {
  SelQuery* st;        // (nq,)
  unsigned* hist;      // (nq, kHistWords) zeros: each query's kBins bins,
                       //   then their kCoarse sums; null when no
                       //   histogram runs
  u64* bufw;           // (nq, cap) candidate words
  int* bufp;           // (nq, cap) their entry indices
  u64* sort_w;         // (nq, len) and (nq, len): the sort's scratch, or
  int* sort_pos;       //   null to sort in shared memory
  u64* stats;          // null, or kSelStatSlots (see above)
  long long chunk;     // entries a pass block reads
  int nchunks;         // pass blocks a query
  int cap;             // candidate-buffer words a query (>= kk where a
                       //   histogram runs)
  int len;             // the sort's words: a power of two >= kk
  int passes;          // pass launches: kSelPasses, or 1 (no histogram)
  int kk;
  int nq;
};

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stat_span(u64* stats, int slot, u64 t0,
                                          int mode) {
  if (stats == nullptr) return;
  atomicMin(stats + 3 * slot, t0);
  atomicMax(stats + 3 * slot + 1, now_ns());
  atomicOr(stats + 3 * slot + 2, 1ull << mode);
}

// Exclusive prefix sum of v over the block's threads in order; *total gets
// the sum. Every thread must call it.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* total) {
  __shared__ unsigned warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned before = 0, all = 0;
  const int warps = (blockDim.x + 31) >> 5;
  for (int w = 0; w < warps; ++w) {
    if (w < warp) before += warp_sum[w];
    all += warp_sum[w];
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// Calls f(ord, entry, segment) for the entries [e0, e1) of query q, every
// thread of the block the same number of times (ord 0 past the range and
// for an entry that does not compete: a competing entry's order bits are
// never 0). The scores are read 16 bytes a thread at a time, kPassUnroll
// of them in flight (a thread's four consecutive entries a load), with the
// few entries before the first aligned one and after the last, one a
// thread. A source with segments (Src::kSegmented: IVF lists of seg_len()
// entries) has the block test seg_live a block's width of segments at a
// time, a segment a thread, and read the live ones only. Src gives the
// query's row of scores (row(q)), an entry's order bits (ord(v), 0 when it
// does not compete), and its key (key(q, seg, e)), read only where a word
// is needed.
template <class Src, class F>
__device__ __forceinline__ void for_entries(const Src& src, int q,
                                            long long e0, long long e1,
                                            F f) {
  const float* row = src.row(q);
  const int tid = threadIdx.x;
  const long long nt = blockDim.x;
  // the entries [lo, hi) of segment seg
  auto run = [&](long long seg, long long lo, long long hi) {
    const int mis = (int)((reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3);
    long long a = lo + ((4 - mis) & 3);
    if (a > hi) a = hi;
    const long long nvec = (hi - a) >> 2;
    const long long tail = a + 4 * nvec;
    {  // the entries before the first aligned one, and after the last
      const long long e = lo + tid, t = tail + tid;
      f(e < a ? src.ord(row[e]) : 0u, e, seg);
      f(t < hi ? src.ord(row[t]) : 0u, t, seg);
    }
    const float4* v4 = reinterpret_cast<const float4*>(row + a);
    for (long long base = 0; base < nvec; base += nt * kPassUnroll) {
      float4 v[kPassUnroll];
#pragma unroll
      for (int u = 0; u < kPassUnroll; ++u) {
        const long long j = base + u * nt + tid;
        if (j < nvec) v[u] = __ldcs(v4 + j);
      }
#pragma unroll
      for (int u = 0; u < kPassUnroll; ++u) {
        const long long j = base + u * nt + tid;
        const long long e = a + 4 * j;
        const bool in = j < nvec;   // past it, nothing competes
        f(in ? src.ord(v[u].x) : 0u, e, seg);
        f(in ? src.ord(v[u].y) : 0u, e + 1, seg);
        f(in ? src.ord(v[u].z) : 0u, e + 2, seg);
        f(in ? src.ord(v[u].w) : 0u, e + 3, seg);
      }
    }
  };
  if constexpr (!Src::kSegmented) {
    run(0, e0, e1);
  } else {
    __shared__ int live_off[kPassThreads];   // a group's live segments
    const long long L = src.seg_len();
    const long long s_end = (e1 - 1) / L + 1;
    for (long long g0 = e0 / L; g0 < s_end; g0 += nt) {
      const bool lv = g0 + tid < s_end && src.seg_live(q, g0 + tid);
      unsigned nlive;
      const unsigned at = block_scan(lv ? 1u : 0u, &nlive);
      if (lv) live_off[at] = tid;
      __syncthreads();
      for (unsigned i = 0; i < nlive; ++i) {
        const long long seg = g0 + live_off[i];
        run(seg, seg * L > e0 ? seg * L : e0,
            (seg + 1) * L < e1 ? (seg + 1) * L : e1);
      }
      __syncthreads();   // every thread has read live_off before the next
    }
  }
}

// The packed word of an entry of order bits o.
template <class Src>
__device__ __forceinline__ u64 word_at(const Src& src, int q, long long seg,
                                       long long e, unsigned o) {
  return ((u64)o << 32) | (u64)(~(unsigned)src.key(q, seg, e));
}

// The last block of query q's histogram pass: picks the bin of the query's
// histogram that holds its kk-th word (best first from the top: the coarse
// bin by one warp over kCoarse sums, then the bin among its 256 by the
// block, so every read is coalesced), zeroes the histogram for the next
// pass, and sets the state: a compaction where the candidates fit the
// buffer (or every competing entry is kept), else the next digit.
__device__ void choose_bin(const SelectArgs& a, int q) {
  __shared__ int s_coarse, s_dsel;
  __shared__ unsigned s_total, s_left, s_above, s_bin;
  SelQuery* sq = a.st + q;
  unsigned* gh = a.hist + (long long)q * kHistWords;
  unsigned* gc = gh + kBins;
  const int tid = threadIdx.x;
  const unsigned want = sq->want;
  const bool first = sq->fixed == 0;
  if (tid < 32) {
    // lane l: coarse bins 255 - 8l down to 248 - 8l
    unsigned c[8], sum = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      c[m] = __ldcg(gc + kCoarse - 1 - 8 * tid - m);
      sum += c[m];
    }
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += t;
    }
    const int leader = __ffs(__ballot_sync(0xffffffffu, incl >= want)) - 1;
    if (tid == 31) s_total = incl;
    if (tid == leader) {
      unsigned acc = incl - sum;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (acc + c[m] >= want) {
          s_coarse = kCoarse - 1 - 8 * tid - m;
          s_left = want - acc;
          s_above = acc;
          break;
        }
        acc += c[m];
      }
    }
  }
  __syncthreads();
  // the first pass's sum counts every competing entry
  const bool all = first && s_total <= (unsigned)a.kk;
  if (!all && tid < 256) {
    // thread t: bin 255 - t of the coarse bin, best first
    const int bin = s_coarse * 256 + 255 - tid;
    const unsigned c = __ldcg(gh + bin);
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
      if ((tid & 31) >= o) incl += t;
    }
    __shared__ unsigned wsum[8];
    if ((tid & 31) == 31) wsum[tid >> 5] = incl;
    asm volatile("bar.sync 2, 256;" ::: "memory");
    unsigned before = incl - c;
    for (int w = 0; w < (tid >> 5); ++w) before += wsum[w];
    if (before < s_left && before + c >= s_left) {
      s_dsel = bin;
      s_above = s_above + before;
      s_bin = c;
    }
  }
  __syncthreads();
  for (int i = tid; i < kHistWords; i += blockDim.x) gh[i] = 0;
  if (tid == 0) {
    if (all) {   // every competing entry is kept
      sq->mode = kModeCompact;
    } else {
      sq->prefix |= (u64)s_dsel << sq->shift;
      sq->fixed |= (u64)(kBins - 1) << sq->shift;
      const unsigned w = want - s_above;
      sq->want = w;
      // the words at or above the new prefix: the kk - w above its bin
      // and the bin's s_bin
      const unsigned long long cand = (unsigned long long)(a.kk - w) + s_bin;
      if (cand <= (unsigned long long)a.cap || sq->shift == 0)
        sq->mode = kModeCompact;
      else
        sq->shift -= kDigit;
    }
    sq->arrived = 0;
  }
}

// One launch of the passes (see the header): block (q, c) reads query q's
// entries [c * chunk, (c + 1) * chunk) and histograms them, compacts them
// or returns at once, as the query's state says.
template <class Src>
__global__ void __launch_bounds__(kPassThreads, 1)
sel_pass_kernel(const Src src, const SelectArgs a, int launch) {
  extern __shared__ unsigned h2[];   // kBins 16-bit counters, two a word
  __shared__ int last;
  const int q = blockIdx.x;
  SelQuery* sq = a.st + q;
  const int mode = sq->mode;
  if (mode == kModeDone) return;     // the same for the whole block
  const u64 t0 = a.stats != nullptr ? now_ns() : 0;
  const int tid = threadIdx.x;
  const long long n = src.size(q);
  const long long e0 = (long long)blockIdx.y * a.chunk;
  const long long e1 = e0 + a.chunk < n ? e0 + a.chunk : n;
  const u64 prefix = sq->prefix, fixed = sq->fixed;
  // while the fixed digits lie in the score bits (the common case), only
  // the 32 order bits are tested, and the key is read for kept words only
  const bool hi_only = (unsigned)fixed == 0u;
  const unsigned fh = (unsigned)(fixed >> 32), ph = (unsigned)(prefix >> 32);
  if (e0 >= e1) {
    // past the query's entries (a masked count below the bound): nothing
  } else if (mode == kModeHist) {
    for (int i = tid; i < kBins / 2; i += blockDim.x) h2[i] = 0;
    __syncthreads();
    const int shift = sq->shift;
    // each thread counts runs of equal digits in a register and adds a run
    // when its digit changes: where many entries share a bin (ties), a run
    // takes one atomic
    int run_dig = 0;
    unsigned run = 0;
    auto count = [&](int dig) {
      if (dig != run_dig) {
        if (run) atomicAdd(&h2[run_dig >> 1], run << ((run_dig & 1) * 16));
        run_dig = dig;
        run = 0;
      }
      ++run;
    };
    if (hi_only && shift >= 32) {
      const int sh = shift - 32;
      for_entries(src, q, e0, e1, [&](unsigned o, long long, long long) {
        if (o != 0u && (o & fh) == ph) count((int)((o >> sh) & (kBins - 1)));
      });
    } else {
      for_entries(src, q, e0, e1, [&](unsigned o, long long e,
                                      long long seg) {
        if (o == 0u) return;
        const u64 w = word_at(src, q, seg, e, o);
        if ((w & fixed) == prefix) count((int)((w >> shift) & (kBins - 1)));
      });
    }
    if (run) atomicAdd(&h2[run_dig >> 1], run << ((run_dig & 1) * 16));
    __syncthreads();
    // the non-zero bins into the query's histogram, and each warp's 64
    // bins (a quarter of a coarse bin) into their coarse sum
    unsigned* gh = a.hist + (long long)q * kHistWords;
    for (int i = tid; i < kBins / 2; i += blockDim.x) {
      const unsigned v = h2[i];
      const unsigned lo = v & 0xffffu, hi = v >> 16;
      if (lo) atomicAdd(gh + 2 * i, lo);
      if (hi) atomicAdd(gh + 2 * i + 1, hi);
      unsigned part = lo + hi;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if ((tid & 31) == 0 && part) atomicAdd(gh + kBins + (2 * i) / 256, part);
    }
  } else {
    // the words at or above the prefix, appended at a warp's atomic offset
    u64* bw = a.bufw + (long long)q * a.cap;
    int* bp = a.bufp + (long long)q * a.cap;
    const int lane = tid & 31;
    for_entries(src, q, e0, e1, [&](unsigned o, long long e, long long seg) {
      bool keep = o != 0u;
      u64 w = 0;
      if (hi_only) {
        keep = keep && (o & fh) >= ph;
      } else if (keep) {
        w = word_at(src, q, seg, e, o);
        keep = (w & fixed) >= prefix;
      }
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (m == 0) return;
      const int leader = __ffs(m) - 1;
      unsigned at = 0;
      if (lane == leader) at = atomicAdd(&sq->nbuf, (unsigned)__popc(m));
      at = __shfl_sync(0xffffffffu, at, leader) +
           __popc(m & ((1u << lane) - 1u));
      if (keep && at < (unsigned)a.cap) {
        bw[at] = hi_only ? word_at(src, q, seg, e, o) : w;
        bp[at] = (int)e;
      }
    });
  }
  // the last block of the query (a completion counter) moves its state on
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&sq->arrived, 1u) == gridDim.y - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    if (mode == kModeHist) {
      choose_bin(a, q);
    } else if (tid == 0) {
      sq->mode = kModeDone;
      sq->arrived = 0;
    }
  }
  if (tid == 0) stat_span(a.stats, launch, t0, mode);
}

__global__ void sel_init_kernel(const SelectArgs a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= a.nq) return;
  SelQuery s = {};
  s.want = (unsigned)a.kk;
  s.shift = 64 - kDigit;
  s.mode = a.hist != nullptr ? kModeHist : kModeCompact;
  a.st[q] = s;
}

// Steps 1 and 2 for every query of src: a.nq queries, each with
// src.size(q) entries (at most a.nchunks * a.chunk).
template <class Src>
cudaError_t select_passes(const Src& src, const SelectArgs& a,
                          cudaStream_t st) {
  if (a.chunk <= 0 || a.chunk > kMaxChunk || a.cap <= 0)
    return cudaErrorInvalidValue;
  sel_init_kernel<<<(a.nq + 255) / 256, 256, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int smem = 0;
  if (a.hist != nullptr) {
    err = cudaMemsetAsync(a.hist, 0,
                          sizeof(unsigned) * kHistWords * (size_t)a.nq, st);
    if (err != cudaSuccess) return err;
    smem = sizeof(unsigned) * kBins / 2;
  }
  err = cudaFuncSetAttribute(sel_pass_kernel<Src>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)a.nq, (unsigned)a.nchunks);
  for (int p = 0; p < a.passes; ++p) {
    sel_pass_kernel<Src><<<grid, kPassThreads, smem, st>>>(src, a, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

struct FinishState {
  unsigned hist[kFinBins];
  u64 prefix;
  u64 fixed;
  unsigned want;
  int done;
  int count;
};

// Step 3 for query q: leaves its min(kk, live) best words, best first, in
// w[0..) with their entry indices in pos[], and 0 / -1 in the rest of the
// a.len slots (shared memory, or a.sort_w / a.sort_pos); returns that
// count. Every thread of the block must call it.
__device__ int select_finish(const SelectArgs& a, int q, u64* w, int* pos,
                             FinishState* fs) {
  const u64 t0 = a.stats != nullptr ? now_ns() : 0;
  const int tid = threadIdx.x;
  const SelQuery* sq = a.st + q;
  const unsigned nb = sq->nbuf < (unsigned)a.cap ? sq->nbuf : a.cap;
  const u64* bw = a.bufw + (long long)q * a.cap;
  const int* bp = a.bufp + (long long)q * a.cap;
  if (tid == 0) {
    fs->prefix = sq->prefix;
    fs->fixed = sq->fixed;
    fs->want = sq->want;
    fs->done = nb <= (unsigned)a.kk;   // every candidate is kept
    fs->count = 0;
    if (fs->done) fs->prefix = 0;
  }
  __syncthreads();
  // below the fixed bits, 11-bit digits over the buffer until the chosen
  // bin holds exactly the words still wanted
  int low = fs->fixed == 0 ? 64 : __ffsll((long long)fs->fixed) - 1;
  while (!fs->done && low > 0) {
    const int width = low < kFinDigit ? low : kFinDigit;
    const int shift = low - width;
    const int bins = 1 << width;
    for (int i = tid; i < bins; i += blockDim.x) fs->hist[i] = 0;
    __syncthreads();
    const u64 prefix = fs->prefix, fixed = fs->fixed;
    int run_dig = 0;
    unsigned run = 0;
    for (unsigned i = tid; i < nb; i += blockDim.x) {
      const u64 v = bw[i];
      if ((v & fixed) != prefix) continue;
      const int dig = (int)((v >> shift) & (u64)(bins - 1));
      if (dig != run_dig) {
        if (run) atomicAdd(&fs->hist[run_dig], run);
        run_dig = dig;
        run = 0;
      }
      ++run;
    }
    if (run) atomicAdd(&fs->hist[run_dig], run);
    __syncthreads();
    if (tid < 32) {
      // lane l holds the bins top - 1 down to top - per, best first
      const int per = (bins + 31) / 32;
      const int top = bins - per * tid;
      unsigned sum = 0;
      for (int i = 1; i <= per; ++i)
        if (top - i >= 0) sum += fs->hist[top - i];
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      const unsigned want = fs->want;
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= want);
      const int leader = __ffs(hit) - 1;
      if (tid == leader) {
        unsigned acc = incl - sum;
        for (int i = 1; i <= per && top - i >= 0; ++i) {
          const unsigned c = fs->hist[top - i];
          if (acc + c >= want) {
            fs->prefix = prefix | ((u64)(top - i) << shift);
            fs->fixed = fixed | ((u64)(bins - 1) << shift);
            fs->want = want - acc;
            fs->done = c == want - acc;
            break;
          }
          acc += c;
        }
      }
    }
    __syncthreads();
    low = shift;
  }
  // every word at or above the prefix (its lower bits 0): exactly
  // min(kk, nb) of them
  const u64 thr = fs->prefix;
  for (unsigned i = tid; i < nb; i += blockDim.x) {
    const u64 v = bw[i];
    if (v >= thr) {
      const int at = atomicAdd(&fs->count, 1);
      if (at < a.len) {
        w[at] = v;
        pos[at] = bp[i];
      }
    }
  }
  __syncthreads();
  const int count = fs->count < a.len ? fs->count : a.len;
  for (int i = count + tid; i < a.len; i += blockDim.x) {
    w[i] = 0;
    pos[i] = -1;
  }
  __syncthreads();
  sort_desc(w, pos, 1, a.len);
  if (tid == 0) stat_span(a.stats, kSelPasses, t0, kModeDone);
  return count;
}

// The finish block's sort area for query q: the caller's shared memory, or
// the device scratch.
__device__ __forceinline__ void sort_area(const SelectArgs& a, int q,
                                          unsigned char* smem, u64** w,
                                          int** pos) {
  if (a.sort_w != nullptr) {
    *w = a.sort_w + (long long)q * a.len;
    *pos = a.sort_pos + (long long)q * a.len;
  } else {
    *w = reinterpret_cast<u64*>(smem);
    *pos = reinterpret_cast<int*>(*w + a.len);
  }
}

// Dynamic shared memory of a finish block (0 when it sorts in device
// memory).
inline size_t select_smem(const SelectArgs& a) {
  return a.sort_w == nullptr ? (size_t)a.len * (sizeof(u64) + sizeof(int))
                             : 0;
}

}  // namespace
