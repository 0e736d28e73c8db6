// The copy engine's ring and the warp cut of the top-k scans: mbarrier and
// TMA (cp.async.bulk.tensor) helpers for a staging ring fed by a producer
// warp, the packed (score, key) word of a candidate, warp_cut (one warp cuts
// a query's candidate buffer back to its kk best by a radix select of
// 8-bit digits, keeping their order; on (score, id) pairs or on packed
// words) and stream_topk (a block keeps the kk best of a stream of
// candidates, each warp cutting its own buffer). The IVF list scan
// (ivf_score.cu) and the fused PQ scan (pq_lut.cu, warp_cut on words) use
// them; fused_score_topk.cu carries the same definitions of its own.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

#include "select_common.cuh"
#include "topk_common.cuh"

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(u64* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one box of the row matrix (its size and swizzle are the map's) at (column
// c0, row r0), rows and columns past the matrix zero-filled, completing on
// bar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c0, int r0, u64* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(r0),
      "r"(smem_addr(bar))
      : "memory");
}

// 16 bytes global -> shared by the load units; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// an arrival on bar once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(u64* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ u64 word_of(float s, int id) {
  return pack(ord_bits_eq0(s), id);
}

// Candidate e of one query as an item for warp_cut: its (score, id), from
// its buffer below cap or its spill slots past it, ranked by word_of.
struct Cands {
  float* bs;
  int* bi;
  const float* ss;
  const int* si;
  int cap;
  struct Item {
    float s;
    int id;
  };
  __device__ __forceinline__ Item get(int e) const {
    return e < cap ? Item{bs[e], bi[e]} : Item{ss[e - cap], si[e - cap]};
  }
  __device__ __forceinline__ static u64 word(const Item& t) {
    return word_of(t.s, t.id);
  }
  __device__ __forceinline__ void put(int p, const Item& t) const {
    bs[p] = t.s;
    bi[p] = t.id;
  }
};

// A query's packed words in place (the PQ scan's): the word is the item and
// its own rank, so -0.0 ranks below +0.0 as ord_bits orders them. Words
// past cap are read from spill (null where none can be).
struct Words {
  u64* w;
  const u64* spill;
  int cap;
  using Item = u64;
  __device__ __forceinline__ u64 get(int e) const {
    return e < cap ? w[e] : spill[e - cap];
  }
  __device__ __forceinline__ static u64 word(u64 t) { return t; }
  __device__ __forceinline__ void put(int p, u64 t) const { w[p] = t; }
};

// One warp keeps the kk best of a query's cnt (> kk) items, in their order,
// in positions [0, kk) and returns the kk-th best word: a radix select of
// 8-bit digits from the highest bit on which the words differ (the words are
// unique: each carries its row id), stopping once the chosen bin holds
// exactly the words still wanted, then a compaction. C is Cands or Words.
// hist is the warp's own 256 counters. Every lane of the warp calls it.
template <class C>
__device__ __forceinline__ u64 warp_cut(const C& c, int cnt, int kk,
                                         unsigned* hist) {
  using Item = typename C::Item;
  const int lane = threadIdx.x & 31;
  const u64 w0 = C::word(c.get(0));
  // the entries in rounds of 8 a lane, every load of a round issued first
  auto words = [&](int base, u64 (&w)[8], bool (&in)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + 32 * u + lane;
      in[u] = e < cnt;
      w[u] = in[u] ? C::word(c.get(e)) : 0ull;
    }
  };
  u64 diff = 0;
  for (int base = 0; base < cnt; base += 256) {
    u64 w[8];
    bool in[8];
    words(base, w, in);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (in[u]) diff |= w[u] ^ w0;
  }
  const unsigned dhi = __reduce_or_sync(0xffffffffu, (unsigned)(diff >> 32));
  const unsigned dlo = __reduce_or_sync(0xffffffffu, (unsigned)diff);
  const u64 d = ((u64)dhi << 32) | dlo;
  const int hb = 63 - __clzll((long long)d);       // d != 0: cnt > kk >= 1
  u64 fixed = hb == 63 ? 0ull : ~0ull << (hb + 1);
  u64 prefix = w0 & fixed;
  int want = kk;
  int shift = hb >= 7 ? hb - 7 : 0;
  for (;;) {
    for (int b = lane; b < 256; b += 32) hist[b] = 0;
    __syncwarp();
    for (int base = 0; base < cnt; base += 256) {
      u64 w[8];
      bool in[8];
      words(base, w, in);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (in[u] && (w[u] & fixed) == prefix)
          atomicAdd(&hist[(w[u] >> shift) & 255u], 1u);
    }
    __syncwarp();
    // lane L holds bins 255 - 8L down to 248 - 8L: the best digits first
    unsigned h[8], sum = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      h[m] = hist[255 - 8 * lane - m];
      sum += h[m];
    }
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, incl >= (unsigned)want);
    const int leader = __ffs(hit) - 1;
    int dsel = 0;
    unsigned above = incl - sum, bin = 0;
    if (lane == leader) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        if (above + h[m] >= (unsigned)want) {
          dsel = 255 - 8 * lane - m;
          bin = h[m];
          break;
        }
        above += h[m];
      }
    }
    dsel = __shfl_sync(0xffffffffu, dsel, leader);
    above = __shfl_sync(0xffffffffu, above, leader);
    bin = __shfl_sync(0xffffffffu, bin, leader);
    __syncwarp();   // every lane has read hist before the next pass clears it
    prefix |= (u64)dsel << shift;
    fixed |= (u64)255 << shift;
    want -= (int)above;
    if (bin == (unsigned)want || shift == 0) break;
    shift = shift >= 8 ? shift - 8 : 0;
  }
  // keep every word whose fixed bits are at or above the prefix: exactly kk
  u64 least = ~0ull;
  int out = 0;
  for (int base = 0; base < cnt; base += 256) {
    Item it[8];
    bool keep[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + 32 * u + lane;
      keep[u] = false;
      if (e < cnt) {
        it[u] = c.get(e);
        const u64 w = C::word(it[u]);
        keep[u] = (w & fixed) >= prefix;
        if (keep[u] && w < least) least = w;
      }
    }
    __syncwarp();   // this round's entries are read before any is written
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned b = __ballot_sync(0xffffffffu, keep[u]);
      if (keep[u]) c.put(out + __popc(b & ((1u << lane) - 1u)), it[u]);
      out += __popc(b);
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 v = __shfl_xor_sync(0xffffffffu, least, o);
    if (v < least) least = v;
  }
  return least;
}

constexpr int kMergeThreads = 256;   // a stream_topk block
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kWarpRound = 32 * 8;   // entries a warp reads a round

// Slots of one warp's buffer in stream_topk, and its block's shared memory
// (kMergeWarps buffers, then the warps' digit histograms).
// kk plus at least one round, and room for another list of kk: 8 rounds
// where shared memory holds them (fewer, larger cuts), 2 otherwise
__host__ __device__ inline int stream_slots(int kk) {
  int extra = 8 * kWarpRound;
  if (kMergeWarps * 8 * (kk + (kk > extra ? kk : extra)) > 200 * 1024)
    extra = 2 * kWarpRound;
  return kk + (kk > extra ? kk : extra);
}

__host__ __device__ inline size_t stream_smem(int kk) {
  return (size_t)kMergeWarps * (8 * (size_t)stream_slots(kk) + 4 * 256);
}

// Keeps the best kk of src's len entries (src.get(e, &s, &id) false for one
// that does not compete), with warp_cut: each warp streams
// its share (8 entries a lane before testing any), appends those that beat
// its threshold to its own buffer (a ballot, no atomics), and cuts its
// buffer back to kk by warp_cut when the next round might not fit; then
// warp 0 gathers the warps' lists and cuts them to kk. Leaves them,
// unordered, in bs/bi[0..count) and returns count = min(kk, competing);
// *thr_s / *thr_i get a (score, id) at or below the kk-th best: the kk-th
// best whenever the last cut ran. Entries must beat (s0, i0). Every thread
// of the block must call it; smem is stream_smem(kk) bytes.
template <class Src>
__device__ int stream_topk(const Src& src, long long len, int kk, float s0,
                           int i0, unsigned char* smem, float* thr_s,
                           int* thr_i) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slots = stream_slots(kk);
  float* bs = reinterpret_cast<float*>(smem) + 2 * warp * slots;
  int* bi = reinterpret_cast<int*>(bs + slots);
  unsigned* hist = reinterpret_cast<unsigned*>(
      smem + (size_t)kMergeWarps * 8 * slots) + 256 * warp;
  float ts = s0;
  int ti = i0, cnt = 0;
  auto cut = [&](float* cs, int* ci, int c) {
    const u64 w = warp_cut(Cands{cs, ci, nullptr, nullptr, c}, c, kk, hist);
    ts = from_ord((unsigned)(w >> 32));
    ti = key_of(w);
  };
  for (long long base = (long long)warp * kWarpRound; base < len;
       base += (long long)kMergeWarps * kWarpRound) {
    float v[8];
    int k[8];
    bool in[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long e = base + u * 32 + lane;
      in[u] = e < len && src.get(e, &v[u], &k[u]) &&
              better(v[u], k[u], ts, ti);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned b = __ballot_sync(0xffffffffu, in[u]);
      if (in[u]) {
        const int p = cnt + __popc(b & ((1u << lane) - 1u));
        bs[p] = v[u];
        bi[p] = k[u];
      }
      cnt += __popc(b);
    }
    __syncwarp();
    if (cnt > slots - kWarpRound) {
      cut(bs, bi, cnt);
      cnt = kk;
    }
  }
  if (cnt > kk) {
    cut(bs, bi, cnt);
    cnt = kk;
  }
  // warp 0 gathers every warp's list after its own and cuts them to kk
  __shared__ int counts[kMergeWarps];
  if (lane == 0) counts[warp] = cnt;
  __syncthreads();
  int total = 0;
  if (warp == 0) {
    total = counts[0];
    float* ds = bs;
    int* di = bi;
    for (int w = 1; w < kMergeWarps; ++w) {
      if (total + counts[w] > slots) {   // room for the next list
        cut(ds, di, total);
        total = kk;
      }
      const float* ws = reinterpret_cast<float*>(smem) + 2 * w * slots;
      const int* wi = reinterpret_cast<const int*>(ws + slots);
      for (int j = lane; j < counts[w]; j += 32) {
        ds[total + j] = ws[j];
        di[total + j] = wi[j];
      }
      total += counts[w];
      __syncwarp();
    }
    if (total > kk) {
      cut(ds, di, total);
      total = kk;
    }
    if (lane == 0) {
      counts[0] = total;
      *thr_s = ts;
      *thr_i = ti;
    }
  }
  __syncthreads();
  return counts[0];
}


typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Describes the (n, d) rows of element type et to the copy engine as boxes
// of box_rows rows x 128 bytes with the 128-byte swizzle (16-byte chunk j of
// a box's row r at j ^ (r % 8)), setting *ok; rows whose width or base is
// no multiple of 16 bytes cannot be described (*ok false, no error).
inline cudaError_t row_map(CUtensorMap* map, const void* x, int et,
                           long long n, int d, int box_rows, bool* ok) {
  static EncodeTiled encode = nullptr;
  const int es = et == kF32 ? 4 : et == kBF16 ? 2 : 1;
  *ok = false;
  std::memset(map, 0, sizeof(*map));
  if ((d * es) % 16 != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return cudaSuccess;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * es};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / es), (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapDataType type =
      et == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : et == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (encode(map, type, 2, const_cast<void*>(x), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  *ok = true;
  return cudaSuccess;
}

}  // namespace
