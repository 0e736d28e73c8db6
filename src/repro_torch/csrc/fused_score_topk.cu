// Fused negative-squared-L2 scan + first-occurrence top-k, with an optional
// epilogue that gathers the winners' rows.
//
// Replaces src/repro/kernels/fused_score_topk.py::score_topk (the plain
// variant `_kernel`, at fp32 and bf16 storage, the int8 variant
// `_scaled_kernel`, and the filtered variants `_masked_kernel` (fp32, bf16)
// and `_masked_scaled_kernel` (int8)) and ::score_topk_rows (`_rows_kernel`
// at every storage dtype), Pallas kernels for the TPU; and, with the
// template flag B5, the filtered variant of
// src/repro/kernels/ivf_score.py::ivf_score_topk_dedup (its `mask=`,
// `_dedup_kernel` / `_dedup_scaled_kernel` over valid * mask).
//
// Rows are stored as fp32, bf16 or int8 codes (the storage ladder), with an
// optional per-row fp32 scale (int8). Scores are
// ((2 * <q, x>) * scale - ||x||^2) - ||q||^2 in IEEE fp32, the TPU kernels'
// order: the scale multiplies the dot product's output, never the rows, so
// a missing scale (1.0) changes nothing. Results are ordered by (score desc,
// id asc), the TPU kernel's first-occurrence rule (better() in
// topk_common.cuh), so equal scores keep the smaller corpus id.
//
// Dot products on the tensor cores, at fp32-level accuracy. A block has
// two consumer warpgroups and a producer warpgroup. Each consumer
// warpgroup multiplies 64 corpus rows of a 128-row tile, the A operand of
// wgmma (sm_90a, wgmma_rs.cuh), taken from registers, by the
// block's query tile (BQ of 8..64 queries), the B operand, resident in
// shared memory for every column of the row (for rows too wide for that,
// staged a column chunk at a time, alternating between two buffers):
//   * fp32 rows: 3xTF32. Each value is split as it is loaded into registers
//     (hi = tf32(x), lo = tf32(x - hi), both rounded to nearest), the
//     queries once per block the same way, and the dot product is
//     x_lo q_hi + x_hi q_lo + x_hi q_hi. hi + lo carries
//     about 22 significant bits and the dropped x_lo q_lo term is about
//     2^-22 of the product, so each product is off by about 2^-21 of itself:
//     the size of fp32's own rounding of a sum of products, far inside the
//     scan's tolerance (rtol 1e-5 / atol 1e-4), where a single TF32 product
//     (2^-11) is not. tests/test_torch_split_precision.py holds an
//     emulation of the split against fp64.
//   * bf16 and int8 rows are exact in bf16 (int8 codes are integers of at
//     most 8 bits), so the rows enter the bf16 products at their stored
//     width (int8 pairs widened to bf16 pairs in registers), and the query
//     is split into three bf16 terms (about 24 bits): x q2 + x q1 + x q0.
// The MMA sums each k-step's products from zero (fp32 accumulators), and
// the k-steps are added in fp32 in registers: the tensor cores' own
// accumulation does not round to nearest, and its error grows with the
// terms it adds (over one sum at d=128, chip_smoke.py phase 3f saw an
// error of 7.2e-4 on scores near -56, past the tolerance where 2 <q, x>
// and the norms cancel). On the serving corpus (norms about 250-440),
// sums of four k-steps left a score up to 0.87 of its slot's L2
// tolerance from the fp64 score and up to 1.2 from the plain version's;
// sums of one k-step, 0.64 and 0.67 (scripts/scan_accuracy.py --corpus).
// Scale, ||x||^2 and ||q||^2 are applied in the epilogue, in the order
// above. The K order of the MMA is a fixed permutation of the columns (so
// one 16-byte shared-memory load feeds two or four k-steps), applied to
// rows and queries alike; a score therefore depends on its row and query
// alone, never on the tile, the chunk or the path: B3's (vals, ids) equal
// B2's and the selection path's equal the buffered path's, bit for bit.
//
// Bound on the H100 at the main path's shapes (64 queries, 1,000,000 x 128
// rows): bytes at every stored type, fp32 rows 516 MB (0.154 ms at 3.35
// TB/s), bf16 rows 258 MB (0.077 ms), int8 codes with their scales and
// norms 136 MB (0.041 ms), against the function's 16.4 GFLOP of
// multiply-adds (0.033 ms at 495 TFLOP/s of TF32, 0.017 ms at 989 of
// bf16). The split costs three products a multiply-add (0.099 ms of TF32,
// 0.050 ms of bf16): the kernel's own work, past int8's bytes bound, so
// int8 rows cannot reach their bound through this split.
// The design reads the corpus once per batch of up to 64 queries (the
// planner halves the tile only where kk's buffers need the room). Tiles
// come through a ring of 3-4 slots of 128 rows x 128 bytes, their 16-byte
// chunks swizzled (chunk j of row r at j ^ (r % 8)) so the eight rows a
// fragment load reads fall on distinct banks. The producer warpgroup
// refills a slot once every consumer warp has read it (the slot's "empty"
// mbarrier): its first thread has the copy engine load a whole tile of the
// corpus (one 2-D tensor map with the 128-byte swizzle, completing on the
// slot's "full" mbarrier); for the masked and sampled scans its 128
// threads gather the rows by id through cp.async into the same layout,
// arriving on the same barrier; rows whose width or base is no multiple of
// 16 bytes it loads and stores itself. The consumers wait on the full
// barrier and meet at a named barrier only where a tile begins. What holds
// it back (PERF.md): a warpgroup's MMAs keep its warps until the tensor
// cores have taken their register operands, and ptxas serializes the fp32
// buffered kernels' MMAs (C7520), so the epilogue overlaps them only in
// part.
//
// Top-k without block-wide sorts. The buffered path first scores an even
// sample of the rows (up to 16,384, an eighth at most) and takes each
// query's kk-th best of it as the query's starting threshold: every row of
// the true top-kk is at or above it, and a chunk then admits a few dozen
// candidates a query in place of several hundred. Each score is compared
// with its query's threshold in registers, where the MMA leaves it; the few
// that beat it are appended to the query's buffer in shared memory (an
// atomic slot; a tile's overflow past the buffer goes to a device spill
// area). After a tile, the buffers holding more than cap - kMargin entries,
// and only those, are cut back to kk by the warp that owns the query (query
// qi belongs to warp qi % 8): a radix select of the kk-th packed
// (score, ~id) word by warp histograms of 8-bit digits, from the highest
// bit on which the buffer's words differ, then an order-keeping compaction,
// with __syncwarp only. The consumers' barrier where a tile begins makes
// the cut's decision theirs alike; a second one follows a tile that filled
// a buffer, fencing the cuts from the next appends.
//
// Masked variants (the filter algebra's mask plan) read the eligible rows
// only: the wrapper builds their ascending ids once per call on the card
// (a prefix sum, no host synchronisation), the kernel reads their count
// from device memory, splits them evenly across the chunks, and gathers
// those rows by id, so its time follows the eligible rows. With fewer than
// kk eligible rows the unfilled slots read (-inf, id 0).
//
// B5 mask= (kernels/ivf_score.py routes it here): the IVF mask and routed
// plans' masked dedup scan is this masked scan over the eligible slots of
// the grouped slab viewed as (nlist * max_list, d) rows (the slots of a
// source with a member query and valid * mask > 0.5, in flat-id order,
// built on the card by ivf_score.cu's fcvi_ivf_masked_slots), with B5's
// epilogue under the template flag B5: (2 <x, q>) * scale - ||x||^2 with
// no -||q||^2 term, and -inf for a query whose member bit of the slot's
// list is clear (each row reads its list's 64-query word of member bits),
// so any member matrix whose live sources are distinct lists gives B5's
// function. Ids are flat slot ids, ordered by (score desc, flat id asc),
// B5's order over an ascending uniq.
// The list scan of ivf_score.cu restaged each list's rows for every four
// member queries and merged one partial per (list, query); here the
// eligible rows are read once per 64 queries, on the tensor cores.
//
// Passes:
//   the sample pass (scan_kernel on the selection path's epilogue, over
//     the sample) and threshold_kernel, on the buffered path of a corpus
//     of at least 8 kk rows;
//   pass 1 (scan_kernel): one block per (query tile, corpus chunk); each
//     writes its chunk's candidates per query (at most kk, unordered) to
//     scratch;
//   pass 2 (merge_kernel): one block per query merges the chunks' lists
//     with the same cut (each warp streams a share into its own buffer,
//     warp 0 cuts their union to kk), sorts the kk best once and writes
//     them. The rows variant then gathers each winner's corpus row and
//     payload rows by id: a gather is what the TPU kernel's one-hot
//     matmuls (pick_rows) stood in for.
// The selection path, for a kk whose buffers do not fit in shared memory or
// would shrink the query tile below 16 for a larger batch (the planner's
// choice; a caller may force either path): pass 1 writes every score to a
// (nq, n) scratch instead (the masked scan: its eligible rows, in order),
// and the multi-block radix select of select_common.cuh (its passes over
// (query, chunk), then select_kernel, one block per query) selects and
// sorts the top-kk with -0.0 and +0.0 taken as equal, as better() takes
// them.
//
// The ragged corpus edge and the ragged query tile are masked inside the
// kernels, so the caller never pads (and never copies) the corpus.
#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

#include "select_common.cuh"
#include "topk_common.cuh"
#include "wgmma_rs.cuh"

namespace {

constexpr int kWarps = 8;            // pass 1: two consumer warpgroups,
constexpr int kConsumers = 32 * kWarps;
constexpr int kProducers = 128;      // and a producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRows = 128;           // corpus rows a tile: 64 a warpgroup
constexpr int kMaxStages = 4;        // most slots of the staging ring
constexpr int kGroup = 1;            // k-steps an MMA sum runs before an add
constexpr int kMargin = 16;          // a buffer past cap - kMargin is cut
constexpr int kSpill = kRows;        // spill slots per (block, query)
constexpr int kMergeThreads = 256;   // pass 2
// the optional profile's slots: thread 0's cycles by phase, then counts
enum : int { kStatWait, kStatCut, kStatIssue, kStatLoad, kStatMma,
             kStatEpilogue, kStatCuts, kStatAdmitted, kStatSlots };

// Per stored type: bytes a value, and the columns a stage holds: 128 bytes
// of a row (32 fp32, 64 bf16 or 128 int8 values), past d zero-filled. A
// staged row takes 128 bytes, its 16-byte chunks swizzled (chunk j of row r
// at j ^ (r % 8)), the layout of the copy engine's 128-byte swizzle, so the
// eight rows one fragment load reads fall on distinct banks.
__host__ __device__ constexpr int elem_bytes(int et) {
  return et == kF32 ? 4 : et == kBF16 ? 2 : 1;
}

__host__ __device__ constexpr int stage_cols(int et) {
  return 128 / elem_bytes(et);
}

constexpr int kStageBytes = kRows * 128;

__host__ __device__ constexpr int op_terms(int et) {
  return et == kF32 ? 2 : 3;
}

__host__ __device__ constexpr int op_bytes(int et) {
  return et == kF32 ? 4 : 2;
}

// Pass 1's dynamic shared memory: the staging ring (1024-byte aligned, for
// the swizzle), the query operand (every term of every column chunk, or,
// with qstream, of two chunks: rows too wide for the whole operand), the
// candidate buffers (cap entries a query; none on the selection path), the
// warps' digit histograms, the per-query state, the cut flags and the
// ring's barriers.
__host__ __device__ inline size_t scan_smem(int bq, int cap, int d, int et,
                                            int stages, bool qstream) {
  const int kc = stage_cols(et);
  const size_t nchd = qstream ? 2 : (d + kc - 1) / kc;
  const size_t qop = (size_t)op_terms(et) * bq * nchd * kc * op_bytes(et);
  const size_t ring = (size_t)stages * kStageBytes;
  return qop + ring + 8 * (size_t)bq * cap + 4 * 256 * kWarps +
         16 * (size_t)bq + 16 + 16 * kMaxStages;
}

// a barrier of the consumer warps alone (the producer warp may have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

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

// one (128 rows x 128 bytes) box of the row matrix at (column c0, row r0),
// swizzled, rows and columns past the matrix zero-filled, completing on bar
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

// fp32 rounded to the nearest tf32, ties away from zero (cvt.rna's
// rounding, in two integer operations): its low 13 bits 0
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// fp32 rounded to nearest-even bf16 (finite values)
__device__ __forceinline__ unsigned short bf16_rn(float v) {
  const unsigned b = __float_as_uint(v);
  return (unsigned short)((b + 0x7fffu + ((b >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float bf16_val(unsigned short h) {
  return __uint_as_float((unsigned)h << 16);
}

// two int8 codes (the lower byte first) as a bf16 pair: exact
__device__ __forceinline__ unsigned i8x2_bf16x2(unsigned v) {
  const float lo = (float)(int)(signed char)(v & 0xffu);
  const float hi = (float)(int)(signed char)((v >> 8) & 0xffu);
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

// The MMA's K order. A thread of row group g, lane quarter t reads one
// 16-byte word of its row per load: fp32 columns 16s'+4t..+3 feed k-steps
// 2s' and 2s'+1, bf16 columns 32s'+8t..+7 the same two steps, int8 columns
// 64s''+16t..+15 steps 4s''..4s''+3. The query operand stores each column
// where the MMA pairs it with that row value. Returns the byte offset,
// within one term, of query nn's column cc of column chunk c: core matrix
// (2 * step + half) of the chunk, query row nn, position in the 16 bytes.
template <int ET>
__device__ __forceinline__ int qop_offset(int c, int cc, int nn, int kcj,
                                          int bq) {
  int s, j, pos;
  if (ET == kF32) {          // cc = 16s' + 4t + 2h + j, k = t + 4j
    s = 2 * (cc >> 4) + ((cc >> 1) & 1);
    j = cc & 1;
    pos = 4 * ((cc >> 2) & 3);
  } else if (ET == kBF16) {  // cc = 32s' + 8t + 4h + 2j + e, k = 2t+e+8j
    s = 2 * (cc >> 5) + ((cc >> 2) & 1);
    j = (cc >> 1) & 1;
    pos = 2 * (2 * ((cc >> 3) & 3) + (cc & 1));
  } else {                   // cc = 64s'' + 16t + 4h + 2j + e
    s = 4 * (cc >> 6) + ((cc >> 2) & 3);
    j = (cc >> 1) & 1;
    pos = 2 * (2 * ((cc >> 4) & 3) + (cc & 1));
  }
  return ((c * kcj + 2 * s + j) * bq + nn) * 16 + pos;
}

__device__ __forceinline__ u64 word_of(float s, int id) {
  return pack(ord_bits_eq0(s), id);
}

// Candidate e of one query: its buffer below cap, its spill slots past it.
struct Cands {
  float* bs;
  int* bi;
  const float* ss;
  const int* si;
  int cap;
  __device__ __forceinline__ void get(int e, float* s, int* id) const {
    if (e < cap) {
      *s = bs[e];
      *id = bi[e];
    } else {
      *s = ss[e - cap];
      *id = si[e - cap];
    }
  }
};

// One warp keeps the kk best of a query's cnt (> kk) candidates, in their
// order, in bs/bi[0..kk) and returns the kk-th best packed word: a radix
// select of 8-bit digits from the highest bit on which the words differ
// (the words are unique: each carries its row id), stopping once the chosen
// bin holds exactly the words still wanted, then a compaction. hist is the
// warp's own 256 counters. Every lane of the warp calls it.
__device__ __forceinline__ u64 warp_cut(const Cands& c, int cnt, int kk,
                                         unsigned* hist) {
  const int lane = threadIdx.x & 31;
  float s0;
  int i0;
  c.get(0, &s0, &i0);
  const u64 w0 = word_of(s0, i0);
  // the entries in rounds of 8 a lane, every load of a round issued first
  auto words = [&](int base, u64 (&w)[8], bool (&in)[8]) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + 32 * u + lane;
      in[u] = e < cnt;
      float s = 0.f;
      int id = 0;
      if (in[u]) c.get(e, &s, &id);
      w[u] = word_of(s, id);
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
    float s[8];
    int id[8];
    bool keep[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = base + 32 * u + lane;
      keep[u] = false;
      if (e < cnt) {
        c.get(e, &s[u], &id[u]);
        const u64 w = word_of(s[u], id[u]);
        keep[u] = (w & fixed) >= prefix;
        if (keep[u] && w < least) least = w;
      }
    }
    __syncwarp();   // this round's entries are read before any is written
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned b = __ballot_sync(0xffffffffu, keep[u]);
      if (keep[u]) {
        const int p = out + __popc(b & ((1u << lane) - 1u));
        c.bs[p] = s[u];
        c.bi[p] = id[u];
      }
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

// Pass 1's operands. The rows it scans are virtual indices v < count: the
// corpus rows (count = n), the eligible rows elig[v] (count = *n_elig), or
// with sample > 0 an even sample of either (count = min(sample, total / 8)
// rows at positions v * total / count, distinct).
struct ScanArgs {
  const void* x;
  const float* xsq;
  const float* scale;     // null: 1.0
  const int* elig;        // null: every row
  const int* n_elig;
  const u64* mbits;       // B5: (lists, mwords) member bits; null: not B5
  int mwords;
  int mlist;              // B5: rows a list (row r is in list r / mlist)
  const float* q;
  long long n;
  int nq, d, kk, cap;     // cap 0 on the selection path
  long long chunk_rows;   // rows a chunk (unmasked, unsampled)
  float* part_s;          // buffered: (nq, nchunks * kk) list slots
  int* part_i;
  int* part_n;            // (nq,) live entries in them, zeroed
  float* spill_s;         // (blocks, BQ, kSpill) overflow slots
  int* spill_i;
  float* sel;             // selection: (nq, sel_ld) scores, not null
  long long sel_ld;
  long long sample;
  const float* thr0_s;    // null, or (nq,) starting thresholds
  const int* thr0_i;
  u64* stats;             // null, or the optional profile
  int tma;                // the kernel's map describes the rows (row_map)
  int qstream;            // the query operand staged a chunk at a time
  int stages;             // slots of the staging ring, 3..kMaxStages
};

// Pass 1 (see the header). BQ queries a block (the MMA's N); SEL: the
// selection path (scores to a.sel), else the buffered one; B5: the IVF
// masked scan's epilogue (no -||q||^2 term; -inf where the row's list has
// the query's member bit clear), over the eligible slots of a flattened
// grouped slab.
template <int ET, int BQ, bool SEL, bool B5>
__global__ void __launch_bounds__(kThreads, 1)
scan_kernel(const ScanArgs a, const __grid_constant__ CUtensorMap map) {
  using T = typename Elem<ET>::T;
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const float* __restrict__ xsq = a.xsq;
  const float* __restrict__ scale = a.scale;
  const int* __restrict__ elig = a.elig;
  const float* __restrict__ q = a.q;
  const long long n = a.n;
  const int nq = a.nq, d = a.d, kk = a.kk, cap = a.cap;
  float* __restrict__ sel = a.sel;
  float* __restrict__ spill_s = a.spill_s;
  int* __restrict__ spill_i = a.spill_i;
  u64* __restrict__ stats = a.stats;
  constexpr int ES = sizeof(T);
  constexpr int STEP_K = ET == kF32 ? 8 : 16;      // K of one MMA
  constexpr int PER_LOAD = ET == kI8 ? 4 : 2;      // k-steps a load feeds
  constexpr int KSTEPS = 128 / ES / STEP_K;        // most a stage
  constexpr int R = BQ / 2;                        // accumulators a thread
  extern __shared__ __align__(1024) unsigned char scan_buf[];
  constexpr int kc = stage_cols(ET);
  const int nchd = (d + kc - 1) / kc;
  constexpr int kcj = kc * op_bytes(ET) / 16;      // core columns a chunk
  const bool qstream = a.qstream;
  // bytes of one term of the resident operand: every chunk, or one
  const int term_bytes = (qstream ? 1 : nchd) * kcj * BQ * 16;
  unsigned char* ring = scan_buf;
  const int stages = a.stages;
  unsigned char* qop = ring + stages * kStageBytes;
  float* bs = reinterpret_cast<float*>(qop + (qstream ? 2 : 1) *
                                                 op_terms(ET) * term_bytes);
  int* bi = reinterpret_cast<int*>(bs + BQ * cap);
  unsigned* hist = reinterpret_cast<unsigned*>(bi + BQ * cap);
  float* qsq_s = reinterpret_cast<float*>(hist + 256 * kWarps);
  float* thr_s = qsq_s + BQ;
  int* thr_i = reinterpret_cast<int*>(thr_s + BQ);
  int* cnt = thr_i + BQ;
  int* flag = cnt + BQ;                            // (2,) by tile parity
  u64* full = reinterpret_cast<u64*>(flag + 4);    // (stages,), 8-aligned
  u64* empty = full + kMaxStages;                  // (stages,)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int q0 = blockIdx.x * BQ;
  constexpr bool select = SEL;   // the selection path: sel not null
  const bool masked = elig != nullptr;
  const bool sampled = a.sample > 0;
  const long long total = masked ? (long long)*a.n_elig : n;
  long long count = total;
  if (sampled) count = a.sample < total / 8 ? a.sample : total / 8;
  long long per = a.chunk_rows;
  if (masked || sampled) {   // the rows known on the card split evenly
    per = (count + gridDim.y - 1) / gridDim.y;
    per = (per + kRows - 1) / kRows * kRows;
  }
  // the position among the rows (or eligible rows) of virtual index v,
  // and its corpus row
  auto pos_of = [&](long long v) -> long long {
    return sampled ? v * total / count : v;
  };
  auto row_of = [&](long long v) -> long long {
    const long long p = pos_of(v);
    return masked ? (long long)elig[p] : p;
  };
  const long long r_begin = (long long)blockIdx.y * per;
  const long long r_end = r_begin + per < count ? r_begin + per : count;
  const long long spill0 =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * BQ * kSpill;

  // the query operand of column chunks [c0, c1) at base, every term, in the
  // MMA's K order, zero past d and past nq; slot c - c0 of base's chunks
  auto stage_q = [&](unsigned char* base, int c0, int c1, int nthreads) {
    const int wq = (c1 - c0) * kc;
    for (int i = tid; i < BQ * wq; i += nthreads) {
      const int nn = i / wq;
      const int cw = i - nn * wq;
      const int col = c0 * kc + cw;
      const float v = (q0 + nn < nq && col < d)
                          ? q[(long long)(q0 + nn) * d + col]
                          : 0.f;
      unsigned char* at =
          base + qop_offset<ET>(cw / kc, cw % kc, nn, kcj, BQ);
      if constexpr (ET == kF32) {
        const unsigned hi = tf32_rna(v);
        *reinterpret_cast<unsigned*>(at) = hi;
        *reinterpret_cast<unsigned*>(at + term_bytes) =
            tf32_rna(v - __uint_as_float(hi));
      } else {
        const unsigned short t0 = bf16_rn(v);
        const float r1 = v - bf16_val(t0);
        const unsigned short t1 = bf16_rn(r1);
        *reinterpret_cast<unsigned short*>(at) = t0;
        *reinterpret_cast<unsigned short*>(at + term_bytes) = t1;
        *reinterpret_cast<unsigned short*>(at + 2 * term_bytes) =
            bf16_rn(r1 - bf16_val(t1));
      }
    }
  };
  // with qstream, unit u's chunk sits in qop_of(u), the two alternating
  const int qbuf_bytes = op_terms(ET) * term_bytes;
  auto qop_of = [&](int u) { return qop + (u & 1) * qbuf_bytes; };
  if (qstream)
    stage_q(qop, 0, 1, kThreads);
  else
    stage_q(qop, 0, nchd, kThreads);
  if (tid < BQ) {
    // ||q||^2 over the full width, in column order
    float acc = 0.f;
    if (q0 + tid < nq) {
      const float* qr = q + (long long)(q0 + tid) * d;
#pragma unroll 16
      for (int c = 0; c < d; ++c) acc = fmaf(qr[c], qr[c], acc);
    }
    qsq_s[tid] = acc;
    const bool seed = a.thr0_s != nullptr && q0 + tid < nq;
    thr_s[tid] = seed ? a.thr0_s[q0 + tid] : -INFINITY;
    thr_i[tid] = seed ? a.thr0_i[q0 + tid] : -1;
    cnt[tid] = 0;
  }
  if (tid < 2) flag[tid] = 0;
  // the copy engine stages whole tiles of the corpus's rows; gathered rows
  // (masked, sampled) go through the load units, each producer thread
  // arriving once its copies land; rows whose width or base is no multiple
  // of 16 bytes are loaded and stored by the producers, which then arrive.
  // A slot is empty again once each consumer warp has read it.
  const bool tma = a.tma && !masked && !sampled;
  if (tid < stages) {
    mbar_init(full + tid, tma ? 1 : kProducers);
    mbar_init(empty + tid, kWarps);
  }
  // the MMAs read the query operand through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const long long span = r_end > r_begin ? r_end - r_begin : 0;
  const int ntiles = (int)((span + kRows - 1) / kRows);
  const int units = ntiles * nchd;                 // (tile, column chunk)
  const bool vec = (d * ES) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // byte offset of 16-byte chunk j of staged row r
  auto staged = [](int r, int j) { return r * 128 + ((j ^ (r & 7)) << 4); };

  // The producer warp stages unit u (tile u / nchd, column chunk u % nchd)
  // into its ring slot and arrives on the slot's full barrier: rows past
  // the tile and columns past d read 0.
  auto issue = [&](int u) {
    if (u >= units) return;
    const int tile = u / nchd;
    const int c0 = (u - tile * nchd) * kc;
    const long long t0 = r_begin + (long long)tile * kRows;
    const int rows = (int)(r_end - t0 < kRows ? r_end - t0 : kRows);
    const int slot = u % stages;
    unsigned char* dst = ring + slot * kStageBytes;
    if (tma) {
      if (tid == kConsumers) {
        mbar_expect(full + slot, kStageBytes);
        tensor_copy(dst, &map, c0, (int)t0, full + slot);
      }
    } else if (vec) {
      constexpr int kPieces = kRows * 8;   // 16-byte chunks a stage
      for (int i = tid - kConsumers; i < kPieces; i += kProducers) {
        const int r = i >> 3;
        const int j = i & 7;
        const int col = c0 + j * (16 / ES);
        const bool ok = r < rows && col < d;
        const T* src = ok ? x + row_of(t0 + r) * d + col : x;
        cp_async_16(dst + staged(r, j), src, ok ? 16 : 0);
      }
      cp_async_arrive(full + slot);
    } else {
      for (int i = tid - kConsumers; i < kRows * kc; i += kProducers) {
        const int r = i / kc;
        const int cc = i - r * kc;
        T v = 0;
        if (r < rows && c0 + cc < d) v = x[row_of(t0 + r) * d + c0 + cc];
        *reinterpret_cast<T*>(dst + staged(r, cc * ES / 16) +
                              (cc * ES) % 16) = v;
      }
      mbar_arrive(full + slot);
    }
  };

  // cut every buffer the last tile filled past cap - kMargin, each by the
  // warp that owns its query
  auto cut_full = [&]() {
    for (int qi = warp; qi < BQ; qi += kWarps) {
      const int c = cnt[qi];
      if (c <= cap - kMargin) continue;
      const Cands cand{bs + qi * cap, bi + qi * cap,
                       spill_s + spill0 + qi * kSpill,
                       spill_i + spill0 + qi * kSpill, cap};
      const u64 w = warp_cut(cand, c, kk, hist + 256 * warp);
      if (lane == 0) {
        if (stats != nullptr) atomicAdd(stats + kStatCuts, 1ull);
        cnt[qi] = kk;
        thr_s[qi] = from_ord((unsigned)(w >> 32));
        thr_i[qi] = key_of(w);
      }
      __syncwarp();
    }
  };

  float acc[R], part[R];   // the tile's dot products; one group's
  // the row data of the tile whose epilogue is next: its rows 16 warp + g
  // and + 8 (corpus id, virtual index, ||x||^2, scale)
  long long rid_r[2] = {0, 0}, col_r[2] = {0, 0};
  float xsq_r[2] = {0.f, 0.f}, sc_r[2] = {1.f, 1.f};
  u64 mw_r[2] = {0, 0};   // B5: the member bits of the row's list
  const unsigned lbo = BQ * 16, sbo = 128;
  auto tile_rows = [&](int t) {
    const long long t0 = r_begin + (long long)t * kRows;
    return (int)(r_end - t0 < kRows ? r_end - t0 : kRows);
  };
  auto load_rows = [&](int t) {
    const long long t0 = r_begin + (long long)t * kRows;
    const int rows = tile_rows(t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      if (r < rows) {
        col_r[h] = t0 + r;
        rid_r[h] = row_of(t0 + r);
        xsq_r[h] = xsq[rid_r[h]];
        sc_r[h] = scale != nullptr ? scale[rid_r[h]] : 1.f;
        if constexpr (B5)
          mw_r[h] = a.mbits[(rid_r[h] / a.mlist) * a.mwords + (q0 >> 6)];
      }
    }
  };

  // optional profile (stats not null): thread 0's cycles by phase, the
  // cuts and the admitted candidates, summed over blocks
  long long clk = stats != nullptr ? clock64() : 0;
  u64 admitted = 0;
  auto lap = [&](int phase) {
    if (stats != nullptr && tid == 0) {
      const long long now = clock64();
      atomicAdd(stats + phase, (u64)(now - clk));
      clk = now;
    }
  };

  // tile t's scores from its accumulators: accumulator k = 4j + 2h + e is
  // row 16 warp + g + 8h, query 8j + 2 tq + e. The selection path stores
  // them; the buffered path compares each with its query's threshold and
  // appends the few that beat it (a rolled loop over their bits).
  auto epilogue = [&](int t, const float (&ac)[R]) {
    const int rows = tile_rows(t);
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) live[h] = 16 * warp + g + 8 * h < rows;
    float sc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int h = (k >> 1) & 1;
      const int qi = 8 * (k >> 2) + 2 * tq + (k & 1);
      if constexpr (B5) {   // B5's (2 <x, q>) scale - ||x||^2, members only
        sc[k] = __fsub_rn(__fmul_rn(__fmul_rn(2.f, ac[k]), sc_r[h]),
                          xsq_r[h]);
        if (!((mw_r[h] >> ((q0 & 63) + qi)) & 1ull)) sc[k] = -INFINITY;
      } else {
        sc[k] = __fsub_rn(
            __fsub_rn(__fmul_rn(__fmul_rn(2.f, ac[k]), sc_r[h]), xsq_r[h]),
            qsq_s[qi]);
      }
    }
    if constexpr (SEL) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int h = (k >> 1) & 1;
        const int qi = 8 * (k >> 2) + 2 * tq + (k & 1);
        if (q0 + qi < nq && live[h])
          sel[(long long)(q0 + qi) * a.sel_ld +
              (masked || sampled ? col_r[h] : rid_r[h])] = sc[k];
      }
    } else {
      unsigned hit = 0;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int h = (k >> 1) & 1;
        const int qi = 8 * (k >> 2) + 2 * tq + (k & 1);
        if (q0 + qi < nq && live[h] &&
            better(sc[k], (int)rid_r[h], thr_s[qi], thr_i[qi]))
          hit |= 1u << k;
      }
      while (hit) {
        const int k = __ffs(hit) - 1;
        hit &= hit - 1;
        float s = sc[0];
#pragma unroll
        for (int i = 1; i < R; ++i) s = k == i ? sc[i] : s;
        const int h = (k >> 1) & 1;
        const int qi = 8 * (k >> 2) + 2 * tq + (k & 1);
        const int rid = (int)(h ? rid_r[1] : rid_r[0]);
        ++admitted;
        const int pos = atomicAdd(&cnt[qi], 1);
        if (pos < cap) {
          bs[qi * cap + pos] = s;
          bi[qi * cap + pos] = rid;
        } else {
          spill_s[spill0 + qi * kSpill + pos - cap] = s;
          spill_i[spill0 + qi * kSpill + pos - cap] = rid;
        }
        if (pos >= cap - kMargin) flag[t & 1] = 1;
      }
      __syncwarp();   // reconverge before the next MMAs
    }
  };

  // tile t: its units' MMAs, then its epilogue
  auto tile_body = [&](int t) {
    // the consumers meet where a tile begins and cut the buffers that tile
    // t - 1's epilogue filled past the margin (its flag, by tile parity, is
    // read by every consumer before it is cleared; tile t's epilogue raises
    // the other one)
    if (!SEL && t >= 1) {
      consumers_sync();
      if (flag[(t - 1) & 1]) {
        cut_full();
        __syncwarp();
        consumers_sync();   // the cuts are done before more appends
        if (tid == 0) flag[(t - 1) & 1] = 0;
        lap(kStatCut);
      }
    }
    load_rows(t);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int c = 0; c < nchd; ++c) {
      const int u = t * nchd + c;
      // with qstream the consumers meet before every unit (the tile's
      // first on the buffered path met above): its query chunk is staged
      if (qstream && (c > 0 || (SEL && t >= 1))) consumers_sync();
      mbar_wait(full + u % stages, (u / stages) & 1);   // unit u is in
      lap(kStatWait);
      if (qstream && u + 1 < units) {
        // the next unit's query chunk, into the buffer unit u - 1 used
        const int cn = (u + 1) % nchd;
        stage_q(qop_of(u + 1), cn, cn + 1, kConsumers);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      lap(kStatIssue);

      // this thread's A fragments: rows 16 warp + g and + 8 of the tile,
      // 16-byte chunks 4l + tq (their swizzle is g, the row's low bits)
      const unsigned char* ra =
          ring + (u % stages) * kStageBytes + (16 * warp + g) * 128;
      const unsigned char* rb = ra + 8 * 128;
      constexpr int ksteps = kc / STEP_K;
      unsigned fa[KSTEPS][4];
      unsigned fl[ET == kF32 ? KSTEPS : 1][4];   // fp32: the lo parts
#pragma unroll
      for (int l = 0; l < KSTEPS / PER_LOAD; ++l) {
        if (l * PER_LOAD < ksteps) {
          const int off = ((4 * l + tq) ^ g) << 4;
          const uint4 va = *reinterpret_cast<const uint4*>(ra + off);
          const uint4 vb = *reinterpret_cast<const uint4*>(rb + off);
          const unsigned wa[4] = {va.x, va.y, va.z, va.w};
          const unsigned wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
          for (int h = 0; h < PER_LOAD; ++h) {
            const int s = l * PER_LOAD + h;
            if constexpr (ET == kF32) {
              const unsigned v[4] = {wa[2 * h], wb[2 * h], wa[2 * h + 1],
                                     wb[2 * h + 1]};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float xv = __uint_as_float(v[i]);
                fa[s][i] = tf32_rna(xv);
                fl[s][i] = tf32_rna(xv - __uint_as_float(fa[s][i]));
              }
            } else if constexpr (ET == kBF16) {
              fa[s][0] = wa[2 * h];
              fa[s][1] = wb[2 * h];
              fa[s][2] = wa[2 * h + 1];
              fa[s][3] = wb[2 * h + 1];
            } else {
              fa[s][0] = i8x2_bf16x2(wa[h] & 0xffffu);
              fa[s][1] = i8x2_bf16x2(wb[h] & 0xffffu);
              fa[s][2] = i8x2_bf16x2(wa[h] >> 16);
              fa[s][3] = i8x2_bf16x2(wb[h] >> 16);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + u % stages);   // the slot is read
      lap(kStatLoad);
      // groups of kGroup k-steps sum in the MMA from zero into part, and
      // part into acc with fp32 adds: the tensor cores' own accumulation
      // does not round to nearest, and its error grows with the terms it
      // adds, so each sum it forms stays short
#pragma unroll
      for (int g0 = 0; g0 < KSTEPS; g0 += kGroup) {
        if (g0 < ksteps) {
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int s = g0; s < g0 + kGroup; ++s) {
            const unsigned char* b =
                qstream ? qop_of(u) + 2 * s * BQ * 16
                        : qop + (c * kcj + 2 * s) * BQ * 16;
            const int keep = s > g0;   // the group's first MMA sets part
            if constexpr (ET == kF32) {   // x_lo q_hi + x_hi q_lo + x_hi q_hi
              mma_tf32(part, fl[s], smem_desc(b, lbo, sbo), keep);
              mma_tf32(part, fa[s], smem_desc(b + term_bytes, lbo, sbo), 1);
              mma_tf32(part, fa[s], smem_desc(b, lbo, sbo), 1);
            } else {                      // x q2 + x q1 + x q0
              mma_bf16(part, fa[s], smem_desc(b + 2 * term_bytes, lbo, sbo),
                       keep);
              mma_bf16(part, fa[s], smem_desc(b + term_bytes, lbo, sbo), 1);
              mma_bf16(part, fa[s], smem_desc(b, lbo, sbo), 1);
            }
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        }
      }
      lap(kStatMma);
    }
    epilogue(t, acc);
    lap(kStatEpilogue);
  };

  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();   // the operand, the state and the barriers are set
  if (warp >= kWarps) {   // the producers: each slot once its readers left
    for (int u = 0; u < units; ++u) {
      if (u >= stages)
        mbar_wait(empty + u % stages, ((u / stages) - 1) & 1);
      issue(u);
    }
    return;
  }
  for (int t = 0; t < ntiles; ++t) tile_body(t);
  if (stats != nullptr) atomicAdd(stats + kStatAdmitted, admitted);
  if (select) return;

  consumers_sync();   // the last tile's candidates are in
  // each query's list (at most kk, unordered) goes to the query's part of
  // the chunk lists at an atomic offset: pass 2 reads the live entries only
  const long long stride = (long long)gridDim.y * kk;
  for (int qi = warp; qi < BQ; qi += kWarps) {
    if (q0 + qi >= nq) continue;
    int c = cnt[qi];
    if (c > kk) {
      const Cands cand{bs + qi * cap, bi + qi * cap,
                       spill_s + spill0 + qi * kSpill,
                       spill_i + spill0 + qi * kSpill, cap};
      warp_cut(cand, c, kk, hist + 256 * warp);
      c = kk;
    }
    int at = 0;
    if (lane == 0 && c > 0) at = atomicAdd(a.part_n + q0 + qi, c);
    at = __shfl_sync(0xffffffffu, at, 0);
    const long long o = (long long)(q0 + qi) * stride + at;
    for (int j = lane; j < c; j += 32) {
      a.part_s[o + j] = bs[qi * cap + j];
      a.part_i[o + j] = bi[qi * cap + j];
    }
  }
}

// The rows epilogue of query qi, after its (vals, ids) are written and the
// block has synchronised: each winner's corpus row, dequantized (code *
// scale), and its payload rows, gathered by id (dead slots read id 0).
template <int ET>
__device__ void gather_rows(long long qi, int kk, const int* __restrict__ ids,
                            const typename Elem<ET>::T* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ pv,
                            const float* __restrict__ pf, int d, int dv,
                            int m, float* __restrict__ rows_x,
                            float* __restrict__ rows_v,
                            float* __restrict__ rows_f) {
  const int* row_ids = ids + qi * kk;
  for (long long i = threadIdx.x; i < (long long)kk * d; i += blockDim.x) {
    const long long j = i / d;
    const long long c = i - j * d;
    const long long id = row_ids[j];
    const float v = Elem<ET>::at(x, id * d + c);
    rows_x[qi * kk * d + i] = scale != nullptr ? __fmul_rn(v, scale[id]) : v;
  }
  for (long long i = threadIdx.x; i < (long long)kk * dv; i += blockDim.x) {
    const long long j = i / dv;
    rows_v[qi * kk * dv + i] = pv[(long long)row_ids[j] * dv + (i - j * dv)];
  }
  for (long long i = threadIdx.x; i < (long long)kk * m; i += blockDim.x) {
    const long long j = i / m;
    rows_f[qi * kk * m + i] = pf[(long long)row_ids[j] * m + (i - j * m)];
  }
}

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
// that does not compete), with the same cut as pass 1: each warp streams
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

// pass 2's source: one query's live chunk-list entries
struct PartEntries {
  const float* s;
  const int* id;
  __device__ bool get(long long e, float* v, int* k) const {
    *v = s[e];
    *k = id[e];
    return *v > -INFINITY;
  }
};

// Pass 2: one block per query merges the chunks' lists with the same cut,
// starting from the sample's threshold (thr0_s / thr0_i, null for none),
// sorts the kk best once, best first (topk_common.cuh's sort_segments),
// and writes them; unfilled slots (fewer than kk finite scores) read (-inf,
// id 0). The rows variant then gathers the winners' rows.
template <int ET>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             const int* __restrict__ part_n, long long stride, int kk,
             const float* __restrict__ thr0_s,
             const int* __restrict__ thr0_i, float* __restrict__ vals,
             int* __restrict__ ids, const typename Elem<ET>::T* __restrict__ x,
             const float* __restrict__ scale,
             const float* __restrict__ pv, const float* __restrict__ pf, int d,
             int dv, int m, float* __restrict__ rows_x,
             float* __restrict__ rows_v, float* __restrict__ rows_f) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  __shared__ float thr_s;
  __shared__ int thr_i;
  const int tid = threadIdx.x;
  const long long qi = blockIdx.x;
  const int count = stream_topk(
      PartEntries{part_s + qi * stride, part_i + qi * stride}, part_n[qi],
      kk,
      thr0_s != nullptr ? thr0_s[qi] : -INFINITY,
      thr0_s != nullptr ? thr0_i[qi] : -1, merge_smem, &thr_s, &thr_i);
  // warp 0's buffer holds the kk best: pad it to a power of two, sort once
  float* bs = reinterpret_cast<float*>(merge_smem);
  int* bi = reinterpret_cast<int*>(bs + stream_slots(kk));
  int len2 = 1;
  while (len2 < kk) len2 <<= 1;
  for (int j = count + tid; j < len2; j += kMergeThreads) {
    bs[j] = -INFINITY;
    bi[j] = INT_MAX;
  }
  __syncthreads();
  sort_segments(bs, bi, 1, len2);
  for (int j = tid; j < kk; j += kMergeThreads) {
    vals[qi * kk + j] = bs[j];
    ids[qi * kk + j] = bi[j] == INT_MAX ? 0 : bi[j];
  }
  if (rows_x == nullptr) return;
  __syncthreads();
  gather_rows<ET>(qi, kk, ids, x, scale, pv, pf, d, dv, m, rows_x, rows_v,
                  rows_f);
}

// The queries' scores in the selection path (query q's row at q * ld): a
// -inf or NaN score does not compete, as it never beats a buffer's
// threshold; -0.0 counts as +0.0. The count is n, or *n_elig (the masked
// scan's eligible rows, on the card). No segments: every entry is read.
struct FlatScores {
  const float* s;
  long long ld;
  long long n;
  const int* n_elig;
  __device__ long long size(int) const {
    return n_elig != nullptr ? (long long)*n_elig : n;
  }
  static constexpr bool kSegmented = false;
  __device__ const float* row(int q) const { return s + (long long)q * ld; }
  __device__ unsigned ord(float v) const {
    return v > -INFINITY ? ord_bits_eq0(v) : 0u;
  }
  __device__ int key(int, long long, long long e) const { return (int)e; }
};

// The selection path's finish: one block per query over its row of the
// (nq, n) score scratch (the masked scan's: its eligible rows, in order;
// elig maps their positions to row ids), after select_passes.
template <int ET>
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const SelectArgs sa, const float* __restrict__ sel,
              long long n, const int* __restrict__ elig,
              float* __restrict__ vals, int* __restrict__ ids,
              const typename Elem<ET>::T* __restrict__ x,
              const float* __restrict__ scale, const float* __restrict__ pv,
              const float* __restrict__ pf, int d, int dv, int m,
              float* __restrict__ rows_x, float* __restrict__ rows_v,
              float* __restrict__ rows_f) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  __shared__ FinishState fs;
  const long long qi = blockIdx.x;
  const int kk = sa.kk;
  u64* w;
  int* pos;
  sort_area(sa, (int)qi, sel_smem, &w, &pos);
  const float* s = sel + qi * n;
  const int count = select_finish(sa, (int)qi, w, pos, &fs);
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    vals[qi * kk + j] = j < count ? s[pos[j]] : -INFINITY;
    ids[qi * kk + j] =
        j < count ? (elig != nullptr ? elig[pos[j]] : pos[j]) : 0;
  }
  if (rows_x == nullptr) return;
  __syncthreads();
  gather_rows<ET>(qi, kk, ids, x, scale, pv, pf, d, dv, m, rows_x, rows_v,
                  rows_f);
}

// The selection path past pass 1: the passes, then the finish.
template <int ET>
cudaError_t select_topk(const SelectArgs& sa, const float* sel, long long n,
                        const int* elig, const int* n_elig, float* vals,
                        int* ids, const typename Elem<ET>::T* x,
                        const float* scale, const float* pv, const float* pf,
                        int d, int dv, int m, float* rows_x, float* rows_v,
                        float* rows_f, cudaStream_t st) {
  cudaError_t err = select_passes(FlatScores{sel, n, n, n_elig}, sa, st);
  if (err != cudaSuccess) return err;
  const size_t smem = select_smem(sa);
  err = cudaFuncSetAttribute(select_kernel<ET>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  select_kernel<ET><<<sa.nq, kSelThreads, smem, st>>>(
      sa, sel, n, elig, vals, ids, x, scale, pv, pf, d, dv, m, rows_x, rows_v,
      rows_f);
  return cudaGetLastError();
}

// the sample pass's scores of one query (ld apart), keyed by position
struct SampleScores {
  const float* s;
  __device__ bool get(long long e, float* v, int* k) const {
    *v = s[e];
    *k = (int)e;
    return *v > -INFINITY;
  }
};

// The buffered path's starting thresholds: one block per query finds the
// kk-th best (score, position) of the sample pass's scores with the same
// cut and stores it with the row's id raised by one, so that the scan
// admits that row too; -inf where the sample holds fewer than kk rows.
// Every row of the true top-kk is at or above the kk-th best of any
// subset, so the scan's lists still hold it.
__global__ void __launch_bounds__(kMergeThreads)
threshold_kernel(const float* __restrict__ sel, long long ld,
                 const int* __restrict__ elig, const int* __restrict__ n_elig,
                 long long n, long long sample, int kk,
                 float* __restrict__ thr_s, int* __restrict__ thr_i) {
  extern __shared__ __align__(16) unsigned char thr_smem[];
  __shared__ float ts;
  __shared__ int ti;
  const long long qi = blockIdx.x;
  const long long total = elig != nullptr ? (long long)*n_elig : n;
  const long long count = sample < total / 8 ? sample : total / 8;
  float out_s = -INFINITY;
  int out_i = -1;
  if (count >= kk) {   // the same for the whole block
    stream_topk(SampleScores{sel + qi * ld}, count, kk, -INFINITY, -1,
                thr_smem, &ts, &ti);
    if (ti >= 0) {
      const long long p = (long long)ti * total / count;
      out_s = ts;
      out_i = (elig != nullptr ? elig[p] : (int)p) + 1;
    }
  }
  if (threadIdx.x == 0) {
    thr_s[qi] = out_s;
    thr_i[qi] = out_i;
  }
}

template <int ET, int BQ, bool SEL, bool B5>
cudaError_t launch_scan(const ScanArgs& a, const CUtensorMap& map,
                        int nchunks, cudaStream_t st) {
  const size_t smem = scan_smem(BQ, a.cap, a.d, ET, a.stages, a.qstream);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<ET, BQ, SEL, B5>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + BQ - 1) / BQ, nchunks);
  scan_kernel<ET, BQ, SEL, B5><<<grid, kThreads, smem, st>>>(a, map);
  return cudaGetLastError();
}

template <int ET, int BQ, bool SEL>
cudaError_t launch_scan(const ScanArgs& a, const CUtensorMap& map,
                        int nchunks, cudaStream_t st) {
  return a.mbits != nullptr
             ? launch_scan<ET, BQ, SEL, true>(a, map, nchunks, st)
             : launch_scan<ET, BQ, SEL, false>(a, map, nchunks, st);
}

template <int ET, int BQ>
cudaError_t launch_scan(const ScanArgs& a, const CUtensorMap& map,
                        int nchunks, cudaStream_t st) {
  return a.sel != nullptr ? launch_scan<ET, BQ, true>(a, map, nchunks, st)
                          : launch_scan<ET, BQ, false>(a, map, nchunks, st);
}

template <int ET>
cudaError_t scan(const ScanArgs& a, const CUtensorMap& map, int bq,
                 int nchunks, cudaStream_t st) {
  switch (bq) {
    case 64: return launch_scan<ET, 64>(a, map, nchunks, st);
    case 32: return launch_scan<ET, 32>(a, map, nchunks, st);
    case 16: return launch_scan<ET, 16>(a, map, nchunks, st);
    case 8: return launch_scan<ET, 8>(a, map, nchunks, st);
    default: return cudaErrorInvalidValue;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Describes the (n, d) rows to the copy engine as (128-row x 128-byte)
// boxes with the 128-byte swizzle, setting *ok; rows whose width or base is
// no multiple of 16 bytes cannot be described (*ok false, no error).
cudaError_t row_map(CUtensorMap* map, const void* x, int et, long long n,
                    int d, bool* ok) {
  static EncodeTiled encode = nullptr;
  const int es = elem_bytes(et);
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
  const cuuint32_t box[2] = {(cuuint32_t)(128 / es), (cuuint32_t)kRows};
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

template <int ET>
int score_topk(ScanArgs a, int bq, int nchunks,
               float* sample_sel, float* thr0_s, int* thr0_i,
               const SelectArgs* sel_args, float* vals, int* ids,
               const float* pv, const float* pf, int dv, int m,
               float* rows_x, float* rows_v, float* rows_f, cudaStream_t st) {
  const auto* x = static_cast<const typename Elem<ET>::T*>(a.x);
  CUtensorMap map;
  bool ok = false;
  cudaError_t err = row_map(&map, a.x, ET, a.n, a.d, &ok);
  if (err != cudaSuccess) return (int)err;
  a.tma = ok;
  if (a.sel == nullptr && a.sample > 0) {
    // the sample pass: its scores, then each query's kk-th best of them
    ScanArgs sa = a;
    sa.cap = 0;
    sa.sel = sample_sel;
    sa.sel_ld = a.sample;
    sa.thr0_s = nullptr;
    sa.thr0_i = nullptr;
    sa.stats = nullptr;
    const long long tiles = (a.sample + kRows - 1) / kRows;
    err = scan<ET>(sa, map, bq, (int)(tiles < nchunks ? tiles : nchunks),
                   st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = stream_smem(a.kk);
    err = cudaFuncSetAttribute(threshold_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    threshold_kernel<<<a.nq, kMergeThreads, smem, st>>>(
        sample_sel, a.sample, a.elig, a.n_elig, a.n, a.sample, a.kk, thr0_s,
        thr0_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a.thr0_s = thr0_s;
    a.thr0_i = thr0_i;
  }
  a.sample = 0;
  if (a.sel != nullptr) a.cap = 0;
  err = scan<ET>(a, map, bq, nchunks, st);
  if (err != cudaSuccess) return (int)err;
  if (a.sel != nullptr)
    return (int)select_topk<ET>(*sel_args, a.sel, a.n, a.elig, a.n_elig,
                                vals, ids,
                                x, a.scale, pv, pf, a.d, dv, m, rows_x,
                                rows_v, rows_f, st);
  const size_t smem = stream_smem(a.kk);
  err = cudaFuncSetAttribute(merge_kernel<ET>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<ET><<<a.nq, kMergeThreads, smem, st>>>(
      a.part_s, a.part_i, a.part_n, (long long)nchunks * a.kk, a.kk,
      a.thr0_s, a.thr0_i, vals, ids, x, a.scale, pv, pf, a.d, dv, m, rows_x,
      rows_v, rows_f);
  return (int)cudaGetLastError();
}

}  // namespace

// et selects the stored element type of x (0 fp32, 1 bf16, 2 int8); scale
// (n,) is the per-row dequantization scale, null for 1.0. The masked
// variants pass elig, the ascending ids of the eligible rows, and n_elig,
// their count, both on the card (null for every row). B5 mask= (the IVF
// masked scan, x the grouped slab viewed as (nlist * max_list, d) rows)
// also passes mlist, the rows a list (max_list), and mbits (nlist,
// mwords), the lists' member bits (query j at bit j % 64 of word j / 64;
// fcvi_ivf_masked_slots builds both): scores lose the -||q||^2 term and
// read -inf for a query whose bit is clear; null mbits for the flat
// scans. bq is the query tile
// (64, 32, 16 or 8), stages the ring's slots (3..kMaxStages); qstream
// stages the query operand a column chunk at a time (rows too wide for all
// of it in shared memory).
// Buffered path (sel null): cap candidate slots a query in shared memory;
// spill_s / spill_i hold (nq rounded up to bq, nchunks, 128) overflow
// slots; part_s / part_i (nq, nchunks * kk) list slots, part_n (nq,) zeros
// that count their live entries. With sample > 0 a sample pass
// first scores up to `sample` evenly spaced rows into sample_sel (nq,
// sample) and sets each query's starting threshold in thr0_s / thr0_i
// (nq,); sample 0 leaves those three unused.
// Selection path (sel, an (nq, n) fp32 scratch, not null): cap,
// the spill and the sample are unused; sa holds the select's plan and
// scratch (select_common.cuh), null on the buffered path.
// The rows pointers (pv, pf, rows_x, rows_v, rows_f) are all null for the
// ids-only variant. stats, null but for profiling, takes kStatSlots sums.
extern "C" int fcvi_score_topk(
    const void* x, int et, const float* xsq, const float* scale,
    const int* elig, const int* n_elig, int mlist, const void* mbits,
    int mwords, const float* q, long long n, int nq,
    int d, int kk, int bq, int cap, int stages, int qstream, int nchunks,
    long long chunk_rows, float* part_s, int* part_i, int* part_n,
    float* spill_s,
    int* spill_i,
    long long sample, float* sample_sel, float* thr0_s, int* thr0_i,
    float* sel, const void* sel_args, float* vals,
    int* ids, const float* pv, const float* pf, int dv, int m, float* rows_x,
    float* rows_v, float* rows_f, u64* stats, void* stream) {
  if (nq <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (mbits != nullptr && (elig == nullptr || mlist <= 0))
    return (int)cudaErrorInvalidValue;
  ScanArgs a{x, xsq, scale, elig, n_elig, static_cast<const u64*>(mbits),
             mwords, mlist, q, n, nq, d, kk, cap, chunk_rows,
             part_s, part_i, part_n, spill_s, spill_i, sel, n, sample,
             nullptr, nullptr, stats, 0, qstream, stages};
  const SelectArgs* sa = static_cast<const SelectArgs*>(sel_args);
  if (sel != nullptr && sa == nullptr) return (int)cudaErrorInvalidValue;
#define FCVI_TOPK(ET)                                                       \
  score_topk<ET>(a, bq, nchunks, sample_sel, thr0_s, thr0_i, sa, vals,      \
                 ids, pv, pf, dv, m, rows_x, rows_v, rows_f, st)
  switch (et) {
    case kF32: return FCVI_TOPK(kF32);
    case kBF16: return FCVI_TOPK(kBF16);
    case kI8: return FCVI_TOPK(kI8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FCVI_TOPK
}

// The selection path's select alone over an (nq, n) fp32 score matrix:
// (vals, ids) (nq, kk) of each row's kk best scores, ranked as the scans
// rank them (score desc, column asc; -inf and NaN do not compete, unfilled
// slots read (-inf, 0); -0.0 counts as +0.0 and keeps its bits). The same
// kernels as the scans' selection path; sa as in fcvi_score_topk.
extern "C" int fcvi_select_topk(const float* scores, long long n,
                                const void* sel_args, float* vals, int* ids,
                                void* stream) {
  const SelectArgs* sa = static_cast<const SelectArgs*>(sel_args);
  if (sa == nullptr) return (int)cudaErrorInvalidValue;
  if (sa->nq <= 0) return (int)cudaSuccess;
  return (int)select_topk<kF32>(*sa, scores, n, nullptr, nullptr, vals, ids,
                                nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
                                nullptr, nullptr, nullptr,
                                (cudaStream_t)stream);
}
