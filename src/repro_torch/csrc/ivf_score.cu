// IVF list scans + first-occurrence top-k over the grouped slab layout, with
// an optional epilogue that gathers the winners' grouped payload rows.
//
// Replaces three Pallas kernels for the TPU, all in
// src/repro/kernels/ivf_score.py, each at every storage dtype:
//   * ivf_score_topk_dedup (`_dedup_kernel` for fp32 and bf16 slabs,
//     `_dedup_scaled_kernel` for int8): the probe-major scan of the batch's
//     unique probed lists, each query kept only on the lists it probed;
//   * ivf_score_topk_dedup_rows (`_dedup_rows_kernel`): the same (vals,
//     ids), plus the winners' payload_v / payload_f rows (dead slots carry
//     zero rows);
//   * ivf_score_topk_batch (`_batch_kernel`, `_batch_scaled_kernel`; and
//     ivf_score_topk, its batch-1 wrapper): the query-major scan over a
//     (b, nprobe) probe grid.
// B5's `mask=` (the filter algebra's masked dedup) is not scanned here: it
// runs on the flat scan of fused_score_topk.cu over the eligible slots only
// (kernels/ivf_score.py routes it), whose 64-query tile suits the mask
// plan's dense member matrix; the sparse members of the dedup, rows and
// batch scans keep these list scans.
//
// The grouped slab holds fp32, bf16 or int8 codes, with an optional
// per-slot fp32 scale (int8's grouped_scales). Scores are
// (2 * <x, q>) * scale - ||x||^2 in IEEE fp32, the TPU kernels' order: the
// dot product accumulates with fmaf in ascending column order over the
// stored values cast up (exactly) and the scale multiplies its output (1.0
// without scales; the ||q||^2 constant is left to the caller, as on the
// TPU), kept only where valid > 0.5 (and, for the dedup scan, member >
// 0.5). A score depends on its row and query alone, so the three scans, and
// the buffered and selection paths, give the same bits. A result id is the
// flat slot id list * max_list + slot. Order, as the TPU kernels' running
// top-k gives it:
//   * dedup: (score desc, flat id asc). The TPU grid walks the unique lists
//     in the order given and the slots in order; with the ascending `uniq`
//     that dedup_probes builds, first occurrence is the flat-id order.
//   * batch: (score desc, probe position asc, slot asc): the TPU grid walks
//     each query's probes in the caller's order (coarse-score order, not list
//     order). The kernels order by the key position * max_list + slot and
//     map it to the flat id at the end. A list probed twice by one query
//     competes twice, as in the reference.
// Slots that stay unfilled (fewer live candidates than kk) read as
// (-inf, id 0).
//
// Bound on the H100: bytes. At the IVF path's shapes (nlist 1024, about 977
// rows a list, d=128, b=64, nprobe=16) a batch probes about 606 unique
// lists, 1.7 member queries each: the scan reads their live rows once, 322
// MB at fp32 (0.096 ms at 3.35 TB/s), 165 MB at bf16 (0.049 ms), 89 MB of
// int8 codes with their scales and norms (0.027 ms), against 0.28 GFLOP of
// fp32 multiply-adds for the member pairs (4 us at 67 TFLOP/s).
//
// Design. The TPU kernel carries one running top-k across a sequential grid
// over the lists and scores all b queries against each list, masking the
// ones that did not probe it. Blocks on Hopper run in parallel with no
// carry, so there are two passes.
//
//   pass 1 (list_scan_kernel): one persistent block per SM takes work items
//     from an atomic counter until none is left. An item is one source (a
//     unique list with all its member queries for dedup, one query's probe
//     for batch); a list with more member queries than a pass holds (qp,
//     at most kQMax: a register each) is scanned once per qp of them. A
//     producer warp walks the items and keeps a ring of stages in flight
//     through full/empty mbarriers, across item boundaries: a stage is one
//     tile of kTileRows list rows x one 128-byte column chunk, in the stored
//     dtype, loaded by the copy engine as kBoxRows-row boxes of the slab
//     viewed as (nlist * max_list, d) rows (one 2-D tensor map, 128-byte
//     swizzle), a box only where one of its rows is valid, so a tile with no
//     valid row is never read and neither are the list's pad slots; beside
//     it, cp.async copies of the member queries' columns of the chunk (fp32)
//     and, with a tile's first chunk, its rows' norms and scales; the
//     stage's metadata says which item, tile, chunk and member queries it
//     holds. Rows whose width or base is no multiple of 16 bytes the
//     producer loads and stores itself. The eight consumer warps own a box
//     each, a thread a row: it widens its row's 16-byte words in registers
//     (bf16 by a shift, int8 by a byte permute and an exact subtract) and
//     accumulates one dot product per member query of the pass, so a list
//     with one member costs one query's multiply-adds and the slab is read
//     at its stored width. Scores past a query's admission threshold are
//     appended to the query's candidate buffer (a warp ballot, one shared
//     atomic a warp); after a tile, a buffer that may not hold the next one
//     is cut back to kk by the warp that owns the query (warp_cut,
//     ring_topk.cuh: a radix select, no block-wide sort), and the pass's end
//     cuts each to kk and writes it to kk entries of the query's partial
//     lists that the warp reserved (an atomic offset) where the pass began,
//     dead (-inf) past its count. A buffer is cut once it passes kk plus
//     half a tile, so a pass's threshold rises after its first tile. The
//     kk-th best word of every cut is also raised into a per-query word in
//     device memory (thr0); a pass over another list of the query starts
//     from it and takes up later raises a tile after they land, so most
//     tiles admit a few candidates: every row of the query's true top-kk is
//     at or above it.
//   pass 2 (list_merge_kernel): one block per query keeps the kk best of its
//     partial lists at or above its threshold word with the same cut
//     (stream_topk, ring_topk.cuh), sorts them once and writes them; the
//     rows variant then gathers each winner's payload rows by flat id, the
//     work the TPU kernel's one-hot copy-through (pick_rows) did.
//   What holds it back (PERF.md, scripts/profile_ivf.py): at fp32 the
//   copies; at bf16 and int8 the consumer warps, whose dot products are
//   one fmaf chain a (row, query) in column order (so every path gives the
//   same bits) with two operations a value to widen int8, and whose
//   admissions, cuts and pass ends take about as long again.
//
// The selection path, for a kk whose buffers do not fit in shared memory
// (or when the caller asks for it): pass 1 writes each (member query, list)
// pair's scores to a (b, nseg, max_list) scratch instead (nseg = s for
// dedup, nprobe for batch; -inf for invalid slots and tiles), and the
// multi-block radix select of select_common.cuh (its passes skip a query's
// non-member lists unread; then list_select_kernel, one block per query)
// selects and sorts the top-kk over its member lists' slots by (score,
// ordering key), -0.0 taken as +0.0 as better() takes it. Its (vals, ids)
// are the buffered path's bits; the rows epilogue is the same function.
#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "ring_topk.cuh"
#include "select_common.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;   // a block of the eligible-slot builders
constexpr int kWarps = kThreads / 32;

// Pass 1: a tile of kTileRows rows, one a consumer thread; a copy-engine box
// of kBoxRows rows a consumer warp; a producer warp beside them.
constexpr int kTileRows = 256;
constexpr int kBoxRows = 32;
constexpr int kBoxes = kTileRows / kBoxRows;      // consumer warps
constexpr int kConsumers = 32 * kBoxes;
constexpr int kScanThreads = kConsumers + 32;
constexpr int kQMax = 8;                          // member queries a pass
static_assert(kQMax <= kBoxes, "a consumer warp owns one query slot");
constexpr int kBoxBytes = kBoxRows * 128;
constexpr int kRowBytes = kTileRows * 128;        // a stage's rows
constexpr int kMaxStages = 6;
enum : int { kData = 0, kEmpty = 1, kEnd = 2, kExit = 3 };
// the optional profile's slots, summed over blocks: consumer thread 0's
// cycles by phase and the producer's, then counts
enum : int { kLsWait, kLsCompute, kLsEpilogue, kLsCut, kLsEnd, kLsProdWait,
             kLsProdItem, kLsCuts, kLsAdmitted, kLsTiles, kLsPasses,
             kLsSlots };

__host__ __device__ constexpr int elem_size(int et) {
  return et == kF32 ? 4 : et == kBF16 ? 2 : 1;
}

// What a stage holds, written by the producer before it arrives. kData: the
// rows of tile t0 (valid[w], the valid bits of box w's rows, 0 past the
// list; a box with none was not loaded) at column chunk `chunk`; kEmpty
// (selection path): a tile with no valid row, not loaded; kEnd: the pass's
// last tile is in; kExit: no item is left. thr: each member query's
// threshold word when the pass began (0: none).
struct StageMeta {
  int kind, list, t0, chunk, first, key_base, seg, nm;
  unsigned valid[kBoxes];
  int qid[kQMax];
  u64 thr[kQMax];
};

// Pass 1's dynamic shared memory, in bytes from its 1024-aligned base: the
// ring's rows, then each stage's query columns (kQMax x the chunk's 128 /
// elem_size columns, fp32), norms and scales (kTileRows each) and
// metadata; the qp candidate buffers of cap entries (none on the selection
// path); the warps' digit histograms; the per-query state; the barriers.
// kernels/ivf_score.py's scan_smem mirrors it.
struct ScanLayout {
  size_t qv, info, meta, bs, bi, hist, state, bars, total;
};

__host__ __device__ inline ScanLayout scan_layout(int et, int stages, int qp,
                                                  int cap) {
  ScanLayout l;
  size_t o = (size_t)stages * kRowBytes;
  l.qv = o;
  o += (size_t)stages * kQMax * (128 / elem_size(et)) * 4;
  l.info = o;
  o += (size_t)stages * 2 * kTileRows * 4;
  l.meta = o;
  o += (size_t)stages * sizeof(StageMeta);
  l.bs = o;
  o += (size_t)qp * cap * 4;
  l.bi = o;
  o += (size_t)qp * cap * 4;
  l.hist = o;
  o += (size_t)kBoxes * 256 * 4;
  l.state = o;   // thr_w, cnt, the producer's pass queries; flag[2]
  o += 4 * (4 * kQMax + 2);
  o = (o + 7) & ~(size_t)7;
  l.bars = o;
  o += 16 * (size_t)stages;
  l.total = o;
  return l;
}

// Pass 1's operands. Its nsrc items: dedup (member != null), item s is list
// uniq[s] with member row s; batch, item i is query i / nprobe's
// (i % nprobe)-th probe, probes flattened in src_list.
struct ListArgs {
  const void* x;            // the slab as (nlist * L, d) rows
  const float* gsq;
  const float* gsc;         // null: 1.0
  const float* valid;
  const int* src_list;
  const float* member;
  const float* q;           // (b, d)
  int nsrc, b, nprobe, L, d, kk, qp, cap, stages, tma;   // nsrc items
  float* part_s;            // buffered: query j's partial lists at j * stride
  int* part_i;
  long long stride;
  int* part_n;              // (b,) their live entries, zeroed
  u64* thr0;                // (b,) threshold words, zeroed
  float* sel;               // selection: the (b, nseg, L) scores, not null
  int* next;                // the item counter, zeroed
  u64* stats;               // null, or the optional profile (kLsSlots)
};

// a barrier of the consumer warps alone
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// 4 bytes global -> shared by the load units; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// A 16-byte word of stored values cast up to fp32 (exactly): 4 fp32, 8 bf16
// (the upper halves of fp32s) or 16 int8 codes (byte e of u ^ 0x80808080 is
// the code + 128; over the exponent byte of 2^23 it reads 2^23 + code + 128,
// and subtracting 2^23 + 128 leaves the code).
template <int ET>
__device__ __forceinline__ void widen(uint4 w, float* v) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (ET == kF32) {
      v[i] = __uint_as_float(u[i]);
    } else if constexpr (ET == kBF16) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    } else {
      const unsigned b = u[i] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[4 * i + e] =
            __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + e)) -
            8388736.f;
    }
  }
}

// One thread's row of a stage (row: its 128 bytes, 16-byte word j at
// j ^ sw, the box's swizzle) against NM member queries' columns of the
// chunk (qc: kQMax x 128 / sizeof(T) fp32, query mm's at mm * the chunk's
// columns), over its first nw words: fmaf in ascending column order into
// acc[mm].
template <int ET, int NM>
__device__ __forceinline__ void dot_chunk(const unsigned char* row,
                                          const float* qc, int sw, int nw,
                                          float (&acc)[kQMax]) {
  constexpr int PER = 16 / sizeof(typename Elem<ET>::T);
  constexpr int KC = 8 * PER;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < nw) {
      const uint4 w = *reinterpret_cast<const uint4*>(row + ((j ^ sw) << 4));
      float xv[PER];
      widen<ET>(w, xv);
#pragma unroll
      for (int mm = 0; mm < NM; ++mm) {
        const float* qq = qc + mm * KC + j * PER;
#pragma unroll
        for (int e = 0; e < PER; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qq + e);
          acc[mm] = fmaf(q4.x, xv[e], acc[mm]);
          acc[mm] = fmaf(q4.y, xv[e + 1], acc[mm]);
          acc[mm] = fmaf(q4.z, xv[e + 2], acc[mm]);
          acc[mm] = fmaf(q4.w, xv[e + 3], acc[mm]);
        }
      }
    }
  }
}

// dot_chunk over a full chunk (its eight words, unrolled with no test, so
// every load can be issued early) or a partial one
template <int ET, int NM>
__device__ __forceinline__ void dot_row(const unsigned char* row,
                                        const float* qc, int sw, int nw,
                                        float (&acc)[kQMax]) {
  if (nw == 8)
    dot_chunk<ET, NM>(row, qc, sw, 8, acc);
  else
    dot_chunk<ET, NM>(row, qc, sw, nw, acc);
}

// Pass 1 (see the header). SEL: the selection path (scores to a.sel), else
// the buffered one.
template <int ET, bool SEL>
__global__ void __launch_bounds__(kScanThreads, 1)
list_scan_kernel(const ListArgs a, const __grid_constant__ CUtensorMap map) {
  using T = typename Elem<ET>::T;
  constexpr int ES = sizeof(T);
  constexpr int KC = 128 / ES;      // columns of a chunk
  constexpr int PER = 16 / ES;      // values of a 16-byte word
  extern __shared__ __align__(1024) unsigned char scan_smem[];
  const int stages = a.stages, L = a.L, d = a.d, kk = a.kk, cap = a.cap;
  const ScanLayout lay = scan_layout(ET, stages, a.qp, cap);
  unsigned char* ring = scan_smem;
  float* qv = reinterpret_cast<float*>(scan_smem + lay.qv);
  float* info = reinterpret_cast<float*>(scan_smem + lay.info);
  StageMeta* meta = reinterpret_cast<StageMeta*>(scan_smem + lay.meta);
  float* bs = reinterpret_cast<float*>(scan_smem + lay.bs);
  int* bi = reinterpret_cast<int*>(scan_smem + lay.bi);
  unsigned* hist = reinterpret_cast<unsigned*>(scan_smem + lay.hist);
  // each query slot's admission threshold as a packed word (0: none), one
  // 64-bit access, so a reader sees it before or after a raise, never torn
  u64* thr_w = reinterpret_cast<u64*>(scan_smem + lay.state);
  int* cnt = reinterpret_cast<int*>(thr_w + kQMax);
  int* pq = cnt + kQMax;            // the producer's pass queries
  int* flag = pq + kQMax;           // (2,) by tile parity
  u64* full = reinterpret_cast<u64*>(scan_smem + lay.bars);
  u64* empty = full + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nchd = (d + KC - 1) / KC;
  const bool dedup = a.member != nullptr;
  const int nseg = dedup ? a.nsrc : a.nprobe;

  // a stage is full once the producer's 32 lanes' copies have landed and
  // its first lane has arrived (expecting the boxes' bytes); empty once
  // each consumer warp has read it
  if (tid < stages) {
    mbar_init(full + tid, 33);
    mbar_init(empty + tid, kBoxes);
  }
  if (tid < kQMax) cnt[tid] = 0;
  if (tid < 2) flag[tid] = 0;
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == kBoxes) {   // the producer
    const T* x = static_cast<const T*>(a.x);
    const bool qvec = (d & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(a.q) & 15) == 0;
    const bool ivec = (L & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(a.gsq) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(a.gsc) & 15) == 0;
    int u = 0;
    // the item in hand, prefetched: its list and first 64 member entries
    int item = 0;
    if (lane == 0) item = atomicAdd(a.next, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    int pf_list = 0;
    float pf_m0 = 0.f, pf_m1 = 0.f;
    auto prefetch = [&](int it) {
      if (it >= a.nsrc) return;
      pf_list = a.src_list[it];
      if (dedup) {
        const long long row = (long long)it * a.b;
        pf_m0 = lane < a.b ? a.member[row + lane] : 0.f;
        pf_m1 = 32 + lane < a.b ? a.member[row + 32 + lane] : 0.f;
      }
    };
    prefetch(item);
    u64 st_wait = 0, st_item = 0;   // the optional profile, lane 0's
    auto since = [&](long long t0) { return (u64)(clock64() - t0); };
    while (item < a.nsrc) {
      long long t_item = clock64();
      int nxt = 0;
      if (lane == 0) nxt = atomicAdd(a.next, 1);   // read after tile 0
      bool fetched = false;
      const int list = pf_list;
      const float m0 = pf_m0, m1 = pf_m1;
      int key_base, seg, total;
      // pass p's member queries into pq (ranks [p qp, p qp + qp)); returns
      // the item's member count
      auto members = [&](int p) -> int {
        if (!dedup) {
          if (lane == 0) pq[0] = item / a.nprobe;
          __syncwarp();
          return 1;
        }
        int seen = 0;
        const int lo = p * a.qp;
        for (int base = 0; base < a.b; base += 32) {
          const int j = base + lane;
          float v = m0;
          if (base == 32) v = m1;
          else if (base > 32) v = j < a.b ? a.member[(long long)item * a.b + j]
                                          : 0.f;
          const bool mem = j < a.b && v > 0.5f;
          const unsigned bal = __ballot_sync(0xffffffffu, mem);
          const int rank = seen + __popc(bal & ((1u << lane) - 1u));
          if (mem && rank >= lo && rank < lo + a.qp) pq[rank - lo] = j;
          seen += __popc(bal);
        }
        __syncwarp();
        return seen;
      };
      if (dedup) {
        key_base = list * L;
        seg = item;
      } else {
        seg = item % a.nprobe;
        key_base = seg * L;
      }
      total = members(0);
      const float* vl = a.valid + (long long)list * L;
      const long long row0 = (long long)list * L;
      for (int p = 0; p * a.qp < total; ++p) {
        if (p > 0) members(p);
        const int nm = total - p * a.qp < a.qp ? total - p * a.qp : a.qp;
        const int myq = lane < nm ? pq[lane] : 0;
        u64 th = 0;   // the query's threshold word, in flight
        if (!SEL && lane < nm) th = __ldcg(a.thr0 + myq);
        // tile t0's valid flags: box w's row `lane` in vf[w], 0 past L
        float vf[kBoxes];
        auto load_valid = [&](int t0) {
#pragma unroll
          for (int w = 0; w < kBoxes; ++w) {
            const int r = t0 + kBoxRows * w + lane;
            vf[w] = r < L ? vl[r] : 0.f;
          }
        };
        load_valid(0);
        bool first = true;
        for (int t0 = 0; t0 < L; t0 += kTileRows) {
          unsigned vb[kBoxes], any = 0;
#pragma unroll
          for (int w = 0; w < kBoxes; ++w) {
            vb[w] = __ballot_sync(0xffffffffu, vf[w] > 0.5f);
            any |= vb[w];
          }
          if (first && t_item != 0) {   // the item's flags are in
            st_item += since(t_item);
            t_item = 0;
          }
          if (t0 + kTileRows < L) load_valid(t0 + kTileRows);
          if (any == 0 && !SEL) continue;
          unsigned myvb = 0;   // lane w carries box w's word
#pragma unroll
          for (int w = 0; w < kBoxes; ++w)
            if (lane == w) myvb = vb[w];
          const int chunks = any == 0 ? 1 : nchd;
          for (int c = 0; c < chunks; ++c) {
            const int slot = u % stages;
            const long long tw = clock64();
            if (u >= stages) mbar_wait(empty + slot, ((u / stages) - 1) & 1);
            st_wait += since(tw);
            StageMeta* mt = meta + slot;
            const int kind = any == 0 ? kEmpty : kData;
            if (lane == 0) {
              mt->kind = kind;
              mt->list = list;
              mt->t0 = t0;
              mt->chunk = c;
              mt->first = first;
              mt->key_base = key_base;
              mt->seg = seg;
              mt->nm = nm;
            }
            if (lane < kBoxes) mt->valid[lane] = myvb;
            if (lane < kQMax) {
              mt->qid[lane] = myq;
              mt->thr[lane] = th;
            }
            if (kind == kData) {
              // the member queries' columns of the chunk, zero past d
              float* qd = qv + (size_t)slot * kQMax * KC;
              const int c0 = c * KC;
              if (qvec) {
                for (int i = lane; i < nm * (KC / 4); i += 32) {
                  const int mm = i / (KC / 4);
                  const int cc = 4 * (i - mm * (KC / 4));
                  const bool in = c0 + cc < d;
                  cp_async_16(qd + mm * KC + cc,
                              in ? a.q + (long long)pq[mm] * d + c0 + cc
                                 : a.q,
                              in ? 16 : 0);
                }
              } else {
                for (int i = lane; i < nm * KC; i += 32) {
                  const int mm = i / KC;
                  const int cc = i - mm * KC;
                  const bool in = c0 + cc < d;
                  cp_async_4(qd + mm * KC + cc,
                             in ? a.q + (long long)pq[mm] * d + c0 + cc : a.q,
                             in ? 4 : 0);
                }
              }
              if (c == 0) {   // the tile's norms and scales, zero past L
                float* xi = info + (size_t)slot * 2 * kTileRows;
                const int n = L - t0 < kTileRows ? L - t0 : kTileRows;
                const int arrays = a.gsc != nullptr ? 2 : 1;
                for (int h = 0; h < arrays; ++h) {
                  const float* src = (h == 0 ? a.gsq : a.gsc) + row0 + t0;
                  float* dst = xi + h * kTileRows;
                  if (ivec) {
                    for (int i = 4 * lane; i < kTileRows; i += 128)
                      cp_async_16(dst + i, i < n ? src + i : a.gsq,
                                  i < n ? 16 : 0);
                  } else {
                    for (int i = lane; i < kTileRows; i += 32)
                      cp_async_4(dst + i, i < n ? src + i : a.gsq,
                                 i < n ? 4 : 0);
                  }
                }
              }
              if (!a.tma) {   // rows the copy engine cannot describe
                unsigned char* dst = ring + (size_t)slot * kRowBytes;
                for (int w = 0; w < kBoxes; ++w) {
                  if (vb[w] == 0) continue;
                  for (int i = lane; i < kBoxRows * KC; i += 32) {
                    const int rr = i / KC;
                    const int cc = i - rr * KC;
                    const int r = t0 + kBoxRows * w + rr;
                    T v = 0;
                    if (r < L && c0 + cc < d) v = x[(row0 + r) * d + c0 + cc];
                    *reinterpret_cast<T*>(
                        dst + w * kBoxBytes + rr * 128 +
                        ((((cc * ES) >> 4) ^ (rr & 7)) << 4) +
                        ((cc * ES) & 15)) = v;
                  }
                }
              }
            }
            __syncwarp();
            cp_async_arrive(full + slot);
            if (lane == 0) {
              if (kind == kData && a.tma) {
                int boxes = 0;
#pragma unroll
                for (int w = 0; w < kBoxes; ++w) boxes += vb[w] != 0;
                mbar_expect(full + slot, boxes * kBoxBytes);
                unsigned char* dst = ring + (size_t)slot * kRowBytes;
#pragma unroll
                for (int w = 0; w < kBoxes; ++w)
                  if (vb[w] != 0)
                    tensor_copy(dst + w * kBoxBytes, &map, c * KC,
                                (int)(row0 + t0 + kBoxRows * w), full + slot);
              } else {
                mbar_arrive(full + slot);
              }
            }
            ++u;
          }
          first = false;
          if (!fetched) {   // the next item's list and members, in flight
            nxt = __shfl_sync(0xffffffffu, nxt, 0);
            prefetch(nxt);
            fetched = true;
          }
        }
        if (!SEL) {   // the pass's end
          const int slot = u % stages;
          if (u >= stages) mbar_wait(empty + slot, ((u / stages) - 1) & 1);
          StageMeta* mt = meta + slot;
          if (lane == 0) {
            mt->kind = kEnd;
            mt->nm = nm;
          }
          if (lane < kQMax) mt->qid[lane] = myq;
          __syncwarp();
          cp_async_arrive(full + slot);
          if (lane == 0) mbar_arrive(full + slot);
          ++u;
        }
        __syncwarp();   // pq is read before the next pass rewrites it
      }
      if (!fetched) {
        nxt = __shfl_sync(0xffffffffu, nxt, 0);
        prefetch(nxt);
      }
      item = nxt;
    }
    const int slot = u % stages;   // no item is left
    if (u >= stages) mbar_wait(empty + slot, ((u / stages) - 1) & 1);
    if (lane == 0) meta[slot].kind = kExit;
    if (a.stats != nullptr && lane == 0) {
      atomicAdd(a.stats + kLsProdWait, st_wait);
      atomicAdd(a.stats + kLsProdItem, st_item);
    }
    __syncwarp();
    cp_async_arrive(full + slot);
    if (lane == 0) mbar_arrive(full + slot);
    return;
  }

  // the consumers: thread tid owns row tid of every tile, box `warp`
  float acc[kQMax];
#pragma unroll
  for (int i = 0; i < kQMax; ++i) acc[i] = 0.f;
  float xsq_r = 0.f, sc_r = 1.f;
  unsigned vrow = 0;   // the valid bits of this warp's box of the tile
  int tiles = 0;       // tiles this block has finished
  // the warp's query slot's kk entries of its query's partial lists,
  // reserved where the pass begins (lane 0's; -1: none)
  int at_r = -1;
  // the threshold word of the warp's query as the last tile began (lane
  // 0's; read with one tile's delay, so its load never stalls)
  u64 seen_r = 0;
  // a buffer past cut_at after a tile is cut: early, so the threshold rises
  // after the first tile, and always with a tile's room left
  const int cut_at = kk + kTileRows / 2 < cap - kTileRows ? kk + kTileRows / 2
                                                         : cap - kTileRows;

  // the optional profile: thread 0's cycles by phase, each warp's
  // admissions and the cuts
  u64 st[kLsSlots] = {};
  long long clk = a.stats != nullptr ? clock64() : 0;
  auto lap = [&](int phase) {
    if (a.stats != nullptr && tid == 0) {
      const long long now = clock64();
      st[phase] += (u64)(now - clk);
      clk = now;
    }
  };

  // cut every buffer that may not hold another tile, each by the warp that
  // owns its query (slot mm belongs to warp mm), and raise the query's
  // threshold word
  auto cut_full = [&](const StageMeta* mt) {
    const int mm = warp;
    if (mm < mt->nm && cnt[mm] > cut_at) {
      const int c = cnt[mm];
      const u64 w = warp_cut(Cands{bs + mm * cap, bi + mm * cap, nullptr,
                                   nullptr, cap},
                             c, kk, hist + 256 * warp);
      if (lane == 0) {
        cnt[mm] = kk;
        if (w > thr_w[mm]) thr_w[mm] = w;
        atomicMax(a.thr0 + mt->qid[mm], w);
        if (a.stats != nullptr) atomicAdd(a.stats + kLsCuts, 1ull);
      }
      __syncwarp();
    }
  };

  // the pass's end: each buffer cut to kk and written to its query's
  // partial lists; the kk-th best raises the query's threshold word
  auto end_pass = [&](const StageMeta* mt) {
    consumers_sync();   // every append of the pass is in
    const int mm = warp;
    if (mm < mt->nm) {
      int c = cnt[mm];
      const int qj = mt->qid[mm];
      float* ms = bs + mm * cap;
      int* mi = bi + mm * cap;
      u64 w = 0;
      if (c > kk) {
        w = warp_cut(Cands{ms, mi, nullptr, nullptr, cap}, c, kk,
                     hist + 256 * warp);
        c = kk;
        if (a.stats != nullptr && lane == 0) atomicAdd(a.stats + kLsCuts, 1ull);
      } else if (c == kk) {   // the least of exactly kk
        u64 least = ~0ull;
        for (int e = lane; e < c; e += 32) {
          const u64 we = word_of(ms[e], mi[e]);
          if (we < least) least = we;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const u64 v = __shfl_xor_sync(0xffffffffu, least, o);
          if (v < least) least = v;
        }
        w = least;
      }
      if (lane == 0 && w != 0) atomicMax(a.thr0 + qj, w);
      // the kk entries reserved where the pass began: c live, the rest dead
      const int at = __shfl_sync(0xffffffffu, at_r, 0);
      if (at >= 0) {
        float* os = a.part_s + (long long)qj * a.stride + at;
        int* oi = a.part_i + (long long)qj * a.stride + at;
        for (int e = lane; e < kk; e += 32) {
          os[e] = e < c ? ms[e] : -INFINITY;
          oi[e] = e < c ? mi[e] : 0;
        }
      }
      __syncwarp();
      if (lane == 0) {
        cnt[mm] = 0;
        at_r = -1;
      }
    }
    if (tid == 0) flag[0] = flag[1] = 0;
  };

  for (int u = 0;; ++u) {
    const int slot = u % stages;
    mbar_wait(full + slot, (u / stages) & 1);
    lap(kLsWait);
    const StageMeta* mt = meta + slot;
    const int kind = mt->kind;
    if (kind == kExit) break;
    const int nm = mt->nm;
    if (kind == kEnd) {
      if constexpr (!SEL) end_pass(mt);
      lap(kLsEnd);
      st[kLsPasses] += 1;
    } else if (kind == kEmpty) {   // selection path: -inf over the tile
      const int r = mt->t0 + tid;
      if (r < L)
        for (int mm = 0; mm < nm; ++mm)
          a.sel[((long long)mt->qid[mm] * nseg + mt->seg) * L + r] =
              -INFINITY;
    } else {
      const int c = mt->chunk;
      if (c == 0) {   // a tile begins
        if constexpr (!SEL) {
          const int mm = warp;   // this warp's slot, if the pass has it
          if (mt->first) {   // the pass's thresholds, by the slots' owners
            if (mm < nm && lane == 0) {
              thr_w[mm] = mt->thr[mm];
              cnt[mm] = 0;
              at_r = atomicAdd(a.part_n + mt->qid[mm], kk);   // read at the end
              seen_r = __ldcg(a.thr0 + mt->qid[mm]);
            }
            consumers_sync();
          } else {
            // the owner raises its query's threshold to the word other
            // passes had published as the last tile began, and reads it again
            if (mm < nm && lane == 0) {
              if (seen_r > thr_w[mm]) thr_w[mm] = seen_r;
              seen_r = __ldcg(a.thr0 + mt->qid[mm]);
            }
            // the consumers meet and cut the buffers the last tile filled
            // (its flag, by tile parity, is read by every consumer before
            // it is cleared; this tile's epilogue raises the other one)
            consumers_sync();
            if (flag[(tiles - 1) & 1]) {
              cut_full(mt);
              consumers_sync();   // the cuts are done before more appends
              if (tid == 0) flag[(tiles - 1) & 1] = 0;
            }
          }
        }
        lap(kLsCut);
        const float* xi = info + (size_t)slot * 2 * kTileRows;
        xsq_r = xi[tid];
        sc_r = a.gsc != nullptr ? xi[kTileRows + tid] : 1.f;
        vrow = mt->valid[warp];
#pragma unroll
        for (int i = 0; i < kQMax; ++i) acc[i] = 0.f;
      }
      if (vrow != 0) {   // this warp's box is in: its chunk's dot products
        const unsigned char* row = ring + (size_t)slot * kRowBytes + tid * 128;
        const float* qc = qv + (size_t)slot * kQMax * KC;
        const int left = d - c * KC;
        const int nw = left >= KC ? 8 : (left + PER - 1) / PER;
        // exactly nm queries' multiply-adds (a loop unrolled for each count)
        switch (nm) {
          case 1: dot_row<ET, 1>(row, qc, lane & 7, nw, acc); break;
          case 2: dot_row<ET, 2>(row, qc, lane & 7, nw, acc); break;
          case 3: dot_row<ET, 3>(row, qc, lane & 7, nw, acc); break;
          case 4: dot_row<ET, 4>(row, qc, lane & 7, nw, acc); break;
          case 5: dot_row<ET, 5>(row, qc, lane & 7, nw, acc); break;
          case 6: dot_row<ET, 6>(row, qc, lane & 7, nw, acc); break;
          case 7: dot_row<ET, 7>(row, qc, lane & 7, nw, acc); break;
          default: dot_row<ET, kQMax>(row, qc, lane & 7, nw, acc);
        }
      }
      lap(kLsCompute);
      if (c == nchd - 1) {   // the tile's scores
        const int r = mt->t0 + tid;
        const bool ok = (vrow >> lane) & 1u;
        const int key = mt->key_base + r;
#pragma unroll
        for (int mm = 0; mm < kQMax; ++mm) {
          if (mm < nm) {
            const float s = __fsub_rn(
                __fmul_rn(__fmul_rn(2.f, acc[mm]), sc_r), xsq_r);
            if constexpr (SEL) {
              if (r < L)
                a.sel[((long long)mt->qid[mm] * nseg + mt->seg) * L + r] =
                    ok ? s : -INFINITY;
            } else {
              // better() than the threshold word: a higher score, or an
              // equal one (-0.0 as +0.0) and a smaller key; never -inf, NaN
              const bool admit =
                  ok && s > -INFINITY && word_of(s, key) > thr_w[mm];
              const unsigned bal = __ballot_sync(0xffffffffu, admit);
              if (bal != 0) {
                int base = 0;
                if (lane == 0) base = atomicAdd(cnt + mm, __popc(bal));
                base = __shfl_sync(0xffffffffu, base, 0);
                st[kLsAdmitted] += __popc(bal);
                if (admit) {
                  const int p = base + __popc(bal & ((1u << lane) - 1u));
                  bs[mm * cap + p] = s;
                  bi[mm * cap + p] = key;
                }
                if (lane == 0 && base + __popc(bal) > cut_at)
                  flag[tiles & 1] = 1;
              }
            }
          }
        }
        ++tiles;
        st[kLsTiles] += 1;
        lap(kLsEpilogue);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  }
  if (a.stats != nullptr && lane == 0) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kLsSlots; ++i)
        if (i != kLsCuts && i != kLsAdmitted) atomicAdd(a.stats + i, st[i]);
    }
    atomicAdd(a.stats + kLsAdmitted, st[kLsAdmitted]);
  }
}

// The rows epilogue of query j, after its (vals, ids) are written and the
// block has synchronised: each winner's grouped payload rows by flat id,
// zero rows for dead (-inf) slots; 16-byte words where the rows allow.
__device__ void gather_payload(long long j, int kk,
                               const float* __restrict__ vals,
                               const int* __restrict__ ids,
                               const float* __restrict__ pv,
                               const float* __restrict__ pf, int dv, int m,
                               float* __restrict__ rows_v,
                               float* __restrict__ rows_f) {
  const float* v = vals + j * kk;
  const int* id = ids + j * kk;
  for (int h = 0; h < 2; ++h) {
    const float* src = h == 0 ? pv : pf;
    float* out = (h == 0 ? rows_v : rows_f);
    const int w = h == 0 ? dv : m;
    out += j * kk * (long long)w;
    const bool vec = (w & 3) == 0 &&
                     ((reinterpret_cast<uintptr_t>(src) |
                       reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (vec) {
      const int w4 = w / 4;
      for (int i = threadIdx.x; i < kk * w4; i += blockDim.x) {
        const int e = i / w4;
        const int c = i - e * w4;
        float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v[e] != -INFINITY)
          r = reinterpret_cast<const float4*>(src)[(long long)id[e] * w4 + c];
        reinterpret_cast<float4*>(out)[i] = r;
      }
    } else {
      for (int i = threadIdx.x; i < kk * w; i += blockDim.x) {
        const int e = i / w;
        out[i] = v[e] == -INFINITY ? 0.f
                                   : src[(long long)id[e] * w + (i - e * w)];
      }
    }
  }
}

// pass 2's source: one query's partial lists; dead (-inf) entries do not
// compete
struct ListParts {
  const float* s;
  const int* id;
  __device__ bool get(long long e, float* v, int* k) const {
    *v = s[e];
    *k = id[e];
    return *v > -INFINITY;
  }
};

// Pass 2: one block per query keeps the kk best of its partial lists that
// are at or above its threshold word (its key raised by one, so the entry
// that set it competes), sorts them once, best first, maps ordering keys to
// flat ids (probes non-null: the batch scan's probe position * L + slot)
// and writes them; unfilled slots read (-inf, id 0). The rows variant then
// gathers the winners' payload rows.
__global__ void __launch_bounds__(kMergeThreads)
list_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i,
                  const int* __restrict__ part_n,
                  const u64* __restrict__ thr0, long long stride, int kk,
                  const int* __restrict__ probes, int nprobe, int L,
                  float* __restrict__ vals, int* __restrict__ ids,
                  const float* __restrict__ pv, const float* __restrict__ pf,
                  int dv, int m, float* __restrict__ rows_v,
                  float* __restrict__ rows_f) {
  extern __shared__ __align__(16) unsigned char merge_smem[];
  __shared__ float ts;
  __shared__ int ti;
  const int tid = threadIdx.x;
  const long long j = blockIdx.x;
  const u64 w = thr0[j];
  const int count = stream_topk(
      ListParts{part_s + j * stride, part_i + j * stride}, part_n[j], kk,
      w != 0 ? from_ord((unsigned)(w >> 32)) : -INFINITY,
      w != 0 ? key_of(w) + 1 : -1, merge_smem, &ts, &ti);
  float* bs = reinterpret_cast<float*>(merge_smem);
  int* bi = reinterpret_cast<int*>(bs + stream_slots(kk));
  int len2 = 1;
  while (len2 < kk) len2 <<= 1;
  for (int e = count + tid; e < len2; e += kMergeThreads) {
    bs[e] = -INFINITY;
    bi[e] = INT_MAX;
  }
  __syncthreads();
  sort_segments(bs, bi, 1, len2);
  for (int e = tid; e < kk; e += kMergeThreads) {
    const int key = bi[e];
    int id = 0;
    if (key != INT_MAX) {
      if (probes == nullptr) {
        id = key;
      } else {
        const int p = key / L;
        id = probes[j * nprobe + p] * L + (key - p * L);
      }
    }
    vals[j * kk + e] = bs[e];
    ids[j * kk + e] = id;
  }
  if (rows_v == nullptr) return;
  __syncthreads();
  gather_payload(j, kk, vals, ids, pv, pf, dv, m, rows_v, rows_f);
}

// The exclusive prefix of n counts, in one block (the eligible-slot
// builder's): offsets[s] the sum of counts before s, offsets[n] their sum;
// a block-wide scan over chunks.
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const int* __restrict__ groups, int nsrc,
               int* __restrict__ offsets) {
  __shared__ int warp_sum[kWarps];
  __shared__ int carry;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nsrc; base += kThreads) {
    const int s = base + tid;
    const int g = s < nsrc ? groups[s] : 0;
    int incl = g;                                // inclusive scan in the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (s < nsrc) offsets[s] = before + incl - g;
    __syncthreads();
    if (tid == kThreads - 1) carry = before + incl;
    __syncthreads();
  }
  if (tid == 0) offsets[nsrc] = carry;
}

// The queries' scores in the selection path: query j's member lists
// (dedup) or probes (batch), nseg segments of L slots in its row of the
// scratch. A non-member segment is skipped unread (its member entry is
// tested once a pass block); a -inf (invalid) or NaN score does not
// compete, as it never beats a buffer's threshold; -0.0 counts as +0.0.
// The key is the flat id (dedup) or the probe position * L + slot (batch),
// as in pass 1.
struct ListScores {
  const float* s;
  const float* member;   // (nseg, b) for dedup, null for batch
  const int* uniq;
  int nseg, L, b;
  static constexpr bool kSegmented = true;
  __device__ long long size(int) const { return (long long)nseg * L; }
  __device__ long long seg_len() const { return L; }
  __device__ bool seg_live(int j, long long seg) const {
    return member == nullptr || member[seg * b + j] > 0.5f;
  }
  __device__ const float* row(int j) const {
    return s + (long long)j * nseg * L;
  }
  __device__ unsigned ord(float v) const {
    return v > -INFINITY ? ord_bits_eq0(v) : 0u;
  }
  __device__ int key(int, long long seg, long long e) const {
    return member != nullptr ? uniq[seg] * L + (int)(e - seg * L) : (int)e;
  }
};

// The selection path's finish: one block per query, after select_passes.
__global__ void __launch_bounds__(kSelThreads)
list_select_kernel(const SelectArgs sa, const float* __restrict__ sel,
                   const float* __restrict__ member,
                   const int* __restrict__ src_list, int nsrc, int nprobe,
                   int L, float* __restrict__ vals, int* __restrict__ ids,
                   const float* __restrict__ pv, const float* __restrict__ pf,
                   int dv, int m, float* __restrict__ rows_v,
                   float* __restrict__ rows_f) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  __shared__ FinishState fs;
  const long long j = blockIdx.x;
  const int kk = sa.kk;
  const bool dedup = member != nullptr;
  const int nseg = dedup ? nsrc : nprobe;
  u64* w;
  int* pos;
  sort_area(sa, (int)j, sel_smem, &w, &pos);
  const float* s = sel + j * nseg * (long long)L;
  const int count = select_finish(sa, (int)j, w, pos, &fs);
  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    int id = 0;
    if (e < count) {
      const int key = key_of(w[e]);
      if (dedup) {
        id = key;
      } else {
        const int p = key / L;
        id = src_list[j * nprobe + p] * L + (key - p * L);
      }
    }
    vals[j * kk + e] = e < count ? s[pos[e]] : -INFINITY;
    ids[j * kk + e] = id;
  }
  if (rows_v == nullptr) return;
  __syncthreads();
  gather_payload(j, kk, vals, ids, pv, pf, dv, m, rows_v, rows_f);
}

// B5 mask='s operands, built on the card with no host synchronisation for
// the flat scan (fused_score_topk.cu) that runs it:
//   list_bits_kernel: a warp a source; the source's member bits (query j
//     at bit j % 64 of word j / 64) OR-ed into its list's words of lbits
//     (zeroed first), so a list's bits are its member queries;
//   slot_count_kernel / offsets_kernel / slot_ids_kernel: the eligible
//     slots, valid * mask > 0.5 in a list with a member query, as flat ids
//     in ascending order (kSlotChunk slots a block: each block counts its
//     own, the offsets are their exclusive sum, then each block writes its
//     ids at its offset, in order by a block-wide scan).
constexpr int kSlotChunk = 4 * kThreads;

__global__ void __launch_bounds__(kThreads)
list_bits_kernel(const float* __restrict__ member,
                 const int* __restrict__ uniq, int nsrc, int b, int words,
                 u64* __restrict__ lbits) {
  const long long s = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (s >= nsrc) return;                         // whole warps alike
  for (int w = 0; w < words; ++w) {
    u64 bits = 0;
    for (int h = 0; h < 2; ++h) {
      const int j = 64 * w + 32 * h + lane;
      const unsigned m = __ballot_sync(0xffffffffu,
                                       j < b && member[s * b + j] > 0.5f);
      bits |= (u64)m << (32 * h);
    }
    if (lane == 0 && bits != 0)
      atomicOr(lbits + (long long)uniq[s] * words + w, bits);
  }
}

// slot e is eligible: valid * mask > 0.5, and its list has a member query
__device__ __forceinline__ bool slot_live(const float* valid,
                                          const float* mask, const u64* lbits,
                                          int L, int words, long long e) {
  if (!(valid[e] * mask[e] > 0.5f)) return false;
  const u64* lw = lbits + (e / L) * words;
  for (int w = 0; w < words; ++w)
    if (lw[w] != 0) return true;
  return false;
}

__global__ void __launch_bounds__(kThreads)
slot_count_kernel(const float* __restrict__ valid,
                  const float* __restrict__ mask,
                  const u64* __restrict__ lbits, long long n, int L,
                  int words, int* __restrict__ counts) {
  const long long e0 = (long long)blockIdx.x * kSlotChunk;
  int c = 0;
  for (int i = threadIdx.x; i < kSlotChunk; i += kThreads)
    c += e0 + i < n && slot_live(valid, mask, lbits, L, words, e0 + i);
  unsigned total;
  block_scan((unsigned)c, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = (int)total;
}

__global__ void __launch_bounds__(kThreads)
slot_ids_kernel(const float* __restrict__ valid,
                const float* __restrict__ mask,
                const u64* __restrict__ lbits, long long n, int L, int words,
                const int* __restrict__ offsets, int* __restrict__ elig) {
  constexpr int kPer = kSlotChunk / kThreads;    // a thread's run of slots
  const long long e0 = (long long)blockIdx.x * kSlotChunk +
                       (long long)threadIdx.x * kPer;
  bool live[kPer];
  unsigned c = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    live[i] = e0 + i < n && slot_live(valid, mask, lbits, L, words, e0 + i);
    c += live[i];
  }
  unsigned total;
  int at = offsets[blockIdx.x] + (int)block_scan(c, &total);
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (live[i]) elig[at++] = (int)(e0 + i);
}

// The card's SM count and shared memory an SM, read once per device.
struct DevInfo {
  int sms = 0, smem_sm = 0;
};

cudaError_t dev_info(DevInfo* out, int* dev) {
  constexpr int kMaxDevices = 64;
  static DevInfo cache[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DevInfo& c = cache[*dev];
  if (c.sms == 0) {
    err = cudaDeviceGetAttribute(&c.smem_sm,
                                 cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                 *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                   *dev);
    if (err != cudaSuccess) {
      c.sms = 0;
      return err;
    }
  }
  *out = c;
  return cudaSuccess;
}

// cudaFuncSetAttribute(fn, max dynamic shared memory) once per (kernel,
// device) and size: `done` holds the largest size set so far on each device.
template <class Fn>
cudaError_t allow_smem(Fn fn, size_t smem, int dev, size_t* done) {
  if (smem <= done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done[dev] = smem;
  return err;
}

template <int ET, bool SEL>
cudaError_t launch_list_scan(const ListArgs& a, const CUtensorMap& map,
                             cudaStream_t st) {
  static size_t done[64] = {};
  const size_t smem = scan_layout(ET, a.stages, a.qp, a.cap).total;
  DevInfo info;
  int dev = 0;
  cudaError_t err = dev_info(&info, &dev);
  if (err == cudaSuccess)
    err = allow_smem(list_scan_kernel<ET, SEL>, smem, dev, done);
  if (err != cudaSuccess) return err;
  // persistent blocks: as many as the SMs hold at once, at most one an item
  const long long per_sm = info.smem_sm / (long long)(smem + 1024);
  const long long fill = (long long)info.sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(a.nsrc < fill ? a.nsrc : fill);
  list_scan_kernel<ET, SEL><<<blocks, kScanThreads, smem, st>>>(a, map);
  return cudaGetLastError();
}

template <int ET>
cudaError_t list_scan(const ListArgs& a, const CUtensorMap& map,
                      cudaStream_t st) {
  return a.sel != nullptr ? launch_list_scan<ET, true>(a, map, st)
                          : launch_list_scan<ET, false>(a, map, st);
}

}  // namespace

// B5 mask='s operands (see list_bits_kernel): valid, mask (nlist, L), member
// (nsrc, b) and uniq (nsrc,) in; lbits (nlist, words) u64, the lists'
// member bits (words = ceil(b / 64)), and elig (nlist * L,) int32, the
// eligible slots' flat ids in ascending order, out; work holds 2 *
// ceil(nlist * L / kSlotChunk) + 1 ints: the blocks' counts, then their
// offsets, whose last is the eligible count (the flat scan's n_elig).
extern "C" int fcvi_ivf_masked_slots(const float* valid, const float* mask,
                                     const float* member, const int* uniq,
                                     int nsrc, int b, int nlist, int L,
                                     int words, void* lbits, int* elig,
                                     int* work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  u64* lb = static_cast<u64*>(lbits);
  cudaError_t err = cudaMemsetAsync(
      lb, 0, sizeof(u64) * (size_t)nlist * words, st);
  if (err != cudaSuccess) return (int)err;
  if (nsrc > 0) {
    const long long warps = (long long)nsrc * 32;
    list_bits_kernel<<<(unsigned)((warps + kThreads - 1) / kThreads),
                       kThreads, 0, st>>>(member, uniq, nsrc, b, words, lb);
  }
  const long long n = (long long)nlist * L;
  const int chunks = (int)((n + kSlotChunk - 1) / kSlotChunk);
  int* counts = work;
  int* offsets = work + chunks;
  if (chunks > 0)
    slot_count_kernel<<<chunks, kThreads, 0, st>>>(valid, mask, lb, n, L,
                                                   words, counts);
  offsets_kernel<<<1, kThreads, 0, st>>>(counts, chunks, offsets);
  if (chunks > 0)
    slot_ids_kernel<<<chunks, kThreads, 0, st>>>(valid, mask, lb, n, L,
                                                 words, offsets, elig);
  return (int)cudaGetLastError();
}

// One entry point for the three kernels. et selects the slab's stored
// element type (0 fp32, 1 bf16, 2 int8) and gsc (nlist, L) its per-slot
// scale, null for 1.0. member != nullptr selects the dedup scan (src_list =
// uniq, nsrc = s slots, member (s, b)); member == nullptr the batch scan
// (src_list = probes (b, nprobe), nsrc = b * nprobe). The plan
// (kernels/ivf_score.py): qp member queries a pass (1..kQMax), cap
// candidates a buffer (at least kk + kTileRows), stages of the ring
// (2..kMaxStages). Buffered path (sel null): part_s / part_i hold (b,
// stride) entries, stride = nsrc * kk for dedup and nprobe * kk for batch.
// Selection path (sel, a (b, nseg, L) fp32 scratch with nseg = nsrc for
// dedup and nprobe for batch, not null): cap and part_* are unused; sa
// holds the select's plan and scratch (select_common.cuh), null on the
// buffered path. work holds 1 + 2 b int64 words, zeroed here: the item
// counter, each query's partial count (as int32) and threshold word. The
// rows pointers (pv, pf, rows_v, rows_f) are all null for the ids-only
// variants. stats, null or kLsSlots zeroed words, takes pass 1's optional
// profile.
extern "C" int fcvi_ivf_score_topk(
    const void* grouped, int et, const float* gsq, const float* gsc,
    const float* valid, const int* src_list, int nsrc, const float* member,
    const float* q, int b, int nprobe, int nlist, int L, int d, int kk,
    int qp, int cap, int stages, float* part_s, int* part_i, float* sel,
    const void* sel_args, long long* work, float* vals, int* ids,
    const float* pv, const float* pf, int dv, int m, float* rows_v,
    float* rows_f, void* stats, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (et != kF32 && et != kBF16 && et != kI8)
    return (int)cudaErrorInvalidValue;
  if (kk < 1 || qp < 1 || qp > kQMax || stages < 2 || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const SelectArgs* sa = static_cast<const SelectArgs*>(sel_args);
  if (sel != nullptr && sa == nullptr) return (int)cudaErrorInvalidValue;
  if (sel == nullptr && cap < kk + kTileRows) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(long long) *
                                                 (1 + 2 * (size_t)b), st);
  if (err != cudaSuccess) return (int)err;
  ListArgs a;
  a.x = grouped;
  a.gsq = gsq;
  a.gsc = gsc;
  a.valid = valid;
  a.src_list = src_list;
  a.member = member;
  a.q = q;
  a.nsrc = nsrc;
  a.b = b;
  a.nprobe = nprobe;
  a.L = L;
  a.d = d;
  a.kk = kk;
  a.qp = qp;
  a.cap = sel != nullptr ? 0 : cap;
  a.stages = stages;
  a.tma = 0;
  a.part_s = part_s;
  a.part_i = part_i;
  a.stride = (long long)(member != nullptr ? nsrc : nprobe) * kk;
  a.part_n = reinterpret_cast<int*>(work + 1);
  a.thr0 = reinterpret_cast<u64*>(work + 1 + b);
  a.sel = sel;
  a.next = reinterpret_cast<int*>(work);
  a.stats = static_cast<u64*>(stats);
  if (nsrc > 0 && L > 0) {
    CUtensorMap map;
    bool ok = false;
    err = row_map(&map, grouped, et, (long long)nlist * L, d, kBoxRows, &ok);
    if (err != cudaSuccess) return (int)err;
    a.tma = ok;
    switch (et) {
      case kF32: err = list_scan<kF32>(a, map, st); break;
      case kBF16: err = list_scan<kBF16>(a, map, st); break;
      default: err = list_scan<kI8>(a, map, st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  DevInfo info;
  int dev = 0;
  err = dev_info(&info, &dev);
  if (err != cudaSuccess) return (int)err;
  if (sel != nullptr) {
    static size_t done_sel[64] = {};
    const int nseg = member != nullptr ? nsrc : nprobe;
    err = select_passes(ListScores{sel, member, src_list, nseg, L, b}, *sa,
                        st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = select_smem(*sa);
    err = allow_smem(list_select_kernel, smem, dev, done_sel);
    if (err != cudaSuccess) return (int)err;
    list_select_kernel<<<b, kSelThreads, smem, st>>>(
        *sa, sel, member, src_list, nsrc, nprobe, L, vals, ids, pv, pf, dv, m,
        rows_v, rows_f);
    return (int)cudaGetLastError();
  }
  static size_t done_merge[64] = {};
  const size_t smem = stream_smem(kk);
  err = allow_smem(list_merge_kernel, smem, dev, done_merge);
  if (err != cudaSuccess) return (int)err;
  list_merge_kernel<<<b, kMergeThreads, smem, st>>>(
      part_s, part_i, a.part_n, a.thr0, a.stride, kk,
      member != nullptr ? nullptr : src_list, nprobe, L, vals, ids, pv, pf,
      dv, m, rows_v, rows_f);
  return (int)cudaGetLastError();
}
