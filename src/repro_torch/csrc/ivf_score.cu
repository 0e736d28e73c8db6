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
// dot product accumulates in fp32 over the stored values cast up (exactly)
// and the scale multiplies its output (1.0 without scales; the ||q||^2
// constant is left to the caller, as on the TPU), kept only where valid > 0.5 (and, for
// the dedup scan, member > 0.5). A result id is the flat slot id
// list * max_list + slot. Order, as the TPU kernels' running top-k gives it:
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
// rows a list, d=128, b=64, nprobe=16) the dedup scan reads the unique
// probed lists' rows once, some hundreds of MB at fp32 (a half at bf16, a
// quarter at int8), against well under a GFLOP of fp32 for the member
// pairs: the bytes take several times as long as the operations at the
// card's peaks.
//
// Design. The TPU kernel carries one running top-k across a sequential grid
// over the lists and scores all b queries against each list, masking the
// ones that did not probe it. Blocks on Hopper run in parallel with no
// carry, so there are two passes, as in fused_score_topk.cu:
//
//   plan (count_kernel, offsets_kernel; dedup only): one work item per kBQ
//     member queries of each source, as offsets into the list of items. A slot no query
//     probed has no item, and a list many queries probed has several.
//   pass 1 (list_scan_kernel): persistent blocks, enough to fill the card
//     once, take items from an atomic counter until none is left; so the
//     popular lists' groups run in parallel and no block is spent on an
//     empty slot. An item is one list (a unique list for dedup, one query's
//     probe for batch) and up to kBQ member queries (gathered by a ballot
//     over the member column). The block streams the list kTile rows at a
//     time through shared memory as fp32 (fp32 rows with cp.async, bf16 and
//     int8 rows through registers, cast up once as they are stored), in
//     column chunks of kDC accumulated in ascending column order (so shared
//     memory does not grow with d, and a row sums in the order one chunk
//     would; the member queries' chunks are restaged with each), reading
//     only the rows that are valid and skipping tiles with none. Only member queries are
//     scored, so no work goes to the masked (query, list) pairs that
//     dominate the TPU's grid at b=64, nprobe=16, nlist=1024. Each member
//     query keeps a thresholded candidate buffer trimmed by a bitonic sort,
//     and the block writes one sorted top-kk partial per (list, member
//     query).
//   pass 2 (list_merge_kernel): one block per query merges its partials:
//     every list whose member entry is set (up to s of them, so a dense
//     member matrix is taken as it is; the block tests kThreads entries at
//     once), or its nprobe probe pairs. The rows
//     variant then gathers each winner's payload rows by flat id, the work
//     the TPU kernel's one-hot copy-through (pick_rows) did.
//
// The selection path, for a kk whose buffers do not fit in shared memory
// (or when the caller asks for it): pass 1 writes each (member query, list)
// pair's scores to a (b, nseg, max_list) scratch instead (nseg = s for
// dedup, nprobe for batch; -inf for invalid slots), and the multi-block
// radix select of select_common.cuh (its passes skip a query's non-member
// lists unread; then list_select_kernel, one block per query) selects and
// sorts the top-kk over its member lists' slots by (score, ordering key),
// -0.0 taken as +0.0 as better() takes it. Its (vals, ids) are the
// buffered path's bits; the rows epilogue is the same function.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "select_common.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                      // list rows per stage
constexpr int kRowGroups = 64;                  // threads along the row axis
constexpr int kBQ = kThreads / kRowGroups;      // member queries per block
constexpr int kWarps = kThreads / 32;

// Work planning for the dedup scan, in two kernels. count_kernel: the work
// items of each source, one per kBQ of its member queries (a warp per
// source reads its member row coalesced). offsets_kernel (one block): their
// exclusive prefix, offsets[s] the first item of source s and
// offsets[nsrc] the number of items, a block-wide scan over chunks.
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ member, int nsrc, int b,
             int* __restrict__ groups) {
  const long long s = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (s >= nsrc) return;                         // whole warps alike
  int c = 0;
  for (int base = 0; base < b; base += 32) {
    const int j = base + lane;
    c += __popc(__ballot_sync(0xffffffffu,
                              j < b && member[s * b + j] > 0.5f));
  }
  if (lane == 0) groups[s] = (c + kBQ - 1) / kBQ;
}

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

// Pass 1, persistent: each block takes work items from the `next` counter
// until none is left. Dedup (member != nullptr): item i is the group-th kBQ
// of the member queries of source s, with offsets[s] <= i < offsets[s + 1];
// the partial of (slot s, query j) is s * b + j. Batch (member == nullptr):
// item i is source i, query i / nprobe's (i % nprobe)-th probe, and its own
// partial. Items of one list are adjacent, so a list with many member
// groups is read from device memory about once and from L2 after. With sel
// (the selection path) the block writes its member queries' scores of the
// list to sel instead of keeping buffers: query j's scores of source s at
// (j * nsrc + s) * L for dedup, of its p-th probe at (j * nprobe + p) * L
// for batch, -inf for invalid slots.
template <int ET>
__global__ void __launch_bounds__(kThreads)
list_scan_kernel(const typename Elem<ET>::T* __restrict__ grouped,
                 const float* __restrict__ gsq,
                 const float* __restrict__ gsc,
                 const float* __restrict__ valid,
                 const int* __restrict__ src_list,
                 const float* __restrict__ member,
                 const int* __restrict__ offsets, int* __restrict__ next,
                 const float* __restrict__ q, int nsrc, int b, int nprobe,
                 int L, int d, int kk, int cap, float* __restrict__ part_s,
                 int* __restrict__ part_i, float* __restrict__ sel) {
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  const int dc = staged_cols(d);
  const bool one_chunk = d4 <= kDC;
  const int ds = dc + 4;                         // padded stride: no conflicts
  const int ds4 = ds / 4;                        // 16-byte words per staged row
  float* qs = smem;                              // (kBQ, ds)
  float* xs = qs + kBQ * ds;                     // (kTile, ds)
  float* xsq_s = xs + kTile * ds;                // (kTile,)
  float* sc_s = xsq_s + kTile;                   // (kTile,) 1.0 without gsc
  int* ok_s = reinterpret_cast<int*>(sc_s + kTile);  // (kTile,)
  int* qidx = ok_s + kTile;                      // (kBQ,) member query ids
  float* thr_s = reinterpret_cast<float*>(qidx + kBQ);
  int* thr_i = reinterpret_cast<int*>(thr_s + kBQ);
  int* cnt = thr_i + kBQ;
  int* flag = cnt + kBQ;  // (8,): trim, members, source, group, live item
  float* bs = reinterpret_cast<float*>(flag + 8);  // (kBQ, cap); none if sel
  int* bi = reinterpret_cast<int*>(bs + kBQ * cap);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const bool dedup = member != nullptr;
  const bool select = sel != nullptr;
  const int items = dedup ? offsets[nsrc] : nsrc;
  const bool vec = (d * sizeof(*grouped)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(grouped) & 15) == 0;
  const int rg = tid % kRowGroups;
  const int qg = tid / kRowGroups;
  const float* xa = xs + rg * ds;
  const float* xb = xs + (rg + kRowGroups) * ds;
  const float* qb = qs + qg * ds;

  for (;;) {
    if (tid == 0) {
      const int item = atomicAdd(next, 1);
      int s = item, group = 0;
      if (dedup && item < items) {               // last s with offsets[s] <= item
        int lo = 0, hi = nsrc - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (offsets[mid] <= item) lo = mid; else hi = mid - 1;
        }
        s = lo;
        group = item - offsets[lo];
      }
      flag[2] = s;
      flag[3] = group;
      flag[4] = item < items;
    }
    __syncthreads();
    if (!flag[4]) return;                        // uniform across the block
    const long long src = flag[2];
    const int group = flag[3];
    const int list = src_list[src];
    // the ordering key of slot r is key_base + r (see the header)
    const int key_base = dedup ? list * L : (int)(src % nprobe) * L;
    const auto* xg = grouped + (long long)list * L * d;
    const float* sqg = gsq + (long long)list * L;
    const float* scg = gsc == nullptr ? nullptr : gsc + (long long)list * L;
    const float* vg = valid + (long long)list * L;

    if (warp == 0) {
      if (dedup) {
        // the group-th kBQ of the queries whose member entry is set
        const int first = group * kBQ;
        int seen = 0;
        for (int base = 0; base < b; base += 32) {
          const int j = base + lane;
          const bool m = j < b && member[src * b + j] > 0.5f;
          const unsigned mask = __ballot_sync(0xffffffffu, m);
          const int rank = seen + __popc(mask & ((1u << lane) - 1u));
          if (m && rank >= first && rank < first + kBQ) qidx[rank - first] = j;
          seen += __popc(mask);
        }
        if (lane == 0) {
          const int a = seen - first;
          flag[1] = a > kBQ ? kBQ : a;
        }
      } else if (lane == 0) {
        qidx[0] = (int)(src / nprobe);
        flag[1] = 1;
      }
    }
    __syncthreads();
    const int nact = flag[1];                    // >= 1 by the plan
    // where member query qi's scores of this list go in sel
    auto sel_row = [&](int qi) -> float* {
      return sel + (dedup ? ((long long)qidx[qi] * nsrc + src) * L : src * L);
    };

    // the member queries' columns [c0, c0 + dc), zero past d
    auto stage_q = [&](int c0) {
      for (int i = tid; i < kBQ * ds; i += kThreads) {
        const int qi = i / ds;
        const int c = i - qi * ds;
        qs[i] = (qi < nact && c < dc && c0 + c < d)
                    ? q[(long long)qidx[qi] * d + c0 + c]
                    : 0.f;
      }
    };
    if (one_chunk) stage_q(0);
    if (!select) {
      for (int i = tid; i < kBQ * cap; i += kThreads) {
        bs[i] = -INFINITY;
        bi[i] = INT_MAX;
      }
    }
    if (tid < kBQ) {
      thr_s[tid] = -INFINITY;
      thr_i[tid] = -1;
      cnt[tid] = 0;
    }

    for (int t0 = 0; t0 < L; t0 += kTile) {
      const int rows = L - t0 < kTile ? L - t0 : kTile;
      __syncthreads();  // the previous stage's readers are done with xs, ok_s
      int ok = 0;
      if (tid < kTile) {
        ok = tid < rows && vg[t0 + tid] > 0.5f;
        ok_s[tid] = ok;
        xsq_s[tid] = ok ? sqg[t0 + tid] : 0.f;
        sc_s[tid] = ok && scg != nullptr ? scg[t0 + tid] : 1.f;
      }
      if (!__syncthreads_or(ok)) {               // no valid row in the tile
        if (select) {
          for (int i = tid; i < nact * rows; i += kThreads) {
            const int qi = i / rows;
            sel_row(qi)[t0 + (i - qi * rows)] = -INFINITY;
          }
        }
        continue;
      }
      float acc0 = 0.f, acc1 = 0.f;
      for (int c0 = 0; c0 < d4; c0 += kDC) {
        if (c0 > 0) __syncthreads();  // the previous chunk's readers are done
        if (!one_chunk) stage_q(c0);
        if (vec && ET == kF32) {
          // every 16-byte copy of the chunk in flight at once; invalid rows
          // and the pad columns are zero-filled without a read
          const float* xf = reinterpret_cast<const float*>(xg);
          for (int i = tid; i < kTile * ds4; i += kThreads) {
            const int r = i / ds4;
            const int c = (i - r * ds4) * 4;
            const bool live = ok_s[r] && c < dc && c0 + c < d;
            const float* from =
                live ? xf + (long long)(t0 + r) * d + c0 + c : xf;
            cp_async16(xs + r * ds + c, from, live ? 16 : 0);
          }
          cp_async_wait_all();
        } else if (vec) {
          if constexpr (ET != kF32)
            stage_up<ET, kTile, kThreads>(
                xs, ds, xg + (long long)t0 * d + c0, d, rows,
                d - c0 < kDC ? d - c0 : kDC,
                [&](int r) { return ok_s[r] != 0; });
        } else {
          for (int r = warp; r < kTile; r += kWarps) {
            const bool live = ok_s[r];
            const long long row = (long long)(t0 + r) * d + c0;
            float* dst = xs + r * ds;
            for (int c = lane; c < ds; c += 32)
              dst[c] = (live && c < dc && c0 + c < d)
                           ? Elem<ET>::at(xg, row + c)
                           : 0.f;
          }
        }
        __syncthreads();

        const int cw4 = d4 - c0 < kDC ? d4 - c0 : kDC;
        for (int c = 0; c < cw4; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(xa + c);
          const float4 e = *reinterpret_cast<const float4*>(xb + c);
          const float4 u = *reinterpret_cast<const float4*>(qb + c);
          acc0 = fmaf(u.x, a.x, acc0);
          acc0 = fmaf(u.y, a.y, acc0);
          acc0 = fmaf(u.z, a.z, acc0);
          acc0 = fmaf(u.w, a.w, acc0);
          acc1 = fmaf(u.x, e.x, acc1);
          acc1 = fmaf(u.y, e.y, acc1);
          acc1 = fmaf(u.z, e.z, acc1);
          acc1 = fmaf(u.w, e.w, acc1);
        }
      }
      if (qg < nact) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rg + h * kRowGroups;
          if (select) {
            if (r < rows)
              sel_row(qg)[t0 + r] =
                  ok_s[r] ? __fsub_rn(__fmul_rn(__fmul_rn(2.f, h == 0 ? acc0
                                                                      : acc1),
                                                sc_s[r]),
                                      xsq_s[r])
                          : -INFINITY;
            continue;
          }
          if (!ok_s[r]) continue;
          const float s = __fsub_rn(
              __fmul_rn(__fmul_rn(2.f, h == 0 ? acc0 : acc1), sc_s[r]),
              xsq_s[r]);
          const int key = key_base + t0 + r;
          if (better(s, key, thr_s[qg], thr_i[qg])) {
            const int pos = atomicAdd(&cnt[qg], 1);
            bs[qg * cap + pos] = s;
            bi[qg * cap + pos] = key;
          }
        }
      }
      if (select) continue;
      __syncthreads();
      if (tid == 0) {
        int need = 0;
        for (int i = 0; i < nact; ++i) need |= cnt[i] > cap - kTile;
        flag[0] = need;
      }
      __syncthreads();
      if (flag[0]) trim(bs, bi, cnt, thr_s, thr_i, nact, cap, kk);
    }

    if (!select) {
      trim(bs, bi, cnt, thr_s, thr_i, nact, cap, kk);
      for (int i = tid; i < nact * kk; i += kThreads) {
        const int qi = i / kk;
        const int e = i - qi * kk;
        const long long p = dedup ? src * b + qidx[qi] : src;
        part_s[p * kk + e] = bs[qi * cap + e];
        part_i[p * kk + e] = bi[qi * cap + e];
      }
    }
    __syncthreads();             // the next item reuses flag, qidx, qs and bs
  }
}

// The rows epilogue of query j, after its (vals, ids) are written and the
// block has synchronised: each winner's grouped payload rows by flat id,
// zero rows for dead (-inf) slots.
__device__ void gather_payload(long long j, int kk,
                               const float* __restrict__ vals,
                               const int* __restrict__ ids,
                               const float* __restrict__ pv,
                               const float* __restrict__ pf, int dv, int m,
                               float* __restrict__ rows_v,
                               float* __restrict__ rows_f) {
  const float* v = vals + j * kk;
  const int* id = ids + j * kk;
  for (long long i = threadIdx.x; i < (long long)kk * dv; i += blockDim.x) {
    const long long e = i / dv;
    rows_v[j * kk * dv + i] =
        v[e] == -INFINITY ? 0.f : pv[(long long)id[e] * dv + (i - e * dv)];
  }
  for (long long i = threadIdx.x; i < (long long)kk * m; i += blockDim.x) {
    const long long e = i / m;
    rows_f[j * kk * m + i] =
        v[e] == -INFINITY ? 0.f : pf[(long long)id[e] * m + (i - e * m)];
  }
}

__global__ void __launch_bounds__(kThreads)
list_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_i,
                  const float* __restrict__ member,
                  const int* __restrict__ probes, int nsrc, int b, int nprobe,
                  int L, int kk, int cap, float* __restrict__ vals,
                  int* __restrict__ ids, const float* __restrict__ pv,
                  const float* __restrict__ pf, int dv, int m,
                  float* __restrict__ rows_v, float* __restrict__ rows_f) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                                  // (cap,)
  int* bi = reinterpret_cast<int*>(bs + cap);        // (cap,)
  float* thr_s = reinterpret_cast<float*>(bi + cap);
  int* thr_i = reinterpret_cast<int*>(thr_s + 1);
  int* cnt = thr_i + 1;

  const int tid = threadIdx.x;
  const long long j = blockIdx.x;
  const bool dedup = member != nullptr;
  for (int i = tid; i < cap; i += kThreads) {
    bs[i] = -INFINITY;
    bi[i] = INT_MAX;
  }
  if (tid == 0) {
    thr_s[0] = -INFINITY;
    thr_i[0] = -1;
    cnt[0] = 0;
  }
  __syncthreads();

  // the query's partials, kThreads candidates at a time: every thread tests
  // one source's member entry at once, and the chunk's partials are merged
  // in any order (the total order makes the result independent of it)
  __shared__ int parts[kThreads];
  __shared__ int nparts;
  const int nsources = dedup ? nsrc : nprobe;
  for (int base = 0; base < nsources; base += kThreads) {
    if (tid == 0) nparts = 0;
    __syncthreads();
    const int p = base + tid;
    if (p < nsources && (!dedup || member[(long long)p * b + j] > 0.5f))
      parts[atomicAdd(&nparts, 1)] = p;
    __syncthreads();
    for (int t = 0; t < nparts; ++t) {
      const long long part =
          dedup ? (long long)parts[t] * b + j : j * nprobe + parts[t];
      const float* src_s = part_s + part * kk;
      const int* src_i = part_i + part * kk;
      for (int e0 = 0; e0 < kk; e0 += kThreads) {
        const int e = e0 + tid;
        if (e < kk) {
          const float s = src_s[e];
          const int key = src_i[e];
          if (better(s, key, thr_s[0], thr_i[0])) {
            const int pos = atomicAdd(cnt, 1);
            bs[pos] = s;
            bi[pos] = key;
          }
        }
        __syncthreads();
        const bool full = cnt[0] > cap - kThreads;
        __syncthreads();
        if (full) trim(bs, bi, cnt, thr_s, thr_i, 1, cap, kk);
      }
    }
    __syncthreads();  // every thread is done with parts before the next chunk
  }
  trim(bs, bi, cnt, thr_s, thr_i, 1, cap, kk);

  // keys -> flat ids; unfilled slots read as (-inf, id 0)
  for (int e = tid; e < kk; e += kThreads) {
    const int key = bi[e];
    int id = 0;
    if (key != INT_MAX) {
      if (dedup) {
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

// Pass 1's dynamic shared memory for dc staged columns (staged_cols(d)).
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

size_t list_scan_smem(int cap, int dc) {
  const size_t ds = (size_t)dc + 4;
  const size_t words = kBQ * ds + kTile * ds + 3 * kTile + 4 * kBQ + 8 +
                       2 * (size_t)kBQ * cap;
  return words * sizeof(float);
}

template <int ET>
cudaError_t launch_list_scan(const void* grouped, const float* gsq,
                             const float* gsc, const float* valid,
                             const int* src_list, const float* member,
                             const int* offsets, int* next, const float* q,
                             int nsrc, int b, int nprobe, int L, int d, int kk,
                             int cap, float* part_s, int* part_i, float* sel,
                             cudaStream_t st) {
  if (sel != nullptr) cap = 0;
  const size_t smem = list_scan_smem(cap, staged_cols(d));
  cudaError_t err = cudaFuncSetAttribute(
      list_scan_kernel<ET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, list_scan_kernel<ET>, kThreads, smem);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card once; idle ones exit at once
  const long long most = member != nullptr
                             ? (long long)nsrc * ((b + kBQ - 1) / kBQ)
                             : nsrc;
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(most < fill ? most : fill);
  list_scan_kernel<ET><<<blocks, kThreads, smem, st>>>(
      static_cast<const typename Elem<ET>::T*>(grouped), gsq, gsc, valid,
      src_list, member, offsets, next, q, nsrc, b, nprobe, L, d, kk, cap,
      part_s, part_i, sel);
  return cudaGetLastError();
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
// element type (0 fp32, 1 bf16, 2 int8) and gsc (nlist, max_list) its
// per-slot scale, null for 1.0. member != nullptr selects the dedup
// scan (src_list = uniq, nsrc = s slots, member (s, b)); member == nullptr
// the batch scan (src_list = probes (b, nprobe), nsrc = b * nprobe).
// Buffered path (sel null): scratch part_s / part_i hold (nsrc * b, kk)
// entries for dedup and (b * nprobe, kk) for batch. Selection path (sel,
// a (b, nseg, max_list) fp32 scratch with nseg = nsrc for dedup and nprobe
// for batch, not null): cap, merge_cap and part_* are unused; sa holds the
// select's plan and scratch (select_common.cuh), null on the buffered
// path.
// work holds 2 * nsrc + 2 ints (the plan's offsets, the work counter, and
// each source's item count). The rows pointers (pv, pf, rows_v, rows_f) are
// all null for the ids-only variants.
extern "C" int fcvi_ivf_score_topk(
    const void* grouped, int et, const float* gsq, const float* gsc,
    const float* valid, const int* src_list, int nsrc, const float* member,
    const float* q, int b, int nprobe, int L, int d, int kk, int cap,
    int merge_cap, float* part_s, int* part_i, float* sel,
    const void* sel_args, int* work, float* vals, int* ids,
    const float* pv, const float* pf, int dv, int m, float* rows_v,
    float* rows_f, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (et != kF32 && et != kBF16 && et != kI8)
    return (int)cudaErrorInvalidValue;
  const SelectArgs* sa = static_cast<const SelectArgs*>(sel_args);
  if (sel != nullptr && sa == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (nsrc > 0) {
    int* offsets = work;
    int* next = work + nsrc + 1;
    err = cudaMemsetAsync(next, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    if (member != nullptr) {
      int* groups = next + 1;
      const long long warps = (long long)nsrc * 32;
      count_kernel<<<(unsigned)((warps + kThreads - 1) / kThreads), kThreads,
                     0, st>>>(member, nsrc, b, groups);
      offsets_kernel<<<1, kThreads, 0, st>>>(groups, nsrc, offsets);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    switch (et) {
      case kF32:
        err = launch_list_scan<kF32>(grouped, gsq, gsc, valid, src_list,
                                     member, offsets, next, q, nsrc, b,
                                     nprobe, L, d, kk, cap, part_s, part_i,
                                     sel, st);
        break;
      case kBF16:
        err = launch_list_scan<kBF16>(grouped, gsq, gsc, valid, src_list,
                                      member, offsets, next, q, nsrc, b,
                                      nprobe, L, d, kk, cap, part_s, part_i,
                                      sel, st);
        break;
      default:
        err = launch_list_scan<kI8>(grouped, gsq, gsc, valid, src_list,
                                    member, offsets, next, q, nsrc, b, nprobe,
                                    L, d, kk, cap, part_s, part_i, sel, st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  if (sel != nullptr) {
    const int nseg = member != nullptr ? nsrc : nprobe;
    err = select_passes(ListScores{sel, member, src_list, nseg, L, b}, *sa,
                        st);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = select_smem(*sa);
    err = cudaFuncSetAttribute(list_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    list_select_kernel<<<b, kSelThreads, smem, st>>>(
        *sa, sel, member, src_list, nsrc, nprobe, L, vals, ids, pv, pf, dv, m,
        rows_v, rows_f);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * (2 * (size_t)merge_cap + 4);
  err = cudaFuncSetAttribute(list_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  list_merge_kernel<<<b, kThreads, smem, st>>>(
      part_s, part_i, member, src_list, nsrc, b, nprobe, L, kk, merge_cap,
      vals, ids, pv, pf, dv, m, rows_v, rows_f);
  return (int)cudaGetLastError();
}
