// IVF list scans + first-occurrence top-k over the grouped slab layout, with
// an optional epilogue that gathers the winners' grouped payload rows.
//
// Replaces three Pallas kernels for the TPU, all in
// src/repro/kernels/ivf_score.py:
//   * ivf_score_topk_dedup (fp32): the probe-major scan of the batch's
//     unique probed lists, each query kept only on the lists it probed;
//   * ivf_score_topk_dedup_rows: the same (vals, ids), plus the winners'
//     payload_v / payload_f rows (dead slots carry zero rows);
//   * ivf_score_topk_batch (and ivf_score_topk, its batch-1 wrapper): the
//     query-major scan over a (b, nprobe) probe grid.
//
// Scores are 2 * <x, q> - ||x||^2 in IEEE fp32 (the ||q||^2 constant is
// left to the caller, as on the TPU), kept only where valid > 0.5 (and, for
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
// probed lists' rows once, some hundreds of MB, against well under a GFLOP
// of fp32 for the member pairs: the bytes take about 20 times as long as the
// operations at the card's peaks.
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
//     time through shared memory with cp.async, reading only the rows that
//     are valid and skipping tiles with none. Only member queries are
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
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

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
// groups is read from device memory about once and from L2 after.
__global__ void __launch_bounds__(kThreads)
list_scan_kernel(const float* __restrict__ grouped,
                 const float* __restrict__ gsq,
                 const float* __restrict__ valid,
                 const int* __restrict__ src_list,
                 const float* __restrict__ member,
                 const int* __restrict__ offsets, int* __restrict__ next,
                 const float* __restrict__ q, int nsrc, int b, int nprobe,
                 int L, int d, int kk, int cap, float* __restrict__ part_s,
                 int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  const int ds = d4 + 4;                         // padded stride: no conflicts
  const int ds4 = ds / 4;                        // 16-byte words per staged row
  float* qs = smem;                              // (kBQ, ds)
  float* xs = qs + kBQ * ds;                     // (kTile, ds)
  float* xsq_s = xs + kTile * ds;                // (kTile,)
  int* ok_s = reinterpret_cast<int*>(xsq_s + kTile);  // (kTile,)
  int* qidx = ok_s + kTile;                      // (kBQ,) member query ids
  float* thr_s = reinterpret_cast<float*>(qidx + kBQ);
  int* thr_i = reinterpret_cast<int*>(thr_s + kBQ);
  int* cnt = thr_i + kBQ;
  int* flag = cnt + kBQ;  // (8,): trim, members, source, group, live item
  float* bs = reinterpret_cast<float*>(flag + 8);  // (kBQ, cap)
  int* bi = reinterpret_cast<int*>(bs + kBQ * cap);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const bool dedup = member != nullptr;
  const int items = dedup ? offsets[nsrc] : nsrc;
  const bool vec =
      (d & 3) == 0 && (reinterpret_cast<uintptr_t>(grouped) & 15) == 0;
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
    const float* xg = grouped + (long long)list * L * d;
    const float* sqg = gsq + (long long)list * L;
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

    for (int i = tid; i < kBQ * ds; i += kThreads) {
      const int qi = i / ds;
      const int c = i - qi * ds;
      qs[i] = (qi < nact && c < d) ? q[(long long)qidx[qi] * d + c] : 0.f;
    }
    for (int i = tid; i < kBQ * cap; i += kThreads) {
      bs[i] = -INFINITY;
      bi[i] = INT_MAX;
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
      }
      if (!__syncthreads_or(ok)) continue;       // no valid row in the tile
      if (vec) {
        // every 16-byte copy of the tile in flight at once; invalid rows and
        // the pad columns are zero-filled without a read
        for (int i = tid; i < kTile * ds4; i += kThreads) {
          const int r = i / ds4;
          const int c = (i - r * ds4) * 4;
          const bool live = ok_s[r] && c < d;
          const float* from = live ? xg + (long long)(t0 + r) * d + c : xg;
          cp_async16(xs + r * ds + c, from, live ? 16 : 0);
        }
        cp_async_wait_all();
      } else {
        for (int r = warp; r < kTile; r += kWarps) {
          const bool live = ok_s[r];
          const float* srow = xg + (long long)(t0 + r) * d;
          float* dst = xs + r * ds;
          for (int c = lane; c < ds; c += 32)
            dst[c] = (live && c < d) ? srow[c] : 0.f;
        }
      }
      __syncthreads();

      float acc0 = 0.f, acc1 = 0.f;
      for (int c = 0; c < d4; c += 4) {
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
      if (qg < nact) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rg + h * kRowGroups;
          if (!ok_s[r]) continue;
          const float s =
              __fsub_rn(__fmul_rn(2.f, h == 0 ? acc0 : acc1), xsq_s[r]);
          const int key = key_base + t0 + r;
          if (better(s, key, thr_s[qg], thr_i[qg])) {
            const int pos = atomicAdd(&cnt[qg], 1);
            bs[qg * cap + pos] = s;
            bi[qg * cap + pos] = key;
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        int need = 0;
        for (int i = 0; i < nact; ++i) need |= cnt[i] > cap - kTile;
        flag[0] = need;
      }
      __syncthreads();
      if (flag[0]) trim(bs, bi, cnt, thr_s, thr_i, nact, cap, kk);
    }

    trim(bs, bi, cnt, thr_s, thr_i, nact, cap, kk);
    for (int i = tid; i < nact * kk; i += kThreads) {
      const int qi = i / kk;
      const int e = i - qi * kk;
      const long long p = dedup ? src * b + qidx[qi] : src;
      part_s[p * kk + e] = bs[qi * cap + e];
      part_i[p * kk + e] = bi[qi * cap + e];
    }
    __syncthreads();             // the next item reuses flag, qidx, qs and bs
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

  // keys -> flat ids; unfilled slots read as (-inf, id 0) and carry zero
  // rows (bi keeps -1 for them, for the gather below)
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
    bi[e] = key == INT_MAX ? -1 : id;
  }
  __syncthreads();
  if (rows_v == nullptr) return;
  for (long long i = tid; i < (long long)kk * dv; i += kThreads) {
    const long long e = i / dv;
    const long long c = i - e * dv;
    const int id = bi[e];
    rows_v[j * kk * dv + i] = id < 0 ? 0.f : pv[(long long)id * dv + c];
  }
  for (long long i = tid; i < (long long)kk * m; i += kThreads) {
    const long long e = i / m;
    const long long c = i - e * m;
    const int id = bi[e];
    rows_f[j * kk * m + i] = id < 0 ? 0.f : pf[(long long)id * m + c];
  }
}

size_t list_scan_smem(int cap, int d) {
  const size_t ds = (size_t)((d + 3) & ~3) + 4;
  const size_t words = kBQ * ds + kTile * ds + 2 * kTile + 4 * kBQ + 8 +
                       2 * (size_t)kBQ * cap;
  return words * sizeof(float);
}

}  // namespace

// One entry point for the three kernels. member != nullptr selects the dedup
// scan (src_list = uniq, nsrc = s slots, member (s, b)); member == nullptr
// the batch scan (src_list = probes (b, nprobe), nsrc = b * nprobe). Scratch
// part_s / part_i hold (nsrc * b, kk) entries for dedup and (b * nprobe, kk)
// for batch; work holds 2 * nsrc + 2 ints (the plan's offsets, the work
// counter, and each source's item count). The rows pointers (pv, pf, rows_v, rows_f) are all null for
// the ids-only variants.
extern "C" int fcvi_ivf_score_topk(
    const float* grouped, const float* gsq, const float* valid,
    const int* src_list, int nsrc, const float* member, const float* q, int b,
    int nprobe, int L, int d, int kk, int cap, int merge_cap, float* part_s,
    int* part_i, int* work, float* vals, int* ids, const float* pv,
    const float* pf, int dv, int m, float* rows_v, float* rows_f,
    void* stream) {
  if (b <= 0) return (int)cudaSuccess;
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
    const size_t smem = list_scan_smem(cap, d);
    err = cudaFuncSetAttribute(list_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, list_scan_kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    // enough blocks to fill the card once; idle ones exit at once
    const long long most = member != nullptr
                               ? (long long)nsrc * ((b + kBQ - 1) / kBQ)
                               : nsrc;
    const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const int blocks = (int)(most < fill ? most : fill);
    list_scan_kernel<<<blocks, kThreads, smem, st>>>(
        grouped, gsq, valid, src_list, member, offsets, next, q, nsrc, b,
        nprobe, L, d, kk, cap, part_s, part_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
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
