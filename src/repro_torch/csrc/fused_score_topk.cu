// Fused negative-squared-L2 scan + first-occurrence top-k, with an optional
// epilogue that gathers the winners' rows.
//
// Replaces src/repro/kernels/fused_score_topk.py::score_topk (the plain
// variant `_kernel`, at fp32 and bf16 storage, the int8 variant
// `_scaled_kernel`, and the filtered variants `_masked_kernel` (fp32, bf16)
// and `_masked_scaled_kernel` (int8)) and ::score_topk_rows (`_rows_kernel`
// at every storage dtype), Pallas kernels for the TPU.
//
// Rows are stored as fp32, bf16 or int8 codes (the storage ladder), with an
// optional per-row fp32 scale (int8). Scores are
// ((2 * <q, x>) * scale - ||x||^2) - ||q||^2 in IEEE fp32, the TPU kernels'
// order: the dot product accumulates in fp32 over the stored values cast up
// (exactly), and the scale multiplies its output, never the rows, so the
// rounding is the reference's and a missing scale (1.0) changes nothing.
// Results are ordered by (score desc, id asc), the TPU kernel's
// first-occurrence rule, so equal scores keep the smaller corpus id.
//
// The filtered variants take an optional per-row fp32 0/1 mask (the filter
// algebra's in-kernel mask plan): a row whose mask is <= 0.5 scores -inf
// after its score is formed, as the TPU kernel's select does, and a -inf
// score never beats a buffer's threshold, so it never enters. A tile with
// no eligible row is skipped before it is staged (__syncthreads_or), which
// changes no result. With fewer than kk eligible rows the unfilled slots
// read (-inf, id 0).
//
// Bound on the H100: operations. At the main path's shapes (64 queries,
// 1,000,000 x 128 fp32 rows) the scan is about 16.4 GFLOP on the fp32 CUDA
// cores (0.25 ms at 67 TFLOP/s) against 516 MB of reads (0.15 ms at
// 3.35 TB/s); bf16 and int8 rows move a half and a quarter of those bytes
// and leave the operations as they are. The tensor cores are not used: TF32
// would perturb the scores beyond what the exact refine absorbs, and bf16 or
// int8 products would round the fp32 queries.
//
// Design. The TPU kernel walks the corpus as a sequential grid axis and
// carries the running top-k in its output block. Blocks on Hopper run in
// parallel with no carry, so the corpus is split across blocks instead:
//
//   pass 1 (scan_kernel): one block per (query tile, corpus chunk). The
//     block stages kTile corpus rows at a time in shared memory as fp32, in
//     column chunks of kDC: fp32 rows with every 16-byte copy of the chunk
//     in flight at once (cp.async), bf16 and int8 rows through registers, up
//     to eight 16-byte loads a thread in flight, each cast up once as it is
//     stored (so the inner loop is the fp32 one, and shared memory holds no
//     second, raw copy of the tile); rows whose width is no multiple of 16
//     bytes take a slower scalar path. Each thread computes a QPT x 2
//     register tile of dot products, accumulating the chunks in ascending
//     column order, so a row of any width sums in the order a single chunk
//     would, and shared memory does not grow with d. Rows of at most kDC
//     columns take one chunk, with the query tile staged once. A score
//     enters its query's candidate buffer in shared memory only if it beats
//     the query's current threshold (the kk-th best seen so far); when a
//     buffer nears capacity all buffers are bitonic-sorted and cut back to
//     kk, which raises the thresholds. Each block writes its chunk's sorted
//     top-kk per query to scratch.
//   pass 2 (merge_kernel): one block per query merges the chunks' lists the
//     same way and writes the final top-kk. The rows variant then gathers
//     each winner's corpus row and payload rows by id: a gather is what the
//     TPU kernel's one-hot matmuls (pick_rows) stood in for.
//
// The selection path, for a kk whose buffers do not fit in shared memory or
// would shrink the query tile to 4 (the planner's choice; a caller may
// force either path): pass 1 writes every score to a (nq, n)
// scratch instead (-inf for masked rows), and select_kernel, one block per
// query, radix-selects and sorts the top-kk (select_common.cuh) with
// -0.0 and +0.0 taken as equal, as better() takes them. Its (vals, ids) are
// the buffered path's bits; the rows epilogue is the same function.
//
// The ragged corpus edge and the ragged query tile are masked inside the
// kernels, so the caller never pads (and never copies) the corpus.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "select_common.cuh"
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                      // corpus rows per stage
constexpr int kRowGroups = 64;                  // threads along the row axis
constexpr int kQueryGroups = kThreads / kRowGroups;
constexpr int kWarps = kThreads / 32;

template <int ET, int QPT>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const typename Elem<ET>::T* __restrict__ x,
            const float* __restrict__ xsq, const float* __restrict__ scale,
            const float* __restrict__ mask,
            const float* __restrict__ q, long long n, int nq, int d, int kk,
            int cap, long long chunk_rows, float* __restrict__ part_s,
            int* __restrict__ part_i, float* __restrict__ sel) {
  constexpr int BQ = kQueryGroups * QPT;
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  const int dc = staged_cols(d);
  const bool one_chunk = d4 <= kDC;
  const int ds = dc + 4;                         // padded stride: no bank conflicts
  const int ds4 = ds / 4;                        // 16-byte words per staged row
  float* qs = smem;                              // (BQ, ds)
  float* xs = qs + BQ * ds;                      // (kTile, ds)
  float* xsq_s = xs + kTile * ds;                // (kTile,)
  float* sc_s = xsq_s + kTile;                   // (kTile,) 1.0 without scale
  float* mk_s = sc_s + kTile;                    // (kTile,) 1 eligible, 0 not
  float* qsq_s = mk_s + kTile;                   // (BQ,)
  float* thr_s = qsq_s + BQ;                     // (BQ,)
  int* thr_i = reinterpret_cast<int*>(thr_s + BQ);
  int* cnt = thr_i + BQ;
  int* flag = cnt + BQ;                          // (4,)
  float* bs = reinterpret_cast<float*>(flag + 4);  // (BQ, cap); none if sel
  int* bi = reinterpret_cast<int*>(bs + BQ * cap);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const long long r_begin = (long long)blockIdx.y * chunk_rows;
  const long long r_end =
      r_begin + chunk_rows < n ? r_begin + chunk_rows : n;
  const bool select = sel != nullptr;

  // the query tile's columns [c0, c0 + dc), zero past d and past nq
  auto stage_q = [&](int c0) {
    for (int i = tid; i < BQ * ds; i += kThreads) {
      const int qi = i / ds;
      const int c = i - qi * ds;
      qs[i] = (q0 + qi < nq && c < dc && c0 + c < d)
                  ? q[(long long)(q0 + qi) * d + c0 + c]
                  : 0.f;
    }
  };
  if (one_chunk) stage_q(0);
  if (!select) {
    for (int i = tid; i < BQ * cap; i += kThreads) {
      bs[i] = -INFINITY;
      bi[i] = INT_MAX;
    }
  }
  if (tid < BQ) {
    thr_s[tid] = -INFINITY;
    thr_i[tid] = -1;
    cnt[tid] = 0;
    // ||q||^2 over the full width, in column order
    float acc = 0.f;
    if (q0 + tid < nq) {
      const float* qr = q + (long long)(q0 + tid) * d;
      for (int c = 0; c < d; ++c) acc = fmaf(qr[c], qr[c], acc);
    }
    qsq_s[tid] = acc;
  }

  const bool vec = (d * sizeof(*x)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int rg = tid % kRowGroups;
  const int qg = tid / kRowGroups;
  const float* xa = xs + rg * ds;
  const float* xb = xs + (rg + kRowGroups) * ds;
  const float* qb = qs + qg * QPT * ds;

  for (long long t0 = r_begin; t0 < r_end; t0 += kTile) {
    const int rows = (int)(r_end - t0 < kTile ? r_end - t0 : kTile);
    __syncthreads();  // the previous stage's readers are done with xs
    if (mask != nullptr) {
      // the tile's eligibility; a tile with no eligible row is not staged
      int ok = 0;
      if (tid < kTile) {
        ok = tid < rows && mask[t0 + tid] > 0.5f;
        mk_s[tid] = ok ? 1.f : 0.f;
      }
      if (!__syncthreads_or(ok)) {
        if (select) {
          for (int i = tid; i < BQ * rows; i += kThreads) {
            const int qi = i / rows;
            if (q0 + qi < nq)
              sel[(long long)(q0 + qi) * n + t0 + (i - qi * rows)] = -INFINITY;
          }
        }
        continue;
      }
    }
    if (tid < kTile) {
      xsq_s[tid] = tid < rows ? xsq[t0 + tid] : 0.f;
      sc_s[tid] = tid < rows && scale != nullptr ? scale[t0 + tid] : 1.f;
    }

    float acc0[QPT], acc1[QPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      acc0[i] = 0.f;
      acc1[i] = 0.f;
    }
    for (int c0 = 0; c0 < d4; c0 += kDC) {
      if (c0 > 0) __syncthreads();  // the previous chunk's readers are done
      if (!one_chunk) stage_q(c0);
      if (vec && ET == kF32) {
        // every 16-byte copy of the chunk in flight at once; rows past the
        // corpus chunk and the pad columns are zero-filled by the copy
        const float* xf = reinterpret_cast<const float*>(x);
        for (int i = tid; i < kTile * ds4; i += kThreads) {
          const int r = i / ds4;
          const int c = (i - r * ds4) * 4;
          const bool ok = r < rows && c < dc && c0 + c < d;
          cp_async16(xs + r * ds + c, ok ? xf + (t0 + r) * d + c0 + c : xf,
                     ok ? 16 : 0);
        }
        cp_async_wait_all();
      } else if (vec) {
        if constexpr (ET != kF32)
          stage_up<ET, kTile, kThreads>(
              xs, ds, x + t0 * d + c0, d, rows,
              d - c0 < kDC ? d - c0 : kDC, [](int) { return true; });
      } else {
        for (int r = warp; r < kTile; r += kWarps) {
          const bool ok = r < rows;
          const long long row = (t0 + r) * d + c0;
          float* dst = xs + r * ds;
          for (int c = lane; c < ds; c += 32)
            dst[c] = (ok && c < dc && c0 + c < d) ? Elem<ET>::at(x, row + c)
                                                  : 0.f;
        }
      }
      __syncthreads();

      const int cw4 = d4 - c0 < kDC ? d4 - c0 : kDC;
      for (int c = 0; c < cw4; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(xa + c);
        const float4 b = *reinterpret_cast<const float4*>(xb + c);
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const float4 u = *reinterpret_cast<const float4*>(qb + i * ds + c);
          acc0[i] = fmaf(u.x, a.x, acc0[i]);
          acc0[i] = fmaf(u.y, a.y, acc0[i]);
          acc0[i] = fmaf(u.z, a.z, acc0[i]);
          acc0[i] = fmaf(u.w, a.w, acc0[i]);
          acc1[i] = fmaf(u.x, b.x, acc1[i]);
          acc1[i] = fmaf(u.y, b.y, acc1[i]);
          acc1[i] = fmaf(u.z, b.z, acc1[i]);
          acc1[i] = fmaf(u.w, b.w, acc1[i]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int qi = qg * QPT + i;
      if (q0 + qi >= nq) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rg + h * kRowGroups;
        if (r >= rows) continue;
        const float dot = h == 0 ? acc0[i] : acc1[i];
        float s = __fsub_rn(
            __fsub_rn(__fmul_rn(__fmul_rn(2.f, dot), sc_s[r]), xsq_s[r]),
            qsq_s[qi]);
        if (mask != nullptr && mk_s[r] == 0.f) s = -INFINITY;
        const int rid = (int)(t0 + r);
        if (select) {
          sel[(long long)(q0 + qi) * n + rid] = s;
        } else if (better(s, rid, thr_s[qi], thr_i[qi])) {
          const int pos = atomicAdd(&cnt[qi], 1);
          bs[qi * cap + pos] = s;
          bi[qi * cap + pos] = rid;
        }
      }
    }
    if (select) continue;
    __syncthreads();
    if (tid == 0) {
      int need = 0;
      for (int i = 0; i < BQ; ++i) need |= cnt[i] > cap - kTile;
      flag[0] = need;
    }
    __syncthreads();
    if (flag[0]) trim(bs, bi, cnt, thr_s, thr_i, BQ, cap, kk);
  }
  if (select) return;

  trim(bs, bi, cnt, thr_s, thr_i, BQ, cap, kk);
  const long long nchunks = gridDim.y;
  for (int i = tid; i < BQ * kk; i += kThreads) {
    const int qi = i / kk;
    const int j = i - qi * kk;
    if (q0 + qi >= nq) continue;
    const long long o = ((long long)(q0 + qi) * nchunks + blockIdx.y) * kk + j;
    part_s[o] = bs[qi * cap + j];
    part_i[o] = bi[qi * cap + j];
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

template <int ET>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             long long len, int kk, int cap, float* __restrict__ vals,
             int* __restrict__ ids, const typename Elem<ET>::T* __restrict__ x,
             const float* __restrict__ scale,
             const float* __restrict__ pv, const float* __restrict__ pf, int d,
             int dv, int m, float* __restrict__ rows_x,
             float* __restrict__ rows_v, float* __restrict__ rows_f) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                                  // (cap,)
  int* bi = reinterpret_cast<int*>(bs + cap);        // (cap,)
  float* thr_s = reinterpret_cast<float*>(bi + cap);
  int* thr_i = reinterpret_cast<int*>(thr_s + 1);
  int* cnt = thr_i + 1;

  const int tid = threadIdx.x;
  const long long qi = blockIdx.x;
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

  const float* src_s = part_s + qi * len;
  const int* src_i = part_i + qi * len;
  for (long long t0 = 0; t0 < len; t0 += kThreads) {
    const long long t = t0 + tid;
    if (t < len) {
      const float s = src_s[t];
      const int id = src_i[t];
      if (better(s, id, thr_s[0], thr_i[0])) {
        const int pos = atomicAdd(cnt, 1);
        bs[pos] = s;
        bi[pos] = id;
      }
    }
    __syncthreads();
    const bool full = cnt[0] > cap - kThreads;
    __syncthreads();
    if (full) trim(bs, bi, cnt, thr_s, thr_i, 1, cap, kk);
  }
  trim(bs, bi, cnt, thr_s, thr_i, 1, cap, kk);

  // unfilled slots (fewer than kk finite scores) read as (-inf, id 0)
  for (int j = tid; j < kk; j += kThreads) {
    vals[qi * kk + j] = bs[j];
    ids[qi * kk + j] = bi[j] == INT_MAX ? 0 : bi[j];
  }
  if (rows_x == nullptr) return;
  __syncthreads();
  gather_rows<ET>(qi, kk, ids, x, scale, pv, pf, d, dv, m, rows_x, rows_v,
                  rows_f);
}

// A query's scores in the selection path: a -inf (masked) or NaN score does
// not compete, as it never beats a buffer's threshold; -0.0 counts as +0.0.
struct FlatScores {
  const float* s;
  long long n;
  __device__ long long size() const { return n; }
  __device__ bool get(long long e, u64* w) const {
    const float v = s[e];
    if (!(v > -INFINITY)) return false;
    *w = pack(ord_bits_eq0(v), (int)e);
    return true;
  }
};

// The selection path's pass 2: one block per query over its row of the
// (nq, n) score scratch. Sorts in shared memory, or in (nq, len) device
// scratch sw / spos when those are given.
template <int ET>
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const float* __restrict__ sel, long long n, int kk, int len,
              u64* __restrict__ sw, int* __restrict__ spos,
              float* __restrict__ vals, int* __restrict__ ids,
              const typename Elem<ET>::T* __restrict__ x,
              const float* __restrict__ scale, const float* __restrict__ pv,
              const float* __restrict__ pf, int d, int dv, int m,
              float* __restrict__ rows_x, float* __restrict__ rows_v,
              float* __restrict__ rows_f) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  __shared__ SelectState st;
  const long long qi = blockIdx.x;
  u64* w = sw != nullptr ? sw + qi * len : reinterpret_cast<u64*>(sel_smem);
  int* pos = sw != nullptr ? spos + qi * len : reinterpret_cast<int*>(w + len);
  const float* s = sel + qi * n;
  const int count = select_sorted(FlatScores{s, n}, kk, w, pos, len, &st);
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    vals[qi * kk + j] = j < count ? s[pos[j]] : -INFINITY;
    ids[qi * kk + j] = j < count ? pos[j] : 0;
  }
  if (rows_x == nullptr) return;
  __syncthreads();
  gather_rows<ET>(qi, kk, ids, x, scale, pv, pf, d, dv, m, rows_x, rows_v,
                  rows_f);
}

// Pass 1's dynamic shared memory for dc staged columns (staged_cols(d)).
size_t scan_smem(int bq, int cap, int dc) {
  const size_t ds = (size_t)dc + 4;
  const size_t words = bq * ds + kTile * ds + 3 * kTile + 4 * (size_t)bq +
                       4 + 2 * (size_t)bq * cap;
  return words * sizeof(float);
}

template <int ET, int QPT>
cudaError_t launch_scan(const typename Elem<ET>::T* x, const float* xsq,
                        const float* scale, const float* mask,
                        const float* q, long long n, int nq, int d, int kk,
                        int cap, int nchunks, long long chunk_rows,
                        float* part_s, int* part_i, float* sel,
                        cudaStream_t stream) {
  constexpr int BQ = kQueryGroups * QPT;
  const size_t smem =
      scan_smem(BQ, sel != nullptr ? 0 : cap, staged_cols(d));
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<ET, QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, nchunks);
  scan_kernel<ET, QPT><<<grid, kThreads, smem, stream>>>(
      x, xsq, scale, mask, q, n, nq, d, kk, sel != nullptr ? 0 : cap,
      chunk_rows, part_s, part_i, sel);
  return cudaGetLastError();
}

template <int ET>
int score_topk(const void* xv, const float* xsq, const float* scale,
               const float* mask, const float* q, long long n, int nq, int d,
               int kk, int bq, int cap, int nchunks, long long chunk_rows,
               int merge_cap, float* part_s, int* part_i, float* sel,
               int sort_len, u64* sort_w, int* sort_pos, float* vals,
               int* ids, const float* pv, const float* pf, int dv, int m,
               float* rows_x, float* rows_v, float* rows_f, cudaStream_t st) {
  const auto* x = static_cast<const typename Elem<ET>::T*>(xv);
  cudaError_t err;
  switch (bq) {
    case 16:
      err = launch_scan<ET, 4>(x, xsq, scale, mask, q, n, nq, d, kk, cap,
                               nchunks, chunk_rows, part_s, part_i, sel, st);
      break;
    case 8:
      err = launch_scan<ET, 2>(x, xsq, scale, mask, q, n, nq, d, kk, cap,
                               nchunks, chunk_rows, part_s, part_i, sel, st);
      break;
    case 4:
      err = launch_scan<ET, 1>(x, xsq, scale, mask, q, n, nq, d, kk, cap,
                               nchunks, chunk_rows, part_s, part_i, sel, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (sel != nullptr) {
    const size_t smem = select_smem(sort_len, sort_w == nullptr);
    err = cudaFuncSetAttribute(select_kernel<ET>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    select_kernel<ET><<<nq, kSelThreads, smem, st>>>(
        sel, n, kk, sort_len, sort_w, sort_pos, vals, ids, x, scale, pv, pf,
        d, dv, m, rows_x, rows_v, rows_f);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * (2 * (size_t)merge_cap + 4);
  err = cudaFuncSetAttribute(merge_kernel<ET>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<ET><<<nq, kThreads, smem, st>>>(
      part_s, part_i, (long long)nchunks * kk, kk, merge_cap, vals, ids, x,
      scale, pv, pf, d, dv, m, rows_x, rows_v, rows_f);
  return (int)cudaGetLastError();
}

}  // namespace

// et selects the stored element type of x (0 fp32, 1 bf16, 2 int8); scale
// (n,) is the per-row dequantization scale, null for 1.0; mask (n,) is the
// per-row 0/1 eligibility of the filtered variants, null for every row.
// Buffered path (sel null): scratch part_s / part_i hold (nq, nchunks, kk)
// entries. Selection path (sel, an (nq, n) fp32 scratch, not null): cap and
// merge_cap are unused; the selection sorts sort_len (a power of two >= kk)
// words a query in shared memory, or in the (nq, sort_len) scratch sort_w /
// sort_pos when those are not null. The rows pointers (pv, pf, rows_x,
// rows_v, rows_f) are all null for the ids-only variant.
extern "C" int fcvi_score_topk(const void* x, int et, const float* xsq,
                               const float* scale, const float* mask,
                               const float* q, long long n, int nq, int d,
                               int kk, int bq, int cap, int nchunks,
                               long long chunk_rows, int merge_cap,
                               float* part_s, int* part_i, float* sel,
                               int sort_len, void* sort_w, int* sort_pos,
                               float* vals, int* ids, const float* pv,
                               const float* pf, int dv, int m, float* rows_x,
                               float* rows_v, float* rows_f, void* stream) {
  if (nq <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  u64* sw = static_cast<u64*>(sort_w);
  switch (et) {
    case kF32:
      return score_topk<kF32>(x, xsq, scale, mask, q, n, nq, d, kk, bq, cap,
                              nchunks, chunk_rows, merge_cap, part_s, part_i,
                              sel, sort_len, sw, sort_pos, vals, ids, pv, pf,
                              dv, m, rows_x, rows_v, rows_f, st);
    case kBF16:
      return score_topk<kBF16>(x, xsq, scale, mask, q, n, nq, d, kk, bq, cap,
                               nchunks, chunk_rows, merge_cap, part_s, part_i,
                               sel, sort_len, sw, sort_pos, vals, ids, pv, pf,
                               dv, m, rows_x, rows_v, rows_f, st);
    case kI8:
      return score_topk<kI8>(x, xsq, scale, mask, q, n, nq, d, kk, bq, cap,
                             nchunks, chunk_rows, merge_cap, part_s, part_i,
                             sel, sort_len, sw, sort_pos, vals, ids, pv, pf,
                             dv, m, rows_x, rows_v, rows_f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
