// Fused negative-squared-L2 scan + first-occurrence top-k, with an optional
// epilogue that gathers the winners' rows.
//
// Replaces src/repro/kernels/fused_score_topk.py::score_topk (plain variant)
// and ::score_topk_rows (fp32 storage), Pallas kernels for the TPU.
//
// Scores are 2 * <q, x> - ||x||^2 - ||q||^2 in IEEE fp32, the TPU kernel's
// order. Results are ordered by (score desc, id asc), the TPU kernel's
// first-occurrence rule, so equal scores keep the smaller corpus id.
//
// Bound on the H100: operations. At the main path's shapes (64 queries,
// 1,000,000 x 128 fp32 rows) the scan is about 16.4 GFLOP on the fp32 CUDA
// cores (0.25 ms at 67 TFLOP/s) against 516 MB of reads (0.15 ms at
// 3.35 TB/s). The tensor cores are not used: TF32 would perturb the scores
// beyond what the exact refine absorbs.
//
// Design. The TPU kernel walks the corpus as a sequential grid axis and
// carries the running top-k in its output block. Blocks on Hopper run in
// parallel with no carry, so the corpus is split across blocks instead:
//
//   pass 1 (scan_kernel): one block per (query tile, corpus chunk). The
//     block stages kTile corpus rows at a time in shared memory, with every
//     16-byte copy of the tile in flight at once (cp.async; rows whose
//     width is no multiple of 4 floats take a slower scalar path), and each
//     thread computes a QPT x 2 register tile of dot products. A score
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
// The ragged corpus edge and the ragged query tile are masked inside the
// kernels, so the caller never pads (and never copies) the corpus.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                      // corpus rows per stage
constexpr int kRowGroups = 64;                  // threads along the row axis
constexpr int kQueryGroups = kThreads / kRowGroups;
constexpr int kWarps = kThreads / 32;

template <int QPT>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ x, const float* __restrict__ xsq,
            const float* __restrict__ q, long long n, int nq, int d, int kk,
            int cap, long long chunk_rows, float* __restrict__ part_s,
            int* __restrict__ part_i) {
  constexpr int BQ = kQueryGroups * QPT;
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  const int ds = d4 + 4;                         // padded stride: no bank conflicts
  const int ds4 = ds / 4;                        // 16-byte words per staged row
  float* qs = smem;                              // (BQ, ds)
  float* xs = qs + BQ * ds;                      // (kTile, ds)
  float* xsq_s = xs + kTile * ds;                // (kTile,)
  float* qsq_s = xsq_s + kTile;                  // (BQ,)
  float* thr_s = qsq_s + BQ;                     // (BQ,)
  int* thr_i = reinterpret_cast<int*>(thr_s + BQ);
  int* cnt = thr_i + BQ;
  int* flag = cnt + BQ;                          // (4,)
  float* bs = reinterpret_cast<float*>(flag + 4);  // (BQ, cap)
  int* bi = reinterpret_cast<int*>(bs + BQ * cap);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const long long r_begin = (long long)blockIdx.y * chunk_rows;
  const long long r_end =
      r_begin + chunk_rows < n ? r_begin + chunk_rows : n;

  for (int i = tid; i < BQ * ds; i += kThreads) {
    const int qi = i / ds;
    const int c = i - qi * ds;
    qs[i] = (q0 + qi < nq && c < d) ? q[(long long)(q0 + qi) * d + c] : 0.f;
  }
  for (int i = tid; i < BQ * cap; i += kThreads) {
    bs[i] = -INFINITY;
    bi[i] = INT_MAX;
  }
  if (tid < BQ) {
    thr_s[tid] = -INFINITY;
    thr_i[tid] = -1;
    cnt[tid] = 0;
  }
  __syncthreads();
  if (tid < BQ) {
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(qs[tid * ds + c], qs[tid * ds + c], acc);
    qsq_s[tid] = acc;
  }

  const bool vec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int rg = tid % kRowGroups;
  const int qg = tid / kRowGroups;
  const float* xa = xs + rg * ds;
  const float* xb = xs + (rg + kRowGroups) * ds;
  const float* qb = qs + qg * QPT * ds;

  for (long long t0 = r_begin; t0 < r_end; t0 += kTile) {
    const int rows = (int)(r_end - t0 < kTile ? r_end - t0 : kTile);
    __syncthreads();  // the previous stage's readers are done with xs
    if (vec) {
      // every 16-byte copy of the tile in flight at once; rows past the
      // chunk and the pad columns are zero-filled by the copy itself
      for (int i = tid; i < kTile * ds4; i += kThreads) {
        const int r = i / ds4;
        const int c = (i - r * ds4) * 4;
        const bool ok = r < rows && c < d;
        cp_async16(xs + r * ds + c, ok ? x + (t0 + r) * d + c : x, ok ? 16 : 0);
      }
      cp_async_wait_all();
    } else {
      for (int r = warp; r < kTile; r += kWarps) {
        const bool ok = r < rows;
        const float* src = x + (t0 + r) * d;
        float* dst = xs + r * ds;
        for (int c = lane; c < ds; c += 32) dst[c] = (ok && c < d) ? src[c] : 0.f;
      }
    }
    if (tid < kTile) xsq_s[tid] = tid < rows ? xsq[t0 + tid] : 0.f;
    __syncthreads();

    float acc0[QPT], acc1[QPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      acc0[i] = 0.f;
      acc1[i] = 0.f;
    }
    for (int c = 0; c < d4; c += 4) {
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

#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int qi = qg * QPT + i;
      if (q0 + qi >= nq) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rg + h * kRowGroups;
        if (r >= rows) continue;
        const float dot = h == 0 ? acc0[i] : acc1[i];
        const float s = __fsub_rn(__fsub_rn(__fmul_rn(2.f, dot), xsq_s[r]),
                                  qsq_s[qi]);
        const int rid = (int)(t0 + r);
        if (better(s, rid, thr_s[qi], thr_i[qi])) {
          const int pos = atomicAdd(&cnt[qi], 1);
          bs[qi * cap + pos] = s;
          bi[qi * cap + pos] = rid;
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      int need = 0;
      for (int i = 0; i < BQ; ++i) need |= cnt[i] > cap - kTile;
      flag[0] = need;
    }
    __syncthreads();
    if (flag[0]) trim(bs, bi, cnt, thr_s, thr_i, BQ, cap, kk);
  }

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

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             long long len, int kk, int cap, float* __restrict__ vals,
             int* __restrict__ ids, const float* __restrict__ x,
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
  for (long long i = tid; i < (long long)kk * d; i += kThreads) {
    const long long j = i / d;
    const long long c = i - j * d;
    const long long id = bi[j] == INT_MAX ? 0 : bi[j];
    rows_x[qi * kk * d + i] = x[id * d + c];
  }
  for (long long i = tid; i < (long long)kk * dv; i += kThreads) {
    const long long j = i / dv;
    const long long c = i - j * dv;
    const long long id = bi[j] == INT_MAX ? 0 : bi[j];
    rows_v[qi * kk * dv + i] = pv[id * dv + c];
  }
  for (long long i = tid; i < (long long)kk * m; i += kThreads) {
    const long long j = i / m;
    const long long c = i - j * m;
    const long long id = bi[j] == INT_MAX ? 0 : bi[j];
    rows_f[qi * kk * m + i] = pf[id * m + c];
  }
}

size_t scan_smem(int bq, int cap, int d) {
  const size_t ds = (size_t)((d + 3) & ~3) + 4;
  const size_t words = bq * ds + kTile * ds + kTile + 4 * (size_t)bq + 4 +
                       2 * (size_t)bq * cap;
  return words * sizeof(float);
}

template <int QPT>
cudaError_t launch_scan(const float* x, const float* xsq, const float* q,
                        long long n, int nq, int d, int kk, int cap,
                        int nchunks, long long chunk_rows, float* part_s,
                        int* part_i, cudaStream_t stream) {
  constexpr int BQ = kQueryGroups * QPT;
  const size_t smem = scan_smem(BQ, cap, d);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nq + BQ - 1) / BQ, nchunks);
  scan_kernel<QPT><<<grid, kThreads, smem, stream>>>(
      x, xsq, q, n, nq, d, kk, cap, chunk_rows, part_s, part_i);
  return cudaGetLastError();
}

}  // namespace

// Scratch part_s / part_i hold (nq, nchunks, kk) entries. The rows pointers
// (pv, pf, rows_x, rows_v, rows_f) are all null for the ids-only variant.
extern "C" int fcvi_score_topk(const float* x, const float* xsq, const float* q,
                               long long n, int nq, int d, int kk, int bq,
                               int cap, int nchunks, long long chunk_rows,
                               int merge_cap, float* part_s, int* part_i,
                               float* vals, int* ids, const float* pv,
                               const float* pf, int dv, int m, float* rows_x,
                               float* rows_v, float* rows_f, void* stream) {
  if (nq <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (bq) {
    case 16:
      err = launch_scan<4>(x, xsq, q, n, nq, d, kk, cap, nchunks, chunk_rows,
                           part_s, part_i, st);
      break;
    case 8:
      err = launch_scan<2>(x, xsq, q, n, nq, d, kk, cap, nchunks, chunk_rows,
                           part_s, part_i, st);
      break;
    case 4:
      err = launch_scan<1>(x, xsq, q, n, nq, d, kk, cap, nchunks, chunk_rows,
                           part_s, part_i, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (2 * (size_t)merge_cap + 4);
  err = cudaFuncSetAttribute(merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<nq, kThreads, smem, st>>>(
      part_s, part_i, (long long)nchunks * kk, kk, merge_cap, vals, ids, x, pv,
      pf, d, dv, m, rows_x, rows_v, rows_f);
  return (int)cudaGetLastError();
}
