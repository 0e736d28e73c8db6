// PQ asymmetric-distance (ADC) kernels: the LUT cross term, the
// gather-accumulate scans, and the fused ADC scan + top-k of the serving
// path.
//
// Replaces three Pallas kernels for the TPU, all in
// src/repro/kernels/pq_lut.py:
//   * pq_lut_qdot: out[i, m, j] = <q_sub[i, m], codebook[m, j]>, the
//     q . codebook cross term of compute_luts, (b, M, dsub) x
//     (M, ksub, dsub) -> (b, M, ksub);
//   * pq_score_batch: d2[i, r] = sum_m luts[i, m, codes[r, m]], codes
//     (n, M), luts (b, M, K) -> (b, n). Callers pass the combined
//     (coarse id * ksub + code) index, so K = ncoarse * ksub;
//   * pq_score: the same at one LUT, (n, M) x (M, K) -> (n,). Launched as
//     pq_score_batch at b = 1 (the wrapper counts it apart).
//
// pq_lut_qdot. Bound on the H100: launch latency. At the serving shapes
// (64, 8, 16) x (8, 256, 16) it does about 4.2 MFLOP on about 0.7 MB. One
// block per (query tile of kQTile, subspace m) stages codebook[m] (ksub x
// dsub fp32, 16 KB at the default shapes) in shared memory with its rows
// padded to an odd stride, so the lanes that read consecutive codewords hit
// distinct banks; one thread per (query, codeword) sums the dsub products in
// fp32 with fmaf, in order. No matrix unit: dsub = 16 is too short a depth
// to pay for one, and the call is a microsecond of work.
//
// pq_score_batch. Bound on the H100: bytes in principle (the (b, n) fp32
// output dominates: 256 MB at b = 64, n = 1M, against 32 MB of int32 codes
// and 16.8 MB of LUTs), but in practice the b * n * M random 4-byte LUT
// reads. The TPU kernel keeps one query's (M, K) LUT resident in VMEM and
// turns each subspace's gather into a one-hot matmul. On Hopper one query's
// combined LUT, 8 x 32 x 256 fp32 = 256 KB, does not fit in the 227 KB of
// shared memory a block can have, and the corpus rows are in corpus order,
// not grouped by coarse id, so no smaller slice of it serves a tile of rows.
// The design kept here is the simple one: a block owns a tile of kRowTile
// rows (one per thread) and a group of up to kQGroup queries; it stages the
// tile's codes in shared memory, transposed to (M, kRowTile) so the lanes
// read consecutive words, and reads the LUT entries through the read-only
// path (__ldg). The whole batch's LUTs, 16.8 MB, stay in the 50 MB L2. Each
// thread walks the subspaces in order and, per subspace, issues the kQGroup
// queries' loads together (independent addresses, so they overlap), adding
// each into its query's accumulator: every sum is the left-to-right fp32
// sum over m = 0..M-1 that the TPU kernel's one-hot matmuls give. Output
// offsets are 64-bit (b * n passes 2^31 at n >= 34M for b = 64); writes
// are coalesced along the rows. No serving path launches it: pq.search
// takes the fused scan below; the tests and pq_score (B10) keep it.
//
// pq_score_topk: the serving path's redesign of pq_score_batch and the
// first-occurrence top-k of its negated distances (the reference's
// pq.search runs lax.top_k(-pq_score_batch(...))), as one kernel that never
// writes the (b, n) distance matrix. Bound on the H100: bytes in principle
// (the grouped uint8 codes, row ids and the batch's LUTs, about 29 MB at
// b = 64, n = 1M, M = 8, against b * n * M adds), in practice its
// shared-memory LUT reads and its candidate buffers. The rows are laid out
// once, at build, stably grouped by coarse id (codes, original row ids,
// group offsets), so a run of rows reads one coarse id's (M, ksub) slice
// of the scan LUT, luts[q, m, c * ksub:(c + 1) * ksub]: 8 KB a query at
// M = 8, ksub = 256. Pass 1 (pq_topk_kernel): one block per (query tile of
// bq, chunk of grouped rows), about two blocks per SM per query tile; for
// each coarse group the chunk touches, the block stages the tile's slices
// in shared memory (or reads them from L2 when one query's slice does not
// fit), then scores one row per thread as the left-to-right fp32 sum over
// m of the staged entries, started from the first (the plain version's
// value, bit for bit), and negates it. A score enters its query's
// thresholded candidate buffer as one 64-bit word, (order-preserving bits
// of -d2) << 32 | ~(original row id): topk_first_packed's key, so -0.0
// ranks below +0.0 and equal scores go to the smaller row, as lax.top_k
// orders them. When a buffer nears capacity, every buffer of the tile is
// bitonic-sorted and cut to kk; the block writes its chunk's top-kk words.
// These cuts, not the LUT reads, take most of its time (measured by
// scripts/profile_topk.py: the scan without buffers is a third of it). Pass 2
// (pq_merge_kernel): one block per query merges the chunks' words and
// decodes the final (vals, ids). The selection path (the buffers do not
// fit, or would shrink the tile to 4; or the caller asks): pass 1 writes
// every -d2 to a (b, n) scratch in grouped order, then the multi-block
// radix select of select_common.cuh (its passes, then pq_select_kernel,
// one block per query) takes the top-kk words by the same key.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQTile = 8;      // queries per pq_lut_qdot block
constexpr int kRowTile = kThreads;  // rows per pq_score block
constexpr int kQGroup = 8;     // queries per pq_score block
constexpr int kMaxBQ = 16;     // queries per pq_topk block, at most

__global__ void __launch_bounds__(kThreads)
pq_lut_qdot_kernel(const float* __restrict__ q_sub,
                   const float* __restrict__ cb, float* __restrict__ out,
                   int b, int M, int ksub, int dsub) {
  extern __shared__ float smem[];
  const int ds = dsub | 1;              // odd stride: conflict-free reads
  float* cb_s = smem;                   // (ksub, ds)
  float* q_s = smem + (size_t)ksub * ds;  // (kQTile, dsub)
  const int m = blockIdx.y;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, b - q0);
  const float* cbm = cb + (long long)m * ksub * dsub;
  for (int i = threadIdx.x; i < ksub * dsub; i += kThreads) {
    const int j = i / dsub;
    cb_s[j * ds + (i - j * dsub)] = cbm[i];
  }
  for (int i = threadIdx.x; i < nq * dsub; i += kThreads) {
    const int r = i / dsub;
    q_s[i] = q_sub[((long long)(q0 + r) * M + m) * dsub + (i - r * dsub)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * ksub; i += kThreads) {
    const int r = i / ksub;
    const int j = i - r * ksub;
    const float* c = cb_s + j * ds;
    const float* x = q_s + r * dsub;
    float acc = 0.f;
    for (int t = 0; t < dsub; ++t) acc = fmaf(x[t], c[t], acc);
    out[((long long)(q0 + r) * M + m) * ksub + j] = acc;
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
pq_score_kernel(const CodeT* __restrict__ codes,
                const float* __restrict__ luts, float* __restrict__ out,
                long long n, int b, int M, int K) {
  extern __shared__ int code_s[];       // (M, kRowTile), transposed
  const long long row0 = (long long)blockIdx.x * kRowTile;
  const int rows = (int)(n - row0 < kRowTile ? n - row0 : kRowTile);
  const int q0 = blockIdx.y * kQGroup;
  const int nq = min(kQGroup, b - q0);
  const CodeT* src = codes + row0 * M;
  for (int i = threadIdx.x; i < rows * M; i += kThreads) {
    const int r = i / M;
    code_s[(i - r * M) * kRowTile + r] = (int)src[i];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* lut0 = luts + (long long)q0 * M * K;
  float acc[kQGroup];
#pragma unroll
  for (int qi = 0; qi < kQGroup; ++qi) acc[qi] = 0.f;
  for (int m = 0; m < M; ++m) {
    const long long off = (long long)m * K + code_s[m * kRowTile + r];
#pragma unroll
    for (int qi = 0; qi < kQGroup; ++qi) {
      if (qi < nq) acc[qi] += __ldg(lut0 + (long long)qi * M * K + off);
    }
  }
#pragma unroll
  for (int qi = 0; qi < kQGroup; ++qi) {
    if (qi < nq) out[(long long)(q0 + qi) * n + row0 + r] = acc[qi];
  }
}

// Pass 1 of pq_score_topk: one block per (query tile of bq, chunk of
// grouped rows). codes (n, M) and gid (n,) are in grouped order, goff
// (ncoarse + 1,) the groups' offsets, luts (b, M, ncoarse * ksub). staged: the
// tile's LUT slices live in shared memory, else they are read from L2.
// Buffered: writes the chunk's top-kk words per query to part (b, nchunks,
// kk), 0 past the chunk's rows. Selection (sel not null): writes -d2 to sel
// (b, n) in grouped order.
template <typename CodeT>
__global__ void __launch_bounds__(kThreads)
pq_topk_kernel(const CodeT* __restrict__ codes, const int* __restrict__ gid,
               const int* __restrict__ goff, int ncoarse,
               const float* __restrict__ luts, long long n, int b, int M,
               int ksub, int bq, int staged, int kk, int cap,
               long long chunk_rows, u64* __restrict__ part,
               float* __restrict__ sel) {
  extern __shared__ __align__(16) unsigned char pq_smem[];
  __shared__ u64 thr[kMaxBQ];
  __shared__ int cnt[kMaxBQ];
  __shared__ int flag;
  const long long K = (long long)ncoarse * ksub;
  const int slice = M * ksub;                     // one query's LUT slice
  float* lut_s = reinterpret_cast<float*>(pq_smem);
  u64* buf = reinterpret_cast<u64*>(
      pq_smem + (staged ? ((size_t)bq * slice * sizeof(float) + 15) & ~(size_t)15
                        : 0));                    // (bq, cap)
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * bq;
  const int nq = b - q0 < bq ? b - q0 : bq;
  const long long r_begin = (long long)blockIdx.y * chunk_rows;
  const long long r_end = r_begin + chunk_rows < n ? r_begin + chunk_rows : n;
  const bool select = sel != nullptr;
  if (!select)
    for (int i = tid; i < bq * cap; i += kThreads) buf[i] = 0;
  if (tid < kMaxBQ) {
    thr[tid] = 0;                 // every real word is > 0
    cnt[tid] = 0;
  }
  int c = 0;                      // the group holding r_begin
  for (int lo = 0, hi = ncoarse - 1; lo < hi;) {
    const int mid = (lo + hi + 1) / 2;
    if (goff[mid] <= r_begin) lo = mid; else hi = mid - 1;
    c = lo;
  }
  for (; c < ncoarse && goff[c] < r_end; ++c) {
    const long long g0 = goff[c] > r_begin ? goff[c] : r_begin;
    const long long g1 = goff[c + 1] < r_end ? goff[c + 1] : r_end;
    if (g0 >= g1) continue;       // an empty group (uniform in the block)
    const float* lbase;
    long long qstride;
    int ldm;
    if (staged) {
      __syncthreads();            // the previous group's readers are done
      for (int i = tid; i < nq * slice; i += kThreads) {
        const int qi = i / slice;
        const int r = i - qi * slice;
        const int m = r / ksub;
        lut_s[i] = luts[((long long)(q0 + qi) * M + m) * K +
                        (long long)c * ksub + (r - m * ksub)];
      }
      lbase = lut_s;
      qstride = slice;
      ldm = ksub;
    } else {
      lbase = luts + (long long)q0 * M * K + (long long)c * ksub;
      qstride = (long long)M * K;
      ldm = (int)K;
    }
    __syncthreads();
    for (long long t0 = g0; t0 < g1; t0 += kThreads) {
      const long long r = t0 + tid;
      if (r < g1) {
        float acc[kMaxBQ];
        const CodeT* cr = codes + r * M;
        for (int m = 0; m < M; ++m) {
          const float* lm = lbase + (long long)m * ldm + (int)cr[m];
#pragma unroll
          for (int qi = 0; qi < kMaxBQ; ++qi) {
            if (qi < nq) {
              const float v = lm[qi * qstride];
              acc[qi] = m == 0 ? v : acc[qi] + v;
            }
          }
        }
        const int id = gid[r];
#pragma unroll
        for (int qi = 0; qi < kMaxBQ; ++qi) {
          if (qi >= nq) continue;
          const float x = -acc[qi];
          if (select) {
            sel[(long long)(q0 + qi) * n + r] = x;
          } else {
            const u64 w = pack(ord_bits(x), id);
            if (w > thr[qi]) {
              const int pos = atomicAdd(&cnt[qi], 1);
              buf[qi * cap + pos] = w;
            }
          }
        }
      }
      if (select) continue;
      __syncthreads();
      if (tid == 0) {       // a buffer another step could overflow
        int need = 0;
        for (int qi = 0; qi < nq; ++qi) need |= cnt[qi] > cap - kThreads;
        flag = need;
      }
      __syncthreads();
      if (flag) trim_words(buf, cnt, thr, nq, cap, kk);
    }
  }
  if (select) return;
  __syncthreads();
  trim_words(buf, cnt, thr, nq, cap, kk);
  const long long nchunks = gridDim.y;
  for (int i = tid; i < nq * kk; i += kThreads) {
    const int qi = i / kk;
    const int j = i - qi * kk;
    part[((long long)(q0 + qi) * nchunks + blockIdx.y) * kk + j] =
        buf[qi * cap + j];
  }
}

// Pass 2 of pq_score_topk: one block per query merges its chunks' words
// (len = nchunks * kk, 0 for an empty slot) and decodes the top-kk.
__global__ void __launch_bounds__(kThreads)
pq_merge_kernel(const u64* __restrict__ part, long long len, int kk, int cap,
                float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) u64 mbuf[];     // (cap,)
  __shared__ u64 thr;
  __shared__ int cnt;
  const int tid = threadIdx.x;
  const long long qi = blockIdx.x;
  for (int i = tid; i < cap; i += kThreads) mbuf[i] = 0;
  if (tid == 0) {
    thr = 0;
    cnt = 0;
  }
  __syncthreads();
  const u64* src = part + qi * len;
  for (long long t0 = 0; t0 < len; t0 += kThreads) {
    const long long t = t0 + tid;
    if (t < len) {
      const u64 w = src[t];
      if (w > thr) mbuf[atomicAdd(&cnt, 1)] = w;
    }
    __syncthreads();
    const bool full = cnt > cap - kThreads;
    __syncthreads();
    if (full) trim_words(mbuf, &cnt, &thr, 1, cap, kk);
  }
  trim_words(mbuf, &cnt, &thr, 1, cap, kk);
  for (int j = tid; j < kk; j += kThreads) {
    vals[qi * kk + j] = from_ord((unsigned)(mbuf[j] >> 32));
    ids[qi * kk + j] = key_of(mbuf[j]);
  }
}

// The queries' -d2 in grouped order (query q's row at q * n), keyed by the
// original row id; every entry competes (its order bits are never 0 for a
// sum of finite LUT entries). No segments.
struct PqScores {
  const float* s;
  const int* gid;
  long long n;
  __device__ long long size(int) const { return n; }
  static constexpr bool kSegmented = false;
  __device__ const float* row(int q) const { return s + (long long)q * n; }
  __device__ unsigned ord(float v) const { return ord_bits(v); }
  __device__ int key(int, long long, long long e) const { return gid[e]; }
};

// The selection path's finish: one block per query, after select_passes.
__global__ void __launch_bounds__(kSelThreads)
pq_select_kernel(const SelectArgs sa, const float* __restrict__ sel,
                 long long n, float* __restrict__ vals,
                 int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char sel_smem[];
  __shared__ FinishState fs;
  const long long qi = blockIdx.x;
  const int kk = sa.kk;
  u64* w;
  int* pos;
  sort_area(sa, (int)qi, sel_smem, &w, &pos);
  const float* s = sel + qi * n;
  select_finish(sa, (int)qi, w, pos, &fs);
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    vals[qi * kk + j] = s[pos[j]];
    ids[qi * kk + j] = key_of(w[j]);
  }
}

size_t pq_topk_smem(int bq, int staged, int cap, int M, int ksub) {
  const size_t lut = staged ? ((size_t)bq * M * ksub * sizeof(float) + 15) &
                                  ~(size_t)15
                            : 0;
  return lut + (size_t)bq * cap * sizeof(u64);
}

template <typename CodeT>
int launch_pq_topk(const CodeT* codes, const int* gid, const int* goff,
                   int ncoarse, const float* luts, long long n, int b, int M,
                   int ksub, int bq, int staged, int kk, int cap, int nchunks,
                   long long chunk_rows, u64* part, float* sel,
                   cudaStream_t st) {
  if (sel != nullptr) cap = 0;
  const size_t smem = pq_topk_smem(bq, staged, cap, M, ksub);
  cudaError_t err = cudaFuncSetAttribute(
      pq_topk_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((b + bq - 1) / bq), (unsigned)nchunks);
  pq_topk_kernel<CodeT><<<grid, kThreads, smem, st>>>(
      codes, gid, goff, ncoarse, luts, n, b, M, ksub, bq, staged, kk, cap,
      chunk_rows, part, sel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fcvi_pq_lut_qdot(const float* q_sub, const float* cb,
                                float* out, int b, int M, int ksub, int dsub,
                                void* stream) {
  if (b <= 0 || M <= 0 || ksub <= 0) return (int)cudaSuccess;
  const size_t smem =
      sizeof(float) * ((size_t)ksub * (dsub | 1) + (size_t)kQTile * dsub);
  cudaError_t err = cudaFuncSetAttribute(
      pq_lut_qdot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((b + kQTile - 1) / kQTile), (unsigned)M);
  pq_lut_qdot_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q_sub, cb, out, b, M, ksub, dsub);
  return (int)cudaGetLastError();
}

template <typename CodeT>
static int launch_pq_score(const CodeT* codes, const float* luts, float* out,
                           long long n, int b, int M, int K,
                           cudaStream_t st) {
  const size_t smem = sizeof(int) * (size_t)M * kRowTile;
  cudaError_t err = cudaFuncSetAttribute(
      pq_score_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + kRowTile - 1) / kRowTile),
                  (unsigned)((b + kQGroup - 1) / kQGroup));
  pq_score_kernel<CodeT><<<grid, kThreads, smem, st>>>(codes, luts, out, n,
                                                       b, M, K);
  return (int)cudaGetLastError();
}

// codes: (n, M) of code_bytes bytes each (1: uint8, 4: int32), every value
// in [0, K); luts (b, M, K) fp32; out (b, n) fp32.
extern "C" int fcvi_pq_score(const void* codes, int code_bytes,
                             const float* luts, float* out, long long n,
                             int b, int M, int K, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (code_bytes == 1)
    return launch_pq_score((const uint8_t*)codes, luts, out, n, b, M, K, st);
  if (code_bytes == 4)
    return launch_pq_score((const int32_t*)codes, luts, out, n, b, M, K, st);
  return (int)cudaErrorInvalidValue;
}

// The fused ADC scan + top-k over the grouped layout: codes (n, M) of
// code_bytes bytes each (1: uint8, 4: int32) and gid (n,) in grouped order,
// goff (ncoarse + 1,) int32, luts (b, M, ncoarse * ksub) fp32 -> vals (b, kk)
// = -d2 and ids (b, kk) original row ids, ranked by the packed key. bq <=
// 16 queries a block. Buffered path (sel null): part is a (b, nchunks, kk)
// u64 scratch and merge_cap the merge's buffer. Selection path (sel, a
// (b, n) fp32 scratch, not null): cap, merge_cap and part are unused; sa
// holds the select's plan and scratch (select_common.cuh), null on the
// buffered path.
extern "C" int fcvi_pq_score_topk(const void* codes, int code_bytes,
                                  const int* gid, const int* goff,
                                  int ncoarse, const float* luts, long long n,
                                  int b, int M, int ksub, int bq, int staged,
                                  int kk, int cap, int nchunks,
                                  long long chunk_rows, int merge_cap,
                                  void* part, float* sel,
                                  const void* sel_args, float* vals,
                                  int* ids, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  if (bq < 1 || bq > kMaxBQ) return (int)cudaErrorInvalidValue;
  const SelectArgs* sa = static_cast<const SelectArgs*>(sel_args);
  if (sel != nullptr && sa == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  u64* pw = static_cast<u64*>(part);
  int err;
  if (code_bytes == 1)
    err = launch_pq_topk((const uint8_t*)codes, gid, goff, ncoarse, luts, n,
                         b, M, ksub, bq, staged, kk, cap, nchunks, chunk_rows,
                         pw, sel, st);
  else if (code_bytes == 4)
    err = launch_pq_topk((const int32_t*)codes, gid, goff, ncoarse, luts, n,
                         b, M, ksub, bq, staged, kk, cap, nchunks, chunk_rows,
                         pw, sel, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != (int)cudaSuccess) return err;
  if (sel != nullptr) {
    cudaError_t e = select_passes(PqScores{sel, gid, n}, *sa, st);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = select_smem(*sa);
    e = cudaFuncSetAttribute(pq_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    pq_select_kernel<<<b, kSelThreads, smem, st>>>(*sa, sel, n, vals, ids);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(u64) * (size_t)merge_cap;
  cudaError_t e = cudaFuncSetAttribute(
      pq_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  pq_merge_kernel<<<b, kThreads, smem, st>>>(pw, (long long)nchunks * kk, kk,
                                             merge_cap, vals, ids);
  return (int)cudaGetLastError();
}
