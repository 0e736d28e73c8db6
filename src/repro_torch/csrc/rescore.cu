// Combined-cosine re-rank score (Alg. 1 line 13):
//   score = lam * cos(v, q) + (1 - lam) * cos(f, F_q),
//   cos(a, b) = sum(a * b) / (||a|| * ||b|| + 1e-8)
// and the re-rank around it: the first-occurrence top-k of the scores and
// the candidates' ids at those positions.
//
// Replaces src/repro/kernels/rescore.py::rescore (Pallas, TPU), and with
// rescore_topk_kernel also what its callers run after it, lax.top_k and
// take_along_axis (src/repro/core/fcvi.py rescore, the engine's steps).
//
// Bound on the H100: bytes, and at serving sizes the launches and the
// host's work around them. At the main path's (64, 80, 128) + (64, 80, 8)
// candidate tiles one re-rank reads about 2.8 MB, a microsecond at
// 3.35 TB/s; the scores, a stable sort, a slice and a gather of the ids
// were four host dispatches and seven launches for 64 x 80 numbers.
//
// Scores (score_rows, both kernels): a warp scores a group of kRows
// consecutive candidates of one query. The lanes stride over the d and m
// columns, loading kColsAhead of their columns of each row before adding
// any, and accumulate sum(a*b), sum(a*a) and sum(b*b) in fp32 with fmaf, in
// column order. The eight per-row sums are reduced by one reduce-scatter
// (each value's total by the same tree as a shuffle butterfly over lane
// offsets 16, 8, 4, 2, 1, so a row's bits do not depend on its place in
// the group), and lane u applies the formula above for row u, with its
// roundings spelled out (no contraction). rescore_kernel: one warp a group,
// the (b, kp) scores out.
//
// The re-rank (rescore_topk_kernel): one block per query, so one launch
// covers the batch. The block stages qn[i] and fqn[i] in shared memory and
// its warps score the candidates in the same groups (so the scores are
// rescore_kernel's bits). It keeps the kp scores and a 32-bit key each in
// shared memory; the key orders the scores as a stable descending sort does
// (topk_first): NaN above everything and all NaNs equal, -0.0 equal to
// +0.0. A candidate's rank is the count of entries that go before it (a
// larger key, or an equal key at a smaller position), given up once it
// reaches k; a candidate ranked below k writes its score (the original
// bits) and its id at its rank, so no sort runs. Up to kDirect candidates
// every candidate counts over all the keys (four a read; the warp's lanes
// read the same words). Past it a radix select over the keys (8 bits a
// pass) finds the k-th largest first, and only the candidates at or above
// it (k where the keys are distinct) count, among themselves. Past what
// shared memory holds (12 bytes a candidate: kp up to 19,152 at d = 128,
// m = 8) the wrapper routes to rescore_kernel and topk_first: a shape
// rule, not a fallback.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTopkThreads = 1024;
constexpr int kTopkWarps = kTopkThreads / 32;
constexpr int kRows = 4;           // candidates a warp scores at once
static_assert(2 * kRows == 8, "reduce_scatter8 reduces 2 * kRows sums");
constexpr int kColsAhead = 4;      // columns of each a lane loads at once
constexpr int kDirect = 512;       // candidates ranked against every key

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One value's sums across the warp for eight values v[0..7]: a
// reduce-scatter over lane offsets 16, 8 and 4 (a lane keeps half its
// values, adds the partner's half of them) and a butterfly over 2 and 1.
// Lane l returns the total of v[(l >> 2) & 7]; the four lanes of a quad
// return the same bits (each step adds the same two partials).
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8],
                                                 int lane) {
  float w[4], x[2];
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h16 ? v[i] : v[i + 4];
    w[i] = (h16 ? v[i + 4] : v[i]) +
           __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h8 ? w[i] : w[i + 2];
    x[i] = (h8 ? w[i + 2] : w[i]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float y = (h4 ? x[1] : x[0]) +
            __shfl_xor_sync(0xffffffffu, h4 ? x[0] : x[1], 4);
  y += __shfl_xor_sync(0xffffffffu, y, 2);
  y += __shfl_xor_sync(0xffffffffu, y, 1);
  return y;
}

// The cosines of kRows rows a[u * len:(u + 1) * len] (u < nrows; the rest
// are no rows) with b, every lane of the warp calling; lane u (and every
// lane l with l % kRows == u) returns row u's cosine. Each row's sums run
// over its columns c = lane, lane + 32, ... in order; a lane loads
// kColsAhead of its columns of every row before it adds any, so
// kRows * kColsAhead loads are in flight. The sums are reduced by
// reduce_scatter8, the formula applied once for the kRows rows, on their
// lanes.
__device__ __forceinline__ float cos_rows(const float* __restrict__ a,
                                          int nrows,
                                          const float* __restrict__ b,
                                          int len, int lane) {
  float v[2 * kRows], bb = 0.f;   // v: sum(a*b) of each row, then sum(a*a)
#pragma unroll
  for (int u = 0; u < 2 * kRows; ++u) v[u] = 0.f;
  for (int c0 = lane; c0 < len; c0 += 32 * kColsAhead) {
    float x[kRows][kColsAhead], y[kColsAhead];
#pragma unroll
    for (int t = 0; t < kColsAhead; ++t) {
      const int c = c0 + 32 * t;
      y[t] = c < len ? b[c] : 0.f;
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        x[u][t] = u < nrows && c < len ? a[(long long)u * len + c] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kColsAhead; ++t) {
      if (c0 + 32 * t >= len) break;
      bb = fmaf(y[t], y[t], bb);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        v[u] = fmaf(x[u][t], y[t], v[u]);
        v[kRows + u] = fmaf(x[u][t], x[u][t], v[kRows + u]);
      }
    }
  }
  const float nb = sqrtf(warp_sum(bb));
  const float tot = reduce_scatter8(v, lane);
  const int u = lane % kRows;
  const float ab = __shfl_sync(0xffffffffu, tot, 4 * u);
  const float aa = __shfl_sync(0xffffffffu, tot, 4 * (kRows + u));
  return __fdiv_rn(ab, __fadd_rn(__fmul_rn(sqrtf(aa), nb), 1e-8f));
}

// The combined scores of kRows candidate rows of one query (cand_v rows
// from v0, cand_f rows from f0, nrows of them) against (q, fq); lane u
// returns row u's score.
__device__ __forceinline__ float score_rows(const float* v0, const float* f0,
                                            int nrows, const float* q,
                                            const float* fq, int d, int m,
                                            float lam, float one_minus_lam,
                                            int lane) {
  const float s_v = cos_rows(v0, nrows, q, d, lane);
  const float s_f = cos_rows(f0, nrows, fq, m, lane);
  return __fadd_rn(__fmul_rn(lam, s_v), __fmul_rn(one_minus_lam, s_f));
}

// One warp per group of kRows consecutive candidates of a query (rows
// j0 .. j0 + kRows - 1, j0 a multiple of kRows, as the re-rank groups
// them, so both kernels give the same bits).
__global__ void __launch_bounds__(kThreads)
rescore_kernel(const float* __restrict__ cand_v, const float* __restrict__ cand_f,
               const float* __restrict__ qn, const float* __restrict__ fqn,
               float lam, float one_minus_lam, float* __restrict__ out,
               int b, int kp, int d, int m) {
  const int groups = (kp + kRows - 1) / kRows;
  const long long g = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (g >= (long long)b * groups) return;  // whole warp leaves together
  const long long qi = g / groups;
  const int j0 = (int)(g - qi * groups) * kRows;
  const int nrows = kp - j0 < kRows ? kp - j0 : kRows;
  const long long row = qi * kp + j0;
  const float x = score_rows(cand_v + row * d, cand_f + row * m, nrows,
                             qn + qi * d, fqn + qi * m, d, m, lam,
                             one_minus_lam, lane);
  if (lane < nrows) out[row + lane] = x;
}

// A score's place in a stable descending sort: NaN above everything (all
// NaNs equal), -0.0 equal to +0.0, otherwise the order-preserving image of
// its bits.
__device__ __forceinline__ unsigned sort_key(float s) {
  if (s != s) return 0xffffffffu;
  const unsigned b = __float_as_uint(s);
  if (b == 0x80000000u) return 0x80000000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Whether the entry (kl, l) goes before (kj, j): a larger key, or an equal
// key at a smaller position.
__device__ __forceinline__ int before(unsigned kl, int l, unsigned kj, int j) {
  return kl > kj || (kl == kj && l < j);
}

// The k-th largest of the kp keys by a radix select, 8 bits a pass from
// the top (a 256-bin histogram in shared memory, the bin found by warp 0);
// every thread of the block calls it and gets the key.
__device__ unsigned kth_key(const unsigned* key, int kp, int k, int* hist,
                            unsigned* sel) {
  const int lane = threadIdx.x & 31;
  unsigned prefix = 0, mask = 0;
  int need = k;               // keys still to find at or below the prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < kp; j += blockDim.x) {
      const unsigned kj = key[j];
      if ((kj & mask) == prefix) atomicAdd(&hist[(kj >> shift) & 255], 1);
    }
    __syncthreads();
    if (threadIdx.x < 32) {   // lane l owns bins 8l .. 8l + 7
      int c[8], own = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) own += c[t] = hist[8 * lane + t];
      int incl = own;         // this lane's bins and every bin above them
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += v;
      }
      int above = incl - own;
      if (above < need && need <= incl) {
        for (int t = 7; t >= 0; --t) {
          if (above + c[t] >= need) {
            sel[0] = prefix | ((unsigned)(8 * lane + t) << shift);
            sel[1] = (unsigned)(need - above);
            break;
          }
          above += c[t];
        }
      }
    }
    __syncthreads();
    prefix = sel[0];
    need = (int)sel[1];
    mask |= 255u << shift;
  }
  return prefix;
}

// One block per query: the scores of its kp candidates, then their top k
// by (score desc, position asc). A candidate's rank is the count of
// entries that go before it, given up once it reaches k. Up to kDirect
// candidates every candidate counts over all keys; past it the k-th
// largest key is selected first and only the candidates at or above it
// (exactly k where the keys are distinct) are gathered and count among
// themselves: anything before a winner is itself a winner. A candidate
// ranked below k writes its score and cand_ids entry at its rank. kp4: kp
// rounded up to a multiple of 4.
template <typename IdT>
__global__ void __launch_bounds__(kTopkThreads)
rescore_topk_kernel(const float* __restrict__ cand_v,
                    const float* __restrict__ cand_f,
                    const float* __restrict__ qn,
                    const float* __restrict__ fqn, float lam,
                    float one_minus_lam, const IdT* __restrict__ cand_ids,
                    int kp, int d, int m, int k, int kp4,
                    float* __restrict__ vals, IdT* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char rt_smem[];
  __shared__ int hist[256];
  __shared__ unsigned sel[2];
  __shared__ int n_win;
  unsigned* key = reinterpret_cast<unsigned*>(rt_smem);   // (kp4,)
  float* s = reinterpret_cast<float*>(key + kp4);          // (kp4,)
  int* win = reinterpret_cast<int*>(s + kp4);              // (kp4,)
  float* q_s = reinterpret_cast<float*>(win + kp4);        // (d,)
  float* f_s = q_s + d;                                    // (m,)
  const long long qi = blockIdx.x;
  for (int c = threadIdx.x; c < d; c += kTopkThreads) q_s[c] = qn[qi * d + c];
  for (int c = threadIdx.x; c < m; c += kTopkThreads)
    f_s[c] = fqn[qi * m + c];
  if (threadIdx.x == 0) n_win = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = qi * kp;
  for (int j0 = warp * kRows; j0 < kp; j0 += kTopkWarps * kRows) {
    const int nrows = kp - j0 < kRows ? kp - j0 : kRows;
    const float x = score_rows(cand_v + (row0 + j0) * d,
                               cand_f + (row0 + j0) * m, nrows, q_s, f_s, d,
                               m, lam, one_minus_lam, lane);
    if (lane < nrows) {     // lane u holds row j0 + u's score
      s[j0 + lane] = x;
      key[j0 + lane] = sort_key(x);
    }
  }
  __syncthreads();
  if (kp <= kDirect) {
    for (int j = threadIdx.x; j < kp; j += kTopkThreads) {
      const unsigned kj = key[j];
      int rank = 0, l = 0;
      for (; l + 4 <= kp && rank < k; l += 4) {
        const uint4 w = *reinterpret_cast<const uint4*>(key + l);
        rank += before(w.x, l, kj, j) + before(w.y, l + 1, kj, j) +
                before(w.z, l + 2, kj, j) + before(w.w, l + 3, kj, j);
      }
      for (; l < kp && rank < k; ++l) rank += before(key[l], l, kj, j);
      if (rank < k) {
        vals[qi * k + rank] = s[j];
        ids[qi * k + rank] = cand_ids[row0 + j];
      }
    }
    return;
  }
  const unsigned kth = kth_key(key, kp, k, hist, sel);
  for (int j = threadIdx.x; j < kp; j += kTopkThreads)
    if (key[j] >= kth) win[atomicAdd(&n_win, 1)] = j;
  __syncthreads();
  const int nw = n_win;
  for (int i = threadIdx.x; i < nw; i += kTopkThreads) {
    const int j = win[i];
    const unsigned kj = key[j];
    int rank = 0;
    for (int l = 0; l < nw && rank < k; ++l) {
      const int p = win[l];
      rank += before(key[p], p, kj, j);
    }
    if (rank < k) {
      vals[qi * k + rank] = s[j];
      ids[qi * k + rank] = cand_ids[row0 + j];
    }
  }
}

template <typename IdT>
int launch_rescore_topk(const float* cand_v, const float* cand_f,
                        const float* qn, const float* fqn, float lam,
                        float one_minus_lam, const IdT* cand_ids, int b,
                        int kp, int d, int m, int k, size_t smem,
                        float* vals, IdT* ids, cudaStream_t st) {
  // the shared-memory attribute, set once a device and size (the largest
  // set so far on each device), not on every call of the serving path
  constexpr int kMaxDevices = 64;
  static size_t done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > done[dev]) {
    err = cudaFuncSetAttribute(rescore_topk_kernel<IdT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    done[dev] = smem;
  }
  rescore_topk_kernel<IdT><<<b, kTopkThreads, smem, st>>>(
      cand_v, cand_f, qn, fqn, lam, one_minus_lam, cand_ids, kp, d, m, k,
      (kp + 3) & ~3, vals, ids);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fcvi_rescore(const float* cand_v, const float* cand_f,
                            const float* qn, const float* fqn, float lam,
                            float one_minus_lam, float* out, int b, int kp,
                            int d, int m, void* stream) {
  const long long rows = (long long)b * kp;
  if (rows <= 0) return (int)cudaSuccess;
  const long long groups = (long long)b * ((kp + kRows - 1) / kRows);
  const long long blocks = (groups + kWarps - 1) / kWarps;
  rescore_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cand_v, cand_f, qn, fqn, lam, one_minus_lam, out, b, kp, d, m);
  return (int)cudaGetLastError();
}

// The fused re-rank: cand_v (b, kp, d), cand_f (b, kp, m), qn (b, d), fqn
// (b, m) fp32, cand_ids (b, kp) of id_bytes bytes (4: int32, 8: int64) ->
// vals (b, k) fp32 and ids (b, k) of the same type, 1 <= k <= kp. smem:
// the block's dynamic shared memory, 4 * (3 * kp4 + d + m) bytes with kp4
// = kp rounded up to a multiple of 4 (kernels/rescore.py topk_smem).
extern "C" int fcvi_rescore_topk(const float* cand_v, const float* cand_f,
                                 const float* qn, const float* fqn, float lam,
                                 float one_minus_lam, const void* cand_ids,
                                 int id_bytes, int b, int kp, int d, int m,
                                 int k, long long smem, float* vals,
                                 void* ids, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (k < 1 || k > kp) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (id_bytes == 4)
    return launch_rescore_topk(cand_v, cand_f, qn, fqn, lam, one_minus_lam,
                               (const int32_t*)cand_ids, b, kp, d, m, k,
                               (size_t)smem, vals, (int32_t*)ids, st);
  if (id_bytes == 8)
    return launch_rescore_topk(cand_v, cand_f, qn, fqn, lam, one_minus_lam,
                               (const int64_t*)cand_ids, b, kp, d, m, k,
                               (size_t)smem, vals, (int64_t*)ids, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fcvi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
