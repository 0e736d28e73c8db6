// PQ asymmetric-distance (ADC) kernels: the LUT cross term and the
// gather-accumulate scans.
//
// Replaces three Pallas kernels for the TPU, all in
// src/repro/kernels/pq_lut.py:
//   * pq_lut_qdot: out[i, m, j] = <q_sub[i, m], codebook[m, j]>, the
//     q . codebook cross term of compute_luts, (b, M, dsub) x
//     (M, ksub, dsub) -> (b, M, ksub);
//   * pq_score_batch: d2[i, r] = sum_m luts[i, m, codes[r, m]], codes
//     (n, M), luts (b, M, K) -> (b, n). The serving path passes the combined
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
// are coalesced along the rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQTile = 8;      // queries per pq_lut_qdot block
constexpr int kRowTile = kThreads;  // rows per pq_score block
constexpr int kQGroup = 8;     // queries per pq_score block

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
