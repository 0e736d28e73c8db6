// Fused per-dimension normalize + psi fold:
//   out = (v - mean_v) / std_v - alpha * ((f - mean_f) / std_f) @ P
//
// Replaces src/repro/kernels/fcvi_transform.py::fused_transform (Pallas, TPU).
//
// Bound on the H100: bytes. Each output element reads one v element and writes
// one out element; the filter row (m <= 8 values) and the (m, d) fold matrix
// are tiny. At n = 1,000,000, d = 128, m = 8 the pass moves about 1.06 GB, so
// about 0.32 ms at 3.35 TB/s.
//
// Design: one block per tile of kRows rows. P and the tile's normalized
// filter rows sit in shared memory (P is read through L2 instead when the
// (m, d) matrix does not fit there, so any m * d is taken; the values, and
// so the results, are the same); each thread then walks the tile's
// elements in row-major order, so global loads and stores are coalesced. The
// fold is a short dot over m in the kernel itself (no matmul unit is worth it
// at m <= 8). The final subtract and multiply are written with explicit
// round-to-nearest intrinsics so they are not contracted into an FMA: with
// the 0/1 partition matrix the result then matches the plain PyTorch
// version bit for bit. Null normalizer pointers mean the identity, which is
// what the serving path passes for already-normalized inputs.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

__global__ void __launch_bounds__(kThreads)
fused_transform_kernel(const float* __restrict__ v, const float* __restrict__ f,
                       const float* __restrict__ proj, float alpha,
                       const float* __restrict__ mean_v,
                       const float* __restrict__ std_v,
                       const float* __restrict__ mean_f,
                       const float* __restrict__ std_f,
                       float* __restrict__ out, long long n, int d, int m,
                       int staged) {
  extern __shared__ __align__(16) float smem[];
  float* p_s = smem;                          // (m, d) fold matrix, if staged
  float* fn_s = p_s + (staged ? m * d : 0);   // (kRows, m) normalized filters
  const float* p = staged ? p_s : proj;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)(n - row0 < kRows ? n - row0 : kRows);

  if (staged)
    for (int i = threadIdx.x; i < m * d; i += blockDim.x) p_s[i] = proj[i];
  for (int i = threadIdx.x; i < rows * m; i += blockDim.x) {
    const int j = i % m;
    float x = f[row0 * m + i];
    if (mean_f != nullptr) x = (x - mean_f[j]) / std_f[j];
    fn_s[i] = x;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float x = v[row0 * d + i];
    if (mean_v != nullptr) x = (x - mean_v[c]) / std_v[c];
    float fold = 0.f;
    for (int j = 0; j < m; ++j) fold = fmaf(fn_s[r * m + j], p[j * d + c], fold);
    out[row0 * d + i] = __fsub_rn(x, __fmul_rn(alpha, fold));
  }
}

}  // namespace

extern "C" int fcvi_fused_transform(const float* v, const float* f,
                                    const float* proj, float alpha,
                                    const float* mean_v, const float* std_v,
                                    const float* mean_f, const float* std_f,
                                    float* out, long long n, int d, int m,
                                    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const size_t filters = sizeof(float) * (size_t)kRows * m;
  const size_t fold = sizeof(float) * (size_t)m * d;
  const int staged = filters + fold <= kSmemLimit;
  const size_t smem = filters + (staged ? fold : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fused_transform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + kRows - 1) / kRows;
  fused_transform_kernel<<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
      v, f, proj, alpha, mean_v, std_v, mean_f, std_f, out, n, d, m, staged);
  return (int)cudaGetLastError();
}
