// Combined-cosine re-rank score (Alg. 1 line 13):
//   score = lam * cos(v, q) + (1 - lam) * cos(f, F_q),
//   cos(a, b) = sum(a * b) / (||a|| * ||b|| + 1e-8)
//
// Replaces src/repro/kernels/rescore.py::rescore (Pallas, TPU).
//
// Bound on the H100: bytes, and at serving sizes launch latency. At the main
// path's (64, 80, 128) + (64, 80, 8) candidate tiles the kernel reads about
// 2.8 MB, a microsecond at 3.35 TB/s.
//
// Design: one warp per (query, candidate) row. The lanes stride over the d
// and m columns, accumulate sum(a*b), sum(a*a) and sum(b*b) in fp32 and
// reduce them with warp shuffles; lane 0 applies the exact formula above.
// Each row is reduced on its own, so a candidate's score does not depend on
// its position in the tile. No batch padding is needed: the grid covers
// b * kp rows and the last block masks the ragged edge.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float cosine(const float* __restrict__ a,
                                        const float* __restrict__ b, int len,
                                        int lane) {
  float ab = 0.f, aa = 0.f, bb = 0.f;
  for (int c = lane; c < len; c += 32) {
    const float x = a[c];
    const float y = b[c];
    ab = fmaf(x, y, ab);
    aa = fmaf(x, x, aa);
    bb = fmaf(y, y, bb);
  }
  ab = warp_sum(ab);
  aa = warp_sum(aa);
  bb = warp_sum(bb);
  return ab / (sqrtf(aa) * sqrtf(bb) + 1e-8f);
}

__global__ void __launch_bounds__(kThreads)
rescore_kernel(const float* __restrict__ cand_v, const float* __restrict__ cand_f,
               const float* __restrict__ qn, const float* __restrict__ fqn,
               float lam, float one_minus_lam, float* __restrict__ out,
               int b, int kp, int d, int m) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)b * kp) return;  // whole warp leaves together
  const long long qi = row / kp;
  const float s_v = cosine(cand_v + row * d, qn + qi * d, d, lane);
  const float s_f = cosine(cand_f + row * m, fqn + qi * m, m, lane);
  if (lane == 0) out[row] = lam * s_v + one_minus_lam * s_f;
}

}  // namespace

extern "C" int fcvi_rescore(const float* cand_v, const float* cand_f,
                            const float* qn, const float* fqn, float lam,
                            float one_minus_lam, float* out, int b, int kp,
                            int d, int m, void* stream) {
  const long long rows = (long long)b * kp;
  if (rows <= 0) return (int)cudaSuccess;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  rescore_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cand_v, cand_f, qn, fqn, lam, one_minus_lam, out, b, kp, d, m);
  return (int)cudaGetLastError();
}

extern "C" const char* fcvi_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
