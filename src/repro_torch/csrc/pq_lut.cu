// PQ asymmetric-distance (ADC) kernels: the scan LUT with its cross term,
// the gather-accumulate scans, and the fused ADC scan + top-k of the
// serving path.
//
// Replaces three Pallas kernels for the TPU, all in
// src/repro/kernels/pq_lut.py:
//   * pq_lut_qdot: out[i, m, j] = <q_sub[i, m], codebook[m, j]>, the
//     q . codebook cross term of compute_luts, (b, M, dsub) x
//     (M, ksub, dsub) -> (b, M, ksub); here the cross-term-only mode of
//     pq_scan_luts_kernel, which fuses it with the rest of the LUT;
//   * pq_score_batch: d2[i, r] = sum_m luts[i, m, codes[r, m]], codes
//     (n, M), luts (b, M, K) -> (b, n). Callers pass the combined
//     (coarse id * ksub + code) index, so K = ncoarse * ksub;
//   * pq_score: the same at one LUT, (n, M) x (M, K) -> (n,). Launched as
//     pq_score_batch at b = 1 (the wrapper counts it apart).
//
// pq_scan_luts (index.pq.scan_luts): the serving path's whole table,
// lut[i, m, c * ksub + j] = (qres_sq[i, c, m] - 2 (q_dot[i, m, j] -
// coarse_dot[c, m, j])) + cb_sq[m, j], (b, M, ncoarse * ksub) fp32, where
// the reference's compute_luts runs B8 and plain ops around it (about
// nine launches here before, four of them passes over the whole table).
// Bound on the H100: writing the table once, 16.8 MB at b = 64, M = 8,
// ncoarse = 32, ksub = 256 (0.005 ms at 3.35 TB/s), against about 21
// MFLOP and 0.5 MB of inputs. One block per (query tile of up to 8,
// codeword chunk, coarse range) and subspace: it stages its codewords, the
// coarse_dot slice and cb_sq once (cp.async, all in flight together),
// computes its queries' cross terms (a thread holds a codeword's columns
// in registers and runs the tile's queries, read as broadcast 16-byte
// loads, past it) and residual norms once into shared memory, then writes
// each (query, coarse id) row segment once, as 16-byte stores, with
// ordinary write-back stores so the table stays in the 50 MB L2 for the
// scan that reads it next. Codewords come in chunks when a subspace's do
// not fit (any ksub: a 4096 x 64 codebook is 1 MB), the dsub sums in
// chunks of kLutCols columns, and the coarse axis splits across blocks
// until the grid covers the SMs once (pq_lut.luts_plan). Every sum runs
// in column order, the first product and then each next one added, with
// __fmul_rn / __fadd_rn / __fsub_rn in the plain version's order
// (ref.ref_pq_scan_luts), so the table is its bits. No tensor cores: a
// dsub of 16 is a single k-step, the products are a tenth of the bound's
// time at the SIMT rate, and a split of the fp32 operands (as the flat
// scan's) would cost more than the table's write.
//
// pq_score_batch (and pq_score). Bound on the H100: the function's bytes
// (the (b, n) fp32 output, 256 MB at b = 64, n = 1M, against 32 MB of int32
// codes and 16.8 MB of LUTs: 0.091 ms at 3.35 TB/s); what a kernel pays
// first is the b * n * M LUT entries it reads from L2. The TPU kernel keeps
// one query's (M, K) LUT resident in VMEM and turns each subspace's gather
// into a one-hot matmul. On Hopper one query's combined LUT, 8 x 32 x 256
// fp32 = 256 KB, does not fit in a block's 227 KB of shared memory, and the
// rows are in corpus order, so the entries come from L2. In the batch's
// (b, M, K) layout one code's entries for the batch's queries lie M * K * 4
// bytes apart: each 4-byte read pulls a 32-byte sector (about 16 GB of L2
// traffic at b = 64). So the call first copies the LUTs once to (M, K, bp),
// queries innermost (pq_lut_relayout_kernel, a tiled transpose through
// shared memory; bp is b padded to the vector width, the pad zeroed; at
// b = 1 the layouts agree and no copy runs): one code's entries for a group
// of up to kAdcGroup queries are then one run of 4 * QP bytes (256 B at
// b = 64), and every sector read is useful (n * M * b * 4 bytes of L2
// reads, 2.1 GB at b = 64). The scan (pq_adc_kernel): a block owns a tile
// of rows and a group of QP query slots (a power of two, at most 64); it
// stages the tile's codes in shared memory with cp.async; a warp's lanes
// map to query slots first (V = min(4, QP) floats each, one 16-, 8- or
// 4-byte load) and rows second (32 / (QP / V) rows a warp instruction: 2 at
// b = 64, 8 at b = 16, 32 at b = 1, where each lane owns a row), and each
// lane keeps kAdcUnroll rows' loads in flight across the subspaces. Every
// sum is the left-to-right fp32 sum over m started from the m = 0 entry:
// the plain version's value, bit for bit (a row of -0.0 entries sums to
// -0.0). The (QP x rows) tile leaves through shared memory as coalesced
// row segments of out[q, row0:row0 + rows], with 64-bit offsets. A batch
// past 64 queries runs groups of 64 (the grid's y) and its tail group at
// the tail's own width in a second launch. No serving path launches it:
// pq.search takes the fused scan below.
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
constexpr int kLutThreads = 256;  // threads a pq_scan_luts block
constexpr int kLutCols = 16;   // dsub columns staged at a time
constexpr int kMaxBQ = 16;     // queries per pq_topk block, at most
constexpr int kAdcWarps = kThreads / 32;
constexpr int kAdcGroup = 64;  // query slots a pq_adc block, at most
constexpr int kAdcUnroll = 2;  // row steps a pq_adc lane keeps in flight

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__host__ __device__ inline size_t round4(size_t n) {
  return (n + 3) & ~(size_t)3;
}

// One entry of the scan LUT, in the plain version's order.
__device__ __forceinline__ float lut_entry(float qr, float qd, float cd,
                                          float sq) {
  return __fadd_rn(__fsub_rn(qr, __fmul_rn(2.f, __fsub_rn(qd, cd))), sq);
}

// pq_scan_luts_kernel's dynamic shared memory in bytes (pq_lut.luts_smem):
// the cross term (qt, kc), the coarse_dot slice (cr, kc), cb_sq (kc), the
// codewords' column chunk (kc, dc | 1), the queries' (qt, dq) and the
// centres' (cr, dq) with dq = dc rounded up to 4, the residual norms
// (qt, cr); each region a multiple of 16 bytes.
size_t pq_luts_smem(int qt, int kc, int cr, int dc) {
  const size_t ds = (size_t)(dc | 1), dq = round4(dc);
  return sizeof(float) *
         (round4((size_t)qt * kc) + round4((size_t)cr * kc) + round4(kc) +
          round4((size_t)kc * ds) + (size_t)qt * dq + (size_t)cr * dq +
          round4((size_t)qt * cr));
}

// rows x cols floats of src (row stride ss) to dst (row stride sd) by
// cp.async, every copy in flight at once; the caller waits
// (cp_async_wait_all) and syncs.
__device__ __forceinline__ void lut_stage(float* dst, int sd,
                                          const float* __restrict__ src,
                                          long long ss, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += kLutThreads) {
    const int r = e / cols;
    cp_async4(dst + r * sd + (e - r * cols), src + r * ss + (e - r * cols));
  }
}

// The scan LUT (or, with ncoarse = 0, the cross term alone): one block per
// (query tile of qt, codeword chunk of kc, coarse range of cr; blockIdx.x,
// query tile fastest) and subspace m (blockIdx.y). The dsub sums run in
// column order in chunks of kLutCols columns staged in shared memory, each
// the first product, then each next product added (mul and add rounded
// apart, as the plain version's separate torch ops round them): a thread
// holds a codeword's chunk in registers and runs the tile's queries (read
// as broadcast 16-byte loads) past it; then the table entries
// ((qres_sq - 2 (q_dot - coarse_dot)) + cb_sq) leave as rows of
// out[q, m, c * ksub + j0 : + kc], 16-byte stores where VEC.
// Three blocks an SM (at most 85 registers a thread): a block's fixed
// cost is its staging, which more resident blocks overlap.
template <bool VEC>
__global__ void __launch_bounds__(kLutThreads, 3)
pq_scan_luts_kernel(const float* __restrict__ q, const float* __restrict__ cb,
                    const float* __restrict__ cen,
                    const float* __restrict__ cdot,
                    const float* __restrict__ cbsq, float* __restrict__ out,
                    int b, int M, int ksub, int dsub, int ncoarse, int qt,
                    int kc, int cr, int qtiles, int kchunks) {
  extern __shared__ __align__(16) float lut_smem[];
  const bool full = ncoarse > 0;
  const int m = blockIdx.y;
  int x = blockIdx.x;
  const int q0 = (x % qtiles) * qt;
  x /= qtiles;
  const int j0 = (x % kchunks) * kc;
  const int c0 = (x / kchunks) * cr;
  const int nq = min(qt, b - q0);
  const int nk = min(kc, ksub - j0);
  const int nc = full ? min(cr, ncoarse - c0) : 0;
  const int crs = full ? cr : 0;
  const int dc = min(dsub, kLutCols);
  const int ds = dc | 1;            // odd stride: conflict-free reads
  const int dq = (dc + 3) & ~3;     // 16-byte rows: broadcast loads
  float* qdot_s = lut_smem;                               // (qt, kc)
  float* cdot_s = qdot_s + round4((size_t)qt * kc);       // (cr, kc)
  float* cbsq_s = cdot_s + round4((size_t)crs * kc);      // (kc)
  float* cb_s = cbsq_s + round4(kc);                      // (kc, ds)
  float* q_s = cb_s + round4((size_t)kc * ds);            // (qt, dq)
  float* cen_s = q_s + (size_t)qt * dq;                   // (cr, dq)
  float* qres_s = cen_s + (size_t)crs * dq;               // (qt, cr)
  const int tid = threadIdx.x;
  const long long d = (long long)M * dsub;
  const float* cbm = cb + ((long long)m * ksub + j0) * dsub;
  if (full) {
    lut_stage(cdot_s, kc, cdot + ((long long)c0 * M + m) * ksub + j0,
              (long long)M * ksub, nc, nk);
    lut_stage(cbsq_s, nk, cbsq + (long long)m * ksub + j0, nk, 1, nk);
  }
  for (int t0 = 0; t0 < dsub; t0 += dc) {
    const int w = min(dc, dsub - t0);
    __syncthreads();  // the last chunk's reads are done
    lut_stage(cb_s, ds, cbm + t0, dsub, nk, w);
    lut_stage(q_s, dq, q + q0 * d + (long long)m * dsub + t0, d, nq, w);
    lut_stage(cen_s, dq, cen + c0 * d + (long long)m * dsub + t0, d, nc, w);
    cp_async_wait_all();
    __syncthreads();
    const bool first = t0 == 0;
    for (int j = tid; j < nk; j += kLutThreads) {
      float cj[kLutCols];
#pragma unroll
      for (int t = 0; t < kLutCols; ++t)
        cj[t] = t < w ? cb_s[j * ds + t] : 0.f;
#pragma unroll 4
      for (int i = 0; i < nq; ++i) {
        const float4* xq = reinterpret_cast<const float4*>(q_s + i * dq);
        float xv[kLutCols];
#pragma unroll
        for (int t4 = 0; t4 < kLutCols / 4; ++t4) {
          if (4 * t4 < w) {
            const float4 v = xq[t4];
            xv[4 * t4] = v.x;
            xv[4 * t4 + 1] = v.y;
            xv[4 * t4 + 2] = v.z;
            xv[4 * t4 + 3] = v.w;
          }
        }
        float acc = __fmul_rn(xv[0], cj[0]);
        if (!first) acc = __fadd_rn(qdot_s[i * kc + j], acc);
#pragma unroll
        for (int t = 1; t < kLutCols; ++t)
          if (t < w) acc = __fadd_rn(acc, __fmul_rn(xv[t], cj[t]));
        qdot_s[i * kc + j] = acc;
      }
    }
    for (int e = tid; e < nq * nc; e += kLutThreads) {
      const int i = e / nc, c = e - i * nc;
      const float* xq = q_s + i * dq;
      const float* xc = cen_s + c * dq;
      float r = __fsub_rn(xq[0], xc[0]);
      float acc = __fmul_rn(r, r);
      if (!first) acc = __fadd_rn(qres_s[i * cr + c], acc);
      for (int t = 1; t < w; ++t) {
        r = __fsub_rn(xq[t], xc[t]);
        acc = __fadd_rn(acc, __fmul_rn(r, r));
      }
      qres_s[i * cr + c] = acc;
    }
  }
  __syncthreads();
  constexpr int V = VEC ? 4 : 1;
  const int nv = nk / V;             // VEC: nk is a multiple of 4
  if (!full) {                       // the cross term alone, (b, M, ksub)
    for (int u = tid; u < nq * nv; u += kLutThreads) {
      const int i = u / nv, j = (u - i * nv) * V;
      float* o = out + ((long long)(q0 + i) * M + m) * ksub + j0 + j;
      if constexpr (VEC)
        *reinterpret_cast<float4*>(o) =
            *reinterpret_cast<const float4*>(qdot_s + i * kc + j);
      else
        *o = qdot_s[i * kc + j];
    }
    return;
  }
  for (int u = tid; u < nq * nc * nv; u += kLutThreads) {
    const int j = (u % nv) * V;
    const int r = u / nv;
    const int c = r % nc, i = r / nc;
    const float qr = qres_s[i * cr + c];
    float* o = out + (((long long)(q0 + i) * M + m) * ncoarse + c0 + c) *
                         ksub + j0 + j;
    if constexpr (VEC) {
      const float4 qd = *reinterpret_cast<const float4*>(qdot_s + i * kc + j);
      const float4 cd = *reinterpret_cast<const float4*>(cdot_s + c * kc + j);
      const float4 sq = *reinterpret_cast<const float4*>(cbsq_s + j);
      *reinterpret_cast<float4*>(o) = make_float4(
          lut_entry(qr, qd.x, cd.x, sq.x), lut_entry(qr, qd.y, cd.y, sq.y),
          lut_entry(qr, qd.z, cd.z, sq.z), lut_entry(qr, qd.w, cd.w, sq.w));
    } else {
      *o = lut_entry(qr, qdot_s[i * kc + j], cdot_s[c * kc + j], cbsq_s[j]);
    }
  }
}

// luts (b, mk) -> lq (mk, bp), queries innermost, columns b..bp-1 zeroed:
// a 32 x 32 tile a block through shared memory, read along mk, written
// along the queries.
__global__ void __launch_bounds__(kThreads)
pq_lut_relayout_kernel(const float* __restrict__ luts, float* __restrict__ lq,
                       long long mk, int b, int bp) {
  __shared__ float t[32][33];
  const long long e0 = (long long)blockIdx.x * 32;
  const int q0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += kAdcWarps) {
    const int q = q0 + i;
    const long long e = e0 + tx;
    t[i][tx] = q < b && e < mk ? luts[(long long)q * mk + e] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += kAdcWarps) {
    const long long e = e0 + i;
    const int q = q0 + tx;
    if (e < mk && q < bp) lq[e * bp + q] = t[tx][i];
  }
}

// V consecutive floats of the relayout LUT, one 16-, 8- or 4-byte load.
template <int V>
__device__ __forceinline__ void load_lut(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// The ADC scan over the relayout LUT lq (M, K, bp): one block per (tile of
// 1 << rows_log2 rows, group of QP query slots, blockIdx.y). The launch
// covers queries [q_begin, q_end). aligned: the codes' base address is
// 16-byte aligned, so the tile is copied in whole 16-byte pieces.
template <typename CodeT, int QP>
__global__ void __launch_bounds__(kThreads, 2)
pq_adc_kernel(const CodeT* __restrict__ codes, const float* __restrict__ lq,
              float* __restrict__ out, long long n, int bp, int q_begin,
              int q_end, int M, long long K, int rows_log2, int aligned) {
  constexpr int V = QP < 4 ? QP : 4;   // floats a lane loads
  constexpr int L = QP / V;            // lanes a row
  constexpr int RW = 32 / L;           // rows a warp instruction
  constexpr int STEP = RW * kAdcUnroll;
  extern __shared__ __align__(16) unsigned char adc_smem[];
  const int rows_tile = 1 << rows_log2;
  const size_t code_bytes =
      ((size_t)rows_tile * M * sizeof(CodeT) + 15) & ~(size_t)15;
  const CodeT* code_s = reinterpret_cast<const CodeT*>(adc_smem);
  float* out_s = reinterpret_cast<float*>(adc_smem + code_bytes);
  const int stride = rows_tile + 1;    // odd: conflict-free row reads
  const long long row0 = (long long)blockIdx.x * rows_tile;
  const int rows = (int)(n - row0 < rows_tile ? n - row0 : rows_tile);
  const int qg0 = q_begin + blockIdx.y * QP;
  const int qn = q_end - qg0 < QP ? q_end - qg0 : QP;
  {  // the tile's codes into shared memory
    const unsigned char* src = reinterpret_cast<const unsigned char*>(codes) +
                               row0 * M * (long long)sizeof(CodeT);
    unsigned char* dst = adc_smem;
    const int bytes = rows * M * (int)sizeof(CodeT);
    int done = 0;
    if (aligned) {
      const int n16 = bytes >> 4;
      for (int i = threadIdx.x; i < n16; i += kThreads)
        cp_async16(dst + 16 * i, src + 16 * (long long)i);
      done = n16 << 4;
    }
    for (int i = done + threadIdx.x; i < bytes; i += kThreads) dst[i] = src[i];
    cp_async_wait_all();
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lr = lane / L;             // row within a warp instruction
  const int qoff = (lane % L) * V;     // first query slot of this lane
  if (qoff < qn) {
    const float* base = lq + qg0 + qoff;
    for (int r0 = warp * STEP; r0 < rows; r0 += kAdcWarps * STEP) {
      float acc[kAdcUnroll][V];
      int rr[kAdcUnroll];
#pragma unroll
      for (int u = 0; u < kAdcUnroll; ++u) {
        rr[u] = r0 + u * RW + lr;
        if (rr[u] < rows)    // the sum starts from the m = 0 entry
          load_lut<V>(base + (long long)code_s[rr[u] * M] * bp, acc[u]);
      }
#pragma unroll 4
      for (int m = 1; m < M; ++m) {
        const long long mk = (long long)m * K;
#pragma unroll
        for (int u = 0; u < kAdcUnroll; ++u) {
          if (rr[u] < rows) {
            float v[V];
            load_lut<V>(base + (mk + code_s[rr[u] * M + m]) * bp, v);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[u][j] += v[j];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kAdcUnroll; ++u) {
        if (rr[u] >= rows) continue;
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (qoff + j < qn) out_s[(qoff + j) * stride + rr[u]] = acc[u][j];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < qn << rows_log2; i += kThreads) {
    const int q = i >> rows_log2;
    const int r = i & (rows_tile - 1);
    if (r < rows)
      out[(long long)(qg0 + q) * n + row0 + r] = out_s[q * stride + r];
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

// The scan LUT of ops.pq_scan_luts: queries (b, M * dsub), codebooks
// (M, ksub, dsub), centres (ncoarse, M * dsub), coarse_dot (ncoarse, M,
// ksub), cb_sq (M, ksub), fp32 -> out (b, M, ncoarse * ksub). With
// ncoarse = 0 (cen, cdot, cbsq unused) the cross term alone, out (b, M,
// ksub): pq_lut_qdot. qt queries, kc codewords and cr coarse ids a block
// (pq_lut.luts_plan); vec: 16-byte stores (kc and ksub multiples of 4, the
// pointers 16-byte aligned).
extern "C" int fcvi_pq_scan_luts(const float* q, const float* cb,
                                 const float* cen, const float* cdot,
                                 const float* cbsq, float* out, int b, int M,
                                 int ksub, int dsub, int ncoarse, int qt,
                                 int kc, int cr, int vec, void* stream) {
  if (b <= 0 || M <= 0 || ksub <= 0 || dsub <= 0 || ncoarse < 0)
    return (int)cudaSuccess;
  if (qt < 1 || kc < 1 || (ncoarse > 0 && cr < 1) || M > 65535 ||
      (vec && (kc % 4 || ksub % 4)))
    return (int)cudaErrorInvalidValue;
  const long long qtiles = (b + qt - 1) / qt;
  const long long kchunks = (ksub + kc - 1) / kc;
  const long long csplits = ncoarse > 0 ? (ncoarse + cr - 1) / cr : 1;
  const long long blocks = qtiles * kchunks * csplits;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      pq_luts_smem(qt, kc, ncoarse > 0 ? cr : 0, dsub < kLutCols ? dsub
                                                                  : kLutCols);
  auto kern = vec ? pq_scan_luts_kernel<true> : pq_scan_luts_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)M);
  kern<<<grid, kLutThreads, smem, (cudaStream_t)stream>>>(
      q, cb, cen, cdot, cbsq, out, b, M, ksub, dsub, ncoarse, qt, kc, cr,
      (int)qtiles, (int)kchunks);
  return (int)cudaGetLastError();
}

namespace {

size_t pq_adc_smem(int qp, int rows_log2, int M, int code_bytes) {
  const size_t rows = (size_t)1 << rows_log2;
  return ((rows * M * code_bytes + 15) & ~(size_t)15) +
         sizeof(float) * qp * (rows + 1);
}

template <typename CodeT, int QP>
int launch_pq_adc(const CodeT* codes, const float* lq, float* out,
                  long long n, int bp, int q_begin, int groups, int nq, int M,
                  long long K, int rows_log2, cudaStream_t st) {
  const size_t smem = pq_adc_smem(QP, rows_log2, M, (int)sizeof(CodeT));
  const cudaError_t err = cudaFuncSetAttribute(
      pq_adc_kernel<CodeT, QP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n + (1LL << rows_log2) - 1) >> rows_log2;
  const int aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  pq_adc_kernel<CodeT, QP><<<grid, kThreads, smem, st>>>(
      codes, lq, out, n, bp, q_begin, q_begin + nq, M, K, rows_log2,
      aligned);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int launch_pq_adc_qp(int qp, const CodeT* codes, const float* lq, float* out,
                     long long n, int bp, int q_begin, int groups, int nq,
                     int M, long long K, int rows_log2, cudaStream_t st) {
  switch (qp) {
#define FCVI_ADC_CASE(Q)                                                   \
  case Q:                                                                  \
    return launch_pq_adc<CodeT, Q>(codes, lq, out, n, bp, q_begin, groups, \
                                   nq, M, K, rows_log2, st);
    FCVI_ADC_CASE(1)
    FCVI_ADC_CASE(2)
    FCVI_ADC_CASE(4)
    FCVI_ADC_CASE(8)
    FCVI_ADC_CASE(16)
    FCVI_ADC_CASE(32)
    FCVI_ADC_CASE(kAdcGroup)
#undef FCVI_ADC_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// codes: (n, M) of code_bytes bytes each (1: uint8, 4: int32), every value
// in [0, K); luts (b, M, K) fp32; out (b, n) fp32. lq: the (M, K, bp)
// scratch the LUTs are copied to, or luts itself at b = 1 (bp = 1: the
// layouts agree and no copy runs). parts: nparts scan launches of five ints
// each, (first query, query groups, queries, query slots QP a group, log2
// of the rows a tile), from the wrapper's plan (kernels/pq_lut.py
// adc_plan).
extern "C" int fcvi_pq_score(const void* codes, int code_bytes,
                             const float* luts, float* lq, float* out,
                             long long n, int b, int bp, int M, long long K,
                             int nparts, const int* parts, void* stream) {
  if (n <= 0 || b <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (lq != luts) {
    const long long mk = (long long)M * K;
    const dim3 grid((unsigned)((mk + 31) / 32), (unsigned)((bp + 31) / 32));
    pq_lut_relayout_kernel<<<grid, kThreads, 0, st>>>(luts, lq, mk, b, bp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else if (b != 1 || bp != 1) {
    return (int)cudaErrorInvalidValue;
  }
  for (int p = 0; p < nparts; ++p) {
    const int* a = parts + 5 * p;
    int err;
    if (code_bytes == 1)
      err = launch_pq_adc_qp(a[3], (const uint8_t*)codes, lq, out, n, bp,
                             a[0], a[1], a[2], M, K, a[4], st);
    else if (code_bytes == 4)
      err = launch_pq_adc_qp(a[3], (const int32_t*)codes, lq, out, n, bp,
                             a[0], a[1], a[2], M, K, a[4], st);
    else
      return (int)cudaErrorInvalidValue;
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaSuccess;
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
