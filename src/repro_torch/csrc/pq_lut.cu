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
// pq.search runs lax.top_k(-pq_score_batch(...))), without the (b, n)
// distance matrix. The rows are laid out once, at build, stably grouped by
// coarse id (codes, original row ids, group offsets), so a run of rows reads
// one coarse id's (M, ksub) slice of the scan LUT. A score is the
// left-to-right fp32 sum over m started from the m = 0 entry (the plain
// version's bits) and enters the top-k as one 64-bit word, (order-preserving
// bits of -d2) << 32 | ~(original row id): topk_first_packed's key, so -0.0
// ranks below +0.0 and equal scores go to the smaller row, as lax.top_k
// orders them. Bound on the H100: bytes (the grouped uint8 codes, row ids
// and the batch's LUTs, about 29 MB at b = 64, n = 1M, M = 8: 0.0086 ms);
// its floor in practice is the b * n * M LUT lookups in shared memory (2.05
// GB at b = 64: about 0.07 ms at 132 SMs x 128 B a clock). Launches:
//   the relayout (pq_lut_relayout_kernel, B9's): the LUTs to (M, K, bp),
//     queries innermost, so one (m, code) entry of a query tile is one run;
//   the sample pass (pq_sample_kernel) and pq_threshold_kernel, on the
//     buffered path of at least 8 kk rows: the words of an even sample of
//     the grouped rows (up to 16,384, an eighth at most), and as each
//     query's starting threshold the lower edge of its kk-th best sampled
//     word's 24-bit bin (two 12-bit histogram passes); every word of the
//     true top-kk is at or above it, so a chunk admits a few words a query
//     a tile where it admitted every row before its first cut;
//   pass 1 (pq_topk_kernel): one block per (query tile of bq, chunk of
//     grouped rows), two blocks an SM. Each coarse group the chunk meets has
//     its (M, ksub, bq) slice staged once by cp.async (or is read from L2
//     when one query's slice does not fit). A warp's lanes take query slots
//     first (4 a lane: one 16-byte load of a slice entry) and rows second,
//     two rows a lane a step, the rows' codes read from device memory (M =
//     8 uint8 codes a step ahead). A first test on the distance alone (a float compare with
//     the threshold's top half) lets a step with no candidate in the warp
//     pass on; a word at or above its query's threshold (in registers) is
//     appended to the query's buffer in shared memory (kk, a margin and
//     some slack), past it to a spill area in device memory. Every tile of
//     rows the block meets once (twice after a cut): the buffers past cap -
//     margin are cut back to kk, spill included, by the warp that owns the
//     query (warp_cut on words: a radix select of 8-bit digits that keeps
//     their order, __syncwarp only), raising its threshold to the kk-th
//     word. The block writes its chunk's words a query (at most kk,
//     unordered, 0 in empty slots);
//   pass 2 (pq_merge_kernel): one block per query keeps the kk best of its
//     chunks' words with the same cut (stream_words, stream_topk's pattern
//     on words), sorts those kk once and decodes (vals, ids).
// The selection path (the buffers do not fit, or the planner's measured
// rule, or the caller asks): pass 1 writes every -d2 to a (b, n) scratch in
// grouped order, then the multi-block radix select of select_common.cuh
// (its passes, then pq_select_kernel, one block per query) takes the top-kk
// words by the same key.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ring_topk.cuh"

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

// ---- pq_score_topk: the fused ADC scan + top-k over the grouped rows ----

constexpr int kTopkWarps = kThreads / 32;   // a pass-1 block's warps
constexpr int kWordRound = 256;             // words a warp reads a round
constexpr int kMaxWordWarps = 8;            // warps a merge block, at most
constexpr int kTopkRows = 2;                // rows a pass-1 lane scores a step

// One call's operands, scratch and plan (kernels/pq_lut.py's PqTopkArgs
// fills the same fields in the same order).
struct PqTopkArgs {
  const void* codes;      // (n, M) in grouped order, code_bytes each
  const int* gid;         // (n,) original row ids, grouped order
  const int* goff;        // (ncoarse + 1,) the groups' offsets
  const float* luts;      // (b, M, ncoarse * ksub)
  float* lq;              // (M, K, bp): the LUTs, queries innermost (luts
                          //   itself at b = bp = 1)
  u64* sw;                // (b, sample) the sample's words
  u64* thr;               // (b,) starting thresholds, or null
  u64* part;              // (b, nchunks, kk) each chunk's words (buffered)
  u64* spill;             // (blocks, bq, tile) pass 1's overflow (buffered)
  float* sel;             // (b, n) -d2 in grouped order (selection), or null
  long long* stats;       // null, or 4 int64 zeros (pq_lut.STAT_NAMES)
  float* vals;            // (b, kk) -d2
  int* ids;               // (b, kk) original row ids
  long long n;
  long long chunk_rows;   // grouped rows a chunk
  long long sample;       // sampled rows (0: no starting threshold)
  int code_bytes;
  int ncoarse;
  int b;
  int bp;                 // lq's query stride: b padded (pq_lut.topk_plan)
  int M;
  int ksub;
  int bq;                 // queries a pass-1 block (1, 2, 4, 8, 16)
  int staged;             // the tile's LUT slice lives in shared memory
  int kk;
  int cap;                // words a query's buffer (0: selection path)
  int tile;               // rows between two looks at the buffers
  int margin;             // a buffer past cap - margin is cut after a tile
  int nchunks;
  int wslots;             // words a merge warp's buffer
  int wwarps;             // warps a merge block
};

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Pass 1's dynamic shared memory (pq_lut.topk_smem): the tile's LUT slice
// (M, ksub, bq) when staged, and on the buffered path the queries' word
// buffers and each warp's 256 digit counters.
size_t pq_topk_smem(int bq, int staged, int cap, int M, int ksub) {
  size_t s = staged ? round16((size_t)bq * M * ksub * sizeof(float)) : 0;
  if (cap > 0)
    s += (size_t)bq * cap * sizeof(u64) + sizeof(unsigned) * 256 * kTopkWarps;
  return s;
}

// B (4, 8 or 16) bytes global -> shared by cp.async
template <int B>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem) {
  if constexpr (B == 16) {
    cp_async16(smem, gmem);
  } else if constexpr (B == 8) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    cp_async4(smem, gmem);
  }
}

// The last group c with goff[c] <= r: the group holding grouped row r
// (empty groups share their offset with the next).
__device__ __forceinline__ int group_of(const int* goff, int ncoarse,
                                        long long r) {
  int lo = 0, hi = ncoarse - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (goff[mid] <= r) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Four consecutive codes of a row (4-byte aligned for uint8, 16-byte for
// int32), one load through the read-only path.
template <typename CodeT>
__device__ __forceinline__ void codes4(const CodeT* p, int (&c)[4]) {
  if constexpr (sizeof(CodeT) == 1) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    c[0] = w & 255u;
    c[1] = (w >> 8) & 255u;
    c[2] = (w >> 16) & 255u;
    c[3] = w >> 24;
  } else {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p));
    c[0] = w.x;
    c[1] = w.y;
    c[2] = w.z;
    c[3] = w.w;
  }
}

// V consecutive query slots of one LUT entry: from the staged slice in
// shared memory, or from lq through L2.
template <bool STAGED, int V>
__device__ __forceinline__ void lut_at(const float* p, float (&v)[V]) {
  if constexpr (STAGED) {
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else if constexpr (V == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      v[0] = t.x;
      v[1] = t.y;
    } else {
      v[0] = *p;
    }
  } else {
    load_lut<V>(p, v);
  }
}

// One row's distances for a lane's V query slots: the left-to-right fp32
// sum over m started from the m = 0 entry (the plain version's bits). cr is
// the row's codes in device memory, read four a load where vec (M a
// multiple of 4, the codes aligned). lb points at the lane's first slot of
// entry (m = 0, code 0); ms and js are the m and code strides in floats
// (32-bit in shared memory).
template <bool STAGED>
using LutOff = std::conditional_t<STAGED, int, long long>;

template <typename CodeT, int V, bool STAGED>
__device__ __forceinline__ void score_row(const CodeT* cr, int M, bool vec,
                                          const float* lb, LutOff<STAGED> ms,
                                          LutOff<STAGED> js, float (&acc)[V]) {
  if (vec) {
    int cc[4];
    codes4(cr, cc);
    lut_at<STAGED, V>(lb + cc[0] * js, acc);
#pragma unroll
    for (int u = 1; u < 4; ++u) {
      float v[V];
      lut_at<STAGED, V>(lb + u * ms + cc[u] * js, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += v[j];
    }
#pragma unroll 2
    for (int m0 = 4; m0 < M; m0 += 4) {
      codes4(cr + m0, cc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[V];
        lut_at<STAGED, V>(lb + (m0 + u) * ms + cc[u] * js, v);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += v[j];
      }
    }
  } else {
    lut_at<STAGED, V>(lb + (int)__ldg(cr) * js, acc);
    for (int m = 1; m < M; ++m) {
      float v[V];
      lut_at<STAGED, V>(lb + m * ms + (int)__ldg(cr + m) * js, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += v[j];
    }
  }
}

// score_row for M = 8 uint8 codes held in one 8-byte word.
template <int V, bool STAGED>
__device__ __forceinline__ void score_row8(uint2 cw, const float* lb,
                                           LutOff<STAGED> ms,
                                           LutOff<STAGED> js,
                                           float (&acc)[V]) {
  lut_at<STAGED, V>(lb + (int)(cw.x & 255u) * js, acc);
#pragma unroll
  for (int m = 1; m < 8; ++m) {
    const unsigned c = ((m < 4 ? cw.x : cw.y) >> (8 * (m & 3))) & 255u;
    float v[V];
    lut_at<STAGED, V>(lb + m * ms + (int)c * js, v);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += v[j];
  }
}

// Group c's LUT slice for the block's BQ queries, (M, ksub, BQ) queries
// innermost, from lq (M, K, bp) by cp.async: each (m, code) is one run of
// BQ floats there.
template <int BQ>
__device__ __forceinline__ void stage_slice(float* dst, const float* lq,
                                            long long K, int bp, int M,
                                            int ksub, int c, int q0) {
  constexpr int V = BQ < 4 ? BQ : 4;
  constexpr int P = BQ / V;    // V-float pieces an entry
  const int total = M * ksub * P;
  const float* src0 = lq + (long long)c * ksub * bp + q0;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int mj = i / P, p = i - mj * P;
    const int m = mj / ksub, j = mj - m * ksub;
    cp_async_n<4 * V>(dst + mj * BQ + p * V,
                      src0 + ((long long)m * K + j) * bp + p * V);
  }
}

// Pass 1: one block per (query tile of BQ, chunk of grouped rows). Each
// coarse group the chunk meets has its (M, ksub, BQ) LUT slice staged once
// by cp.async (STAGED; else the lanes read lq through L2). A warp's lanes
// take query slots first (V of them, one 16-, 8- or 4-byte load an entry)
// and rows second, kTopkRows rows a lane a step (their loads in flight
// together); a lane reads its rows' codes from device memory (M = 8 uint8
// codes: one 8-byte load a row, a step ahead). Buffered (a.sel null): a
// step whose scores all fail a first test on the distance alone (against
// the float of the threshold's top half) passes on with one warp vote;
// else a score enters its query's buffer as the word pack(ord_bits(-d2),
// id) when it is at or above the query's threshold (in registers: the
// sample's, then each cut's kk-th word); an append past the
// buffer's cap goes to the block's spill area in device memory. Every
// a.tile rows the block meets (__syncthreads_or: did any append pass cap -
// margin) and the buffers past the mark are cut back to kk, with their
// spill, by the warp that owns the query (query qi belongs to warp qi % 8;
// warp_cut, __syncwarp only); a second barrier follows a cut. The block
// writes its chunk's (at most) kk words a query to a.part, 0 in the empty
// slots. Selection (a.sel not null): writes -d2 to a.sel in grouped order.
template <typename CodeT, int BQ, bool STAGED>
__global__ void __launch_bounds__(kThreads, 2)
pq_topk_kernel(const PqTopkArgs a, int vec) {
  constexpr int V = BQ < 4 ? BQ : 4;   // query slots a lane
  constexpr int L = BQ / V;            // lanes a row
  constexpr int RW = 32 / L;           // rows a warp instruction
  constexpr int U = kTopkRows;
  extern __shared__ __align__(16) unsigned char pq_smem[];
  __shared__ u64 thr_s[BQ];
  __shared__ int cnt_s[BQ];
  const CodeT* codes = static_cast<const CodeT*>(a.codes);
  const int M = a.M, ksub = a.ksub, bp = a.bp, kk = a.kk, cap = a.cap;
  const long long n = a.n;
  const long long K = (long long)a.ncoarse * ksub;
  const int tile = a.tile, mark = a.cap - a.margin;
  const bool select = a.sel != nullptr;
  const size_t slice_bytes =
      STAGED ? round16((size_t)M * ksub * BQ * sizeof(float)) : 0;
  float* lut_s = reinterpret_cast<float*>(pq_smem);
  u64* buf = reinterpret_cast<u64*>(pq_smem + slice_bytes);   // (BQ, cap)
  unsigned* hist = reinterpret_cast<unsigned*>(buf + (size_t)BQ * cap);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int nq = a.b - q0 < BQ ? a.b - q0 : BQ;
  const long long r_begin = (long long)blockIdx.y * a.chunk_rows;
  const long long r_end =
      r_begin + a.chunk_rows < n ? r_begin + a.chunk_rows : n;
  const int lr = lane / L;               // row within a warp instruction
  const int qoff = (lane % L) * V;       // the lane's first query slot
  // the block's spill area: tile words a query
  u64* spill = select ? nullptr
                      : a.spill + ((long long)blockIdx.y * gridDim.x +
                                   blockIdx.x) * BQ * tile;
  if (!select && tid < BQ) {
    thr_s[tid] = a.thr != nullptr && tid < nq ? a.thr[q0 + tid] : 0ull;
    cnt_s[tid] = 0;
  }
  __syncthreads();
  // The lane's queries' thresholds (words), and a first test on the
  // distance alone: a word at or above t[j] has -d2 >= the float of its top
  // half, so d2 <= ntf[j] (that float negated; -0.0 and +0.0 compare equal
  // here, and the words decide). An empty slot's ntf is -inf: no row
  // passes.
  u64 t[V];
  float ntf[V];
  auto refresh = [&]() {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      t[j] = !select && qoff + j < nq ? thr_s[qoff + j] : 0ull;
      const unsigned h = (unsigned)(t[j] >> 32);
      ntf[j] = select || qoff + j >= nq ? -INFINITY
               : h <= 0x007fffffu       ? INFINITY   // below -inf: all pass
                                        : -from_ord(h);
    }
  };
  refresh();
  const bool fast8 = sizeof(CodeT) == 1 && M == 8 && vec;
  long long ncut = 0, cut_words = 0, removed = 0;   // the owner warps' profile
  int c = group_of(a.goff, a.ncoarse, r_begin);
  int staged_c = -1;
  for (long long t0 = r_begin; t0 < r_end; t0 += tile) {
    const long long t1 = t0 + tile < r_end ? t0 + tile : r_end;
    bool crossed = false;
    for (long long s0 = t0; s0 < t1;) {
      while (a.goff[c + 1] <= s0) ++c;
      const long long s1 = a.goff[c + 1] < t1 ? a.goff[c + 1] : t1;
      const float* lb;
      LutOff<STAGED> ms, js;
      if constexpr (STAGED) {
        if (c != staged_c) {
          __syncthreads();             // the old slice's readers are done
          stage_slice<BQ>(lut_s, a.lq, K, bp, M, ksub, c, q0);
          cp_async_wait_all();
          __syncthreads();
          staged_c = c;
        }
        lb = lut_s + qoff;
        ms = ksub * BQ;
        js = BQ;
      } else {
        lb = a.lq + (long long)c * ksub * bp + q0 + qoff;
        ms = K * bp;
        js = bp;
      }
      // a step's rows (r0 + u * RW + lr): their -d2 to a.sel, or their
      // words past their thresholds to the buffers
      auto emit = [&](long long r0, float (&acc)[U][V]) {
        if (select) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const long long r = r0 + u * RW + lr;
            if (r >= s1) continue;
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (qoff + j < nq)
                a.sel[(long long)(q0 + qoff + j) * n + r] = -acc[u][j];
          }
          return;
        }
        bool hit = false;
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < V; ++j)
            hit |= r0 + u * RW + lr < s1 && acc[u][j] <= ntf[j];
        if (!__any_sync(0xffffffffu, hit)) return;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long r = r0 + u * RW + lr;
          if (r >= s1) continue;
          int id = -1;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (!(acc[u][j] <= ntf[j])) continue;
            const unsigned hi = ord_bits(-acc[u][j]);
            if (hi < (unsigned)(t[j] >> 32)) continue;
            if (id < 0) id = a.gid[r];
            const u64 w = pack(hi, id);
            if (w < t[j]) continue;
            const int pos = atomicAdd(&cnt_s[qoff + j], 1);
            if (pos < cap)
              buf[(qoff + j) * cap + pos] = w;
            else
              spill[(qoff + j) * tile + pos - cap] = w;
            crossed |= pos >= mark;
          }
        }
      };
      constexpr int kStep = kTopkWarps * RW * U;
      if (fast8) {   // M = 8 uint8 codes: a row's codes in one 8-byte load,
                     // the next step's in flight during this one
        const uint2* c8 = reinterpret_cast<const uint2*>(codes);
        auto load8 = [&](long long r0, uint2 (&w)[U]) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const long long r = r0 + u * RW + lr;
            w[u] = __ldg(c8 + (r < s1 ? r : s1 - 1));
          }
        };
        long long r0 = s0 + warp * RW * U;
        uint2 cw[U];
        if (r0 < s1) load8(r0, cw);
        for (; r0 < s1; r0 += kStep) {
          uint2 nw[U];
          if (r0 + kStep < s1) load8(r0 + kStep, nw);
          float acc[U][V];
#pragma unroll
          for (int u = 0; u < U; ++u) score_row8<V, STAGED>(cw[u], lb, ms, js, acc[u]);
          emit(r0, acc);
#pragma unroll
          for (int u = 0; u < U; ++u) cw[u] = nw[u];
        }
      } else {
        for (long long r0 = s0 + warp * RW * U; r0 < s1; r0 += kStep) {
          float acc[U][V];
#pragma unroll
          for (int u = 0; u < U; ++u) {   // past the segment: its last row
            long long r = r0 + u * RW + lr;
            r = r < s1 ? r : s1 - 1;
            score_row<CodeT, V, STAGED>(codes + r * M, M, vec, lb, ms, js,
                                        acc[u]);
          }
          emit(r0, acc);
        }
      }
      s0 = s1;
    }
    if (select) continue;
    if (__syncthreads_or(crossed)) {   // cut the buffers past the mark
      for (int qi = warp; qi < nq; qi += kTopkWarps) {
        const int cn = cnt_s[qi];
        if (cn <= mark) continue;
        const u64 w = warp_cut(Words{buf + qi * cap, spill + qi * tile, cap},
                               cn, kk, hist + 256 * warp);
        if (lane == 0) {
          cnt_s[qi] = kk;
          thr_s[qi] = w;
          ++ncut;
          cut_words += cn;
          removed += cn - kk;
        }
      }
      __syncthreads();
      refresh();
    }
  }
  if (select) return;
  // each owner warp cuts its queries' buffers to kk and writes them
  long long admitted = 0;
  for (int qi = warp; qi < nq; qi += kTopkWarps) {
    int cn = cnt_s[qi];
    u64* qb = buf + qi * cap;
    admitted += cn;
    if (cn > kk) {
      warp_cut(Words{qb, spill + qi * tile, cap}, cn, kk, hist + 256 * warp);
      ++ncut;
      cut_words += cn;
      cn = kk;
    }
    u64* dst = a.part + ((long long)(q0 + qi) * a.nchunks + blockIdx.y) * kk;
    for (int j = lane; j < kk; j += 32) dst[j] = j < cn ? qb[j] : 0ull;
  }
  if (a.stats != nullptr && lane == 0 && warp < nq) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.stats),
              (unsigned long long)(admitted + removed));
    atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + 1),
              (unsigned long long)ncut);
    atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + 2),
              (unsigned long long)cut_words);
    if (warp == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + 3),
                (unsigned long long)nq);
  }
}

// The sample pass: each thread scores one evenly spaced grouped row, p = v
// * n / sample, for V query slots (lq through L2; a row's query groups on
// neighbouring threads, so their loads share sectors) and writes its words
// to sw (b, sample).
template <typename CodeT, int V>
__global__ void __launch_bounds__(kThreads)
pq_sample_kernel(const PqTopkArgs a) {
  const long long count = a.sample;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int groups = a.bp / V;
  if (i >= count * groups) return;
  const long long v = i / groups;
  const int g = (int)(i - v * groups);
  const long long p = v * a.n / count;
  const int c = group_of(a.goff, a.ncoarse, p);
  const CodeT* cr = static_cast<const CodeT*>(a.codes) + p * a.M;
  const long long K = (long long)a.ncoarse * a.ksub;
  const float* base = a.lq + (long long)c * a.ksub * a.bp + g * V;
  float acc[V];
  load_lut<V>(base + (long long)__ldg(cr) * a.bp, acc);
  for (int m = 1; m < a.M; ++m) {
    float x[V];
    load_lut<V>(base + ((long long)m * K + (long long)__ldg(cr + m)) * a.bp,
                x);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += x[j];
  }
  const int id = a.gid[p];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int q = g * V + j;
    if (q < a.b) a.sw[(long long)q * count + v] = pack(ord_bits(-acc[j]), id);
  }
}

constexpr int kThrDigit = 12;                 // bits a threshold pass reads
constexpr int kThrBins = 1 << kThrDigit;
constexpr int kThrThreads = 1024;

// The starting thresholds: one block per query, two passes of 12-bit
// digits from the top over its sample's words (sample >= kk, all real):
// the bin that holds the kk-th best word, then its sub-bin. The threshold
// is that sub-bin's lower edge (the kk-th word's top 24 bits, the rest 0):
// at or below the kk-th best sampled word, so every word of the true top-kk
// is at or above it. (A word's top 24 bits are its score's sign, exponent
// and 15 mantissa bits: the edge admits at most the words a 2^-15 relative
// step below the kk-th.)
__global__ void __launch_bounds__(kThrThreads)
pq_threshold_kernel(const u64* __restrict__ sw, long long count, int kk,
                    u64* __restrict__ thr) {
  __shared__ unsigned hist[kThrBins];
  __shared__ unsigned pick, skipped;
  constexpr int kPer = kThrBins / kThrThreads;   // bins a thread sums
  const u64* src = sw + (long long)blockIdx.x * count;
  u64 prefix = 0, fixed = 0;
  unsigned want = (unsigned)kk;
  for (int pass = 0; pass < 2; ++pass) {
    const int shift = 64 - kThrDigit * (pass + 1);
    for (int i = threadIdx.x; i < kThrBins; i += kThrThreads) hist[i] = 0;
    __syncthreads();
    // 8 words a thread in flight, then one atomic a distinct bin a warp
    // (most words share a few bins)
    for (long long e0 = threadIdx.x; e0 < count; e0 += 8 * kThrThreads) {
      u64 w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long e = e0 + (long long)u * kThrThreads;
        w[u] = e < count ? src[e] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const bool in = e0 + (long long)u * kThrThreads < count &&
                        (w[u] & fixed) == prefix;
        const unsigned bin = (unsigned)(w[u] >> shift) & (kThrBins - 1);
        const unsigned peers =
            __match_any_sync(__activemask(), in ? bin : kThrBins);
        if (in && (threadIdx.x & 31) == __ffs(peers) - 1)
          atomicAdd(&hist[bin], (unsigned)__popc(peers));
      }
    }
    __syncthreads();
    // thread t holds bins kThrBins - 1 - kPer t down: the best first
    unsigned sum = 0;
    for (int i = 0; i < kPer; ++i)
      sum += hist[kThrBins - 1 - kPer * threadIdx.x - i];
    unsigned total;
    unsigned above = block_scan(sum, &total);
    if (above < want && above + sum >= want) {
      for (int i = 0; i < kPer; ++i) {
        const int bin = kThrBins - 1 - kPer * threadIdx.x - i;
        if (above + hist[bin] >= want) {
          pick = (unsigned)bin;
          skipped = above;
          break;
        }
        above += hist[bin];
      }
    }
    __syncthreads();
    prefix |= (u64)pick << shift;
    fixed |= (u64)(kThrBins - 1) << shift;
    want -= skipped;
    __syncthreads();   // pick and skipped are read before the next pass
  }
  if (threadIdx.x == 0) thr[blockIdx.x] = prefix;
}

// Keeps the kk best words above thr0 of src[0, len) (0 marks an empty
// slot), as stream_topk keeps (score, id) pairs: each warp streams its share
// (8 words a lane before testing any), appends those above its threshold to
// its own buffer of `slots` words (a ballot, no atomics) and cuts it back to
// kk by warp_cut when the next round might not fit; then warp 0 gathers the
// warps' lists and cuts them to kk. Leaves them, unordered, in warp 0's
// buffer (bufs[0, count)) and returns count = min(kk, words above thr0).
// slots >= kk + kWordRound and >= 2 kk. Every thread of the block calls it.
__device__ int stream_words(const u64* __restrict__ src, long long len,
                            int kk, int slots, u64 thr0, u64* bufs,
                            unsigned* hists) {
  __shared__ int counts[kMaxWordWarps];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* bw = bufs + (size_t)warp * slots;
  unsigned* hist = hists + 256 * warp;
  u64 thr = thr0;
  int cnt = 0;
  for (long long base = (long long)warp * kWordRound; base < len;
       base += (long long)warps * kWordRound) {
    u64 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const long long e = base + u * 32 + lane;
      v[u] = e < len ? src[e] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool in = v[u] > thr;
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (in) bw[cnt + __popc(bal & ((1u << lane) - 1u))] = v[u];
      cnt += __popc(bal);
    }
    __syncwarp();
    if (cnt > slots - kWordRound) {
      thr = warp_cut(Words{bw, nullptr, slots}, cnt, kk, hist);
      cnt = kk;
    }
  }
  if (cnt > kk) {
    warp_cut(Words{bw, nullptr, slots}, cnt, kk, hist);
    cnt = kk;
  }
  if (lane == 0) counts[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    int total = counts[0];
    for (int w = 1; w < warps; ++w) {
      if (total + counts[w] > slots) {   // room for the next list
        warp_cut(Words{bw, nullptr, slots}, total, kk, hist);
        total = kk;
      }
      const u64* ws = bufs + (size_t)w * slots;
      for (int j = lane; j < counts[w]; j += 32) bw[total + j] = ws[j];
      total += counts[w];
      __syncwarp();
    }
    if (total > kk) {
      warp_cut(Words{bw, nullptr, slots}, total, kk, hist);
      total = kk;
    }
    if (lane == 0) counts[0] = total;
  }
  __syncthreads();
  return counts[0];
}

// Pass 2: one block per query keeps the kk best of its chunks' words
// (nchunks lists of kk, 0 for an empty slot) with stream_words, sorts those
// kk once, best first, and decodes them. It starts from the largest of the
// full lists' least words (each is at or below the query's kk-th best
// word), so the stream admits little past the kk it keeps.
__global__ void __launch_bounds__(kMaxWordWarps * 32)
pq_merge_kernel(const u64* __restrict__ part, int nchunks, int kk,
                int slots, float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) u64 mbuf[];
  __shared__ u64 bound;
  const long long qi = blockIdx.x;
  const long long len = (long long)nchunks * kk;
  const u64* src = part + qi * len;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* hists = reinterpret_cast<unsigned*>(mbuf + (size_t)warps * slots);
  if (threadIdx.x == 0) bound = 0;
  __syncthreads();
  for (int ch = warp; ch < nchunks; ch += warps) {   // a list a warp
    u64 least = ~0ull;
    for (int j = lane; j < kk; j += 32) {
      const u64 w = src[(long long)ch * kk + j];
      least = w < least ? w : least;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 v = __shfl_xor_sync(0xffffffffu, least, o);
      least = v < least ? v : least;
    }
    if (lane == 0 && least != 0) atomicMax(&bound, least);   // a full list
  }
  __syncthreads();
  const u64 thr0 = bound != 0 ? bound - 1 : 0;   // the bound's word competes
  const int cnt = stream_words(src, len, kk, slots, thr0, mbuf, hists);
  int len2 = 1;
  while (len2 < kk) len2 <<= 1;
  for (int j = cnt + threadIdx.x; j < len2; j += blockDim.x) mbuf[j] = 0;
  __syncthreads();
  sort_desc(mbuf, nullptr, 1, len2);
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
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

template <typename CodeT, int BQ, bool STAGED>
int launch_pq_topk(const PqTopkArgs& a, cudaStream_t st) {
  const int cap = a.sel != nullptr ? 0 : a.cap;
  const size_t smem = pq_topk_smem(BQ, STAGED, cap, a.M, a.ksub);
  const cudaError_t err = cudaFuncSetAttribute(
      pq_topk_kernel<CodeT, BQ, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // four codes a load: M a multiple of 4 and the rows aligned to them
  const int vec = a.M % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(a.codes) & 15) == 0;
  const dim3 grid((unsigned)((a.b + BQ - 1) / BQ), (unsigned)a.nchunks);
  pq_topk_kernel<CodeT, BQ, STAGED><<<grid, kThreads, smem, st>>>(a, vec);
  return (int)cudaGetLastError();
}

template <typename CodeT>
int launch_pq_topk_bq(const PqTopkArgs& a, cudaStream_t st) {
  switch (a.bq) {
#define FCVI_TOPK_CASE(Q)                                             \
  case Q:                                                             \
    return a.staged ? launch_pq_topk<CodeT, Q, true>(a, st)           \
                    : launch_pq_topk<CodeT, Q, false>(a, st);
    FCVI_TOPK_CASE(1)
    FCVI_TOPK_CASE(2)
    FCVI_TOPK_CASE(4)
    FCVI_TOPK_CASE(8)
    FCVI_TOPK_CASE(16)
#undef FCVI_TOPK_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <typename CodeT>
int launch_pq_sample(const PqTopkArgs& a, cudaStream_t st) {
  const int v = a.bp % 4 == 0 ? 4 : a.bp % 2 == 0 ? 2 : 1;
  const long long threads = a.sample * (a.bp / v);
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (v == 4)
    pq_sample_kernel<CodeT, 4><<<blocks, kThreads, 0, st>>>(a);
  else if (v == 2)
    pq_sample_kernel<CodeT, 2><<<blocks, kThreads, 0, st>>>(a);
  else
    pq_sample_kernel<CodeT, 1><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

size_t pq_words_smem(int slots, int warps) {
  return (size_t)warps * ((size_t)slots * sizeof(u64) + 256 * sizeof(unsigned));
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

// The fused ADC scan + top-k over the grouped layout (pq_lut.pq_score_topk):
// a's codes (n, M) of code_bytes bytes each (1: uint8, 4: int32) and gid
// (n,) in grouped order, goff (ncoarse + 1,), luts (b, M, ncoarse * ksub)
// fp32 -> vals (b, kk) = -d2 and ids (b, kk) original row ids, ranked by the
// packed key. Launches: the LUT relayout to lq (none at b = 1), then on the
// buffered path (a.sel null) the sample pass and the threshold kernel (where
// a.sample > 0), pass 1 and the merge; on the selection path (a.sel, a (b,
// n) fp32 scratch) pass 1, then the select's passes and pq_select_kernel
// with sel_args (select_common.cuh's SelectArgs; null on the buffered path).
// (args is a PqTopkArgs; its type is local to this file, so the C
// interface takes its address untyped, as it takes sel_args.)
extern "C" int fcvi_pq_score_topk(const void* args, const void* sel_args,
                                  void* stream) {
  const PqTopkArgs& a = *static_cast<const PqTopkArgs*>(args);
  if (a.n <= 0 || a.b <= 0) return (int)cudaSuccess;
  const bool select = a.sel != nullptr;
  const SelectArgs* sa = static_cast<const SelectArgs*>(sel_args);
  if (a.bq < 1 || a.bq > kMaxBQ || a.bp < a.b || a.bp % a.bq ||
      (select && sa == nullptr) ||
      (!select && (a.cap < a.kk + a.margin || a.margin < 1 ||
                   a.margin > a.tile || a.tile < 1 || a.spill == nullptr ||
                   a.wwarps < 1 || a.wwarps > kMaxWordWarps)) ||
      (a.code_bytes != 1 && a.code_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.lq != a.luts) {
    const long long mk = (long long)a.M * a.ncoarse * a.ksub;
    const dim3 grid((unsigned)((mk + 31) / 32), (unsigned)((a.bp + 31) / 32));
    pq_lut_relayout_kernel<<<grid, kThreads, 0, st>>>(a.luts, a.lq, mk, a.b,
                                                      a.bp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else if (a.b != 1 || a.bp != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t wsmem = pq_words_smem(a.wslots, a.wwarps);
  int err;
  if (!select && a.sample > 0) {
    err = a.code_bytes == 1 ? launch_pq_sample<uint8_t>(a, st)
                            : launch_pq_sample<int32_t>(a, st);
    if (err != (int)cudaSuccess) return err;
    pq_threshold_kernel<<<a.b, kThrThreads, 0, st>>>(a.sw, a.sample, a.kk,
                                                     a.thr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  PqTopkArgs p = a;
  if (select || a.sample <= 0) p.thr = nullptr;
  err = a.code_bytes == 1 ? launch_pq_topk_bq<uint8_t>(p, st)
                          : launch_pq_topk_bq<int32_t>(p, st);
  if (err != (int)cudaSuccess) return err;
  if (select) {
    cudaError_t e = select_passes(PqScores{a.sel, a.gid, a.n}, *sa, st);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = select_smem(*sa);
    e = cudaFuncSetAttribute(pq_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    pq_select_kernel<<<a.b, kSelThreads, smem, st>>>(*sa, a.sel, a.n, a.vals,
                                                     a.ids);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaFuncSetAttribute(
      pq_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wsmem);
  if (e != cudaSuccess) return (int)e;
  pq_merge_kernel<<<a.b, 32 * a.wwarps, wsmem, st>>>(
      a.part, a.nchunks, a.kk, a.wslots, a.vals, a.ids);
  return (int)cudaGetLastError();
}
