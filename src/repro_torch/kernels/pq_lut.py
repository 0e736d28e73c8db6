"""CUDA kernels B8/B9/B10: PQ LUTs and ADC scans.

One CUDA source (``csrc/pq_lut.cu``) replaces the three Pallas kernels of
``repro/kernels/pq_lut.py``:

* ``pq_lut_qdot`` (B8): (b, M, dsub) x (M, ksub, dsub) -> (b, M, ksub), the
  q . codebook cross term of ``index.pq.compute_luts``. It runs as the
  cross-term-only mode of ``pq_scan_luts``'s kernel, counted under its own
  name; no serving path launches it;
* ``pq_score_batch`` (B9): codes (n, M) uint8 or int32, luts (b, M, K) ->
  squared distances (b, n), each a left-to-right fp32 sum over m. The call
  copies the LUTs once to (M, K, bp), queries innermost (``bp`` is b padded
  to the load width), then scans the rows with a warp's lanes on a group's
  query slots first and rows second (``adc_plan``);
* ``pq_score`` (B10): the same at one LUT, (M, K) -> (n,); B9's scan at
  b = 1, where the LUT needs no copy, counted under its own name.

and, for the serving path:

* ``pq_scan_luts``: the whole scan LUT of ``index.pq.scan_luts``, (b, M,
  ncoarse * ksub), in one launch: B8's cross term, the residual norms and
  the build-time terms, each table entry written once
  (``ref.ref_pq_scan_luts``'s bits; ``luts_plan`` tiles queries,
  codewords and coarse ids so that any shape fits and the grid fills the
  card);
* ``pq_score_topk``: B9 and the first-occurrence top-k of its negated
  distances as one fused scan over the rows grouped by coarse id
  (``index.pq.PQIndex``'s grouped layout), never writing the (b, n)
  distances; its (vals, ids) are ``ref.ref_pq_score_topk``'s bits. A
  sample of the rows sets each query's starting threshold, each coarse
  group's LUT slice is staged queries innermost, and each query's buffer is
  cut back to kk by its own warp (``topk_plan``). Past what the buffers
  hold, or where the measured rule says the select is faster, it takes the
  selection path (counted ``pq_score_topk_select``). No serving path
  launches B9 any more.

The wrappers take unpadded shapes (the JAX ``pq_score`` needs n to divide
its row block; these do not), check operands, launch on the current stream
and count launches in ``_build``. Codes must lie in [0, K): the kernel
reads the LUT at them unchecked, as the TPU kernel's one-hot does not fault
either. The plain versions are ``ref.ref_pq_*``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build

NAME_QDOT = "pq_lut_qdot"
NAME_LUTS = "pq_scan_luts"
NAME_BATCH = "pq_score_batch"
NAME_SCORE = "pq_score"
NAME_TOPK = "pq_score_topk"

SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (bytes)
LUT_QT = 8            # queries a pq_scan_luts block, at most
LUT_COLS = 16         # dsub columns it stages at a time (kLutCols)
LUT_SMEM_TARGET = 65_536  # its shared memory, at most: three blocks an SM
THREADS = 256         # threads per pq_score_topk and pq_adc block (kThreads)
MAX_BQ = 16           # queries per pq_score_topk block, at most (kMaxBQ)
TOPK_WARPS = THREADS // 32   # a pass-1 block's warps (kTopkWarps)
ADC_GROUP = 64        # query slots a pq_adc block, at most (kAdcGroup)
ADC_UNROLL = 2        # row steps a pq_adc lane keeps in flight (kAdcUnroll)
ADC_ROWS = 256        # rows a pq_adc tile before shared memory halves it
ADC_MIN_ROWS = 32     # the fewest rows a pq_adc tile is cut to
# pq_adc's dynamic shared memory, at most: two blocks an SM
ADC_SMEM_TARGET = SMEM_LIMIT // 2 - 1024
# pq_score_topk's pass-1 dynamic shared memory, beside its static
# thresholds and counts: one block an SM, or two (the SM's 233,472 bytes
# halved, less each block's 1 KB reserve)
TOPK_SMEM_LIMIT = SMEM_LIMIT - 1024
TOPK_SMEM_TWO = 233_472 // 2 - 1024 - 512
TOPK_TILE = 2048      # rows a pass-1 block scans between looks at its buffers
TOPK_MARGIN = 128     # a buffer past cap - margin words is cut after a tile
TOPK_MIN_SLACK = 64   # buffer words past kk + the margin, at least
TOPK_MAX_SLACK = 2048  # and at most (fewer, larger cuts up to there)
TOPK_SAMPLE = 16_384  # rows the sample pass scores, at most (n / 8 at most)
WORD_ROUND = 256      # words a merge warp reads a round
WORD_WARPS = 8        # warps a merge block, at most
# the buffered path's largest kk, and the most words its merge reads a
# query (chunks x kk), before the selection path: measured on the H100
# (scripts/profile_topk.py --pq: kk 320 / 512 / 1024 / 2048 at b=64; kk 80
# and 320 at b = 1 to 64)
SELECT_FROM_KK = 320
MERGE_WORDS_MAX = 32_768
CODE_BYTES = {torch.uint8: 1, torch.int32: 4}


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def luts_smem(qt: int, kc: int, cr: int, dsub: int) -> int:
    """pq_scan_luts' dynamic shared memory in bytes (the source's
    ``pq_luts_smem``): the cross term (qt, kc), the coarse_dot slice
    (cr, kc), cb_sq (kc), a chunk of LUT_COLS columns of the codewords (an
    odd stride) and of the queries and centres (rows of 16 bytes), and the
    residual norms (qt, cr); each region a multiple of 16 bytes."""
    dc = min(dsub, LUT_COLS)
    dq = _round4(dc)
    return 4 * (_round4(qt * kc) + _round4(cr * kc) + _round4(kc)
                + _round4(kc * (dc | 1)) + qt * dq + cr * dq
                + _round4(qt * cr))


@dataclasses.dataclass(frozen=True)
class LutPlan:
    qt: int          # queries a block
    kc: int          # codewords a block (ksub, or a chunk of it)
    cr: int          # coarse ids a block (0: the cross term alone)
    vec: bool        # 16-byte stores: ksub and kc multiples of 4
    blocks: int      # blocks a subspace (the grid's x; M is its y)
    smem: int        # dynamic shared memory in bytes


@functools.lru_cache(maxsize=256)
def luts_plan(b: int, m: int, ksub: int, dsub: int, ncoarse: int,
              num_sms: int) -> LutPlan:
    """Launch shape of ``pq_scan_luts`` (``ncoarse`` = 0: the cross term
    alone, ``pq_lut_qdot``) for any b, M, ksub, dsub and ncoarse: up to
    LUT_QT queries a block; the codewords halved into chunks (multiples of
    4 where the stores are 16 bytes) until their staged columns fit
    LUT_SMEM_TARGET; the coarse ids split across blocks until the grid
    covers the SMs once, and further while their slices do not fit. A
    block's staging is its fixed cost, so the blocks stay few and large
    (``scripts/profile_rerank_adc.py --luts`` times every tiling)."""
    if min(b, m, ksub, dsub) < 1 or ncoarse < 0:
        raise ValueError(f"no scan LUT of b={b}, M={m}, ksub={ksub}, "
                         f"dsub={dsub}, ncoarse={ncoarse}")
    if m > 65535:
        raise ValueError(f"M={m} subspaces past the grid's 65535")
    vec = ksub % 4 == 0
    step = 4 if vec else 1
    qt = min(LUT_QT, b)
    kc = ksub
    while kc > step and luts_smem(qt, kc, min(ncoarse, 1),
                                  dsub) > LUT_SMEM_TARGET:
        kc = _round4(kc // 2) if vec else kc // 2
    kchunks = math.ceil(ksub / kc)
    base = math.ceil(b / qt) * kchunks
    cr, csplits = 0, 1
    if ncoarse:
        cr = max(1, ncoarse // math.ceil(num_sms / (base * m)))
        while cr > 1 and luts_smem(qt, kc, cr, dsub) > LUT_SMEM_TARGET:
            cr = math.ceil(cr / 2)
        csplits = math.ceil(ncoarse / cr)
    blocks = base * csplits
    if blocks >= 2 ** 31:
        raise ValueError(f"{blocks} blocks past the grid's 2^31 - 1")
    return LutPlan(qt=qt, kc=kc, cr=cr, vec=vec, blocks=blocks,
                   smem=luts_smem(qt, kc, cr, dsub))


@functools.lru_cache(maxsize=None)
def _num_sms(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _luts(queries, codebooks, centers, coarse_dot, cb_sq, name: str,
          plan: Optional[LutPlan] = None):
    """Launch pq_scan_luts' kernel: queries (b, M * dsub); with ``centers``
    None, the cross term alone (b, M, ksub), else the scan LUT (b, M,
    ncoarse * ksub)."""
    b = queries.shape[0]
    m, ksub, dsub = codebooks.shape
    ncoarse = 0 if centers is None else centers.shape[0]
    dev = queries.device
    p = plan or luts_plan(b, m, ksub, dsub, ncoarse, _num_sms(dev.index))
    out = torch.empty((b, m, max(ncoarse, 1) * ksub), dtype=torch.float32,
                      device=dev)
    ptr = _build.ptr
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_pq_scan_luts(
            queries.data_ptr(), codebooks.data_ptr(), ptr(centers),
            ptr(coarse_dot), ptr(cb_sq), out.data_ptr(), b, m, ksub, dsub,
            ncoarse, p.qt, p.kc, p.cr, int(p.vec), _build.stream(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def pq_lut_qdot(queries_sub: torch.Tensor,
                codebooks: torch.Tensor) -> torch.Tensor:
    """queries_sub (b, M, dsub), codebooks (M, ksub, dsub), float32 on one
    CUDA device. Returns (b, M, ksub) float32, each a column-order fp32
    sum of the dsub products."""
    if queries_sub.dim() != 3 or codebooks.dim() != 3:
        raise ValueError("queries_sub and codebooks must be 3-D")
    b, m, dsub = queries_sub.shape
    ksub = codebooks.shape[1]
    dev = queries_sub.device
    _build.require(queries_sub, "queries_sub", (b, m, dsub), dev)
    _build.require(codebooks, "codebooks", (m, ksub, dsub), dev)
    return _luts(queries_sub.view(b, m * dsub), codebooks, None, None, None,
                 NAME_QDOT)


def pq_scan_luts(queries: torch.Tensor, codebooks: torch.Tensor,
                 coarse_centers: torch.Tensor, coarse_dot: torch.Tensor,
                 cb_sq: torch.Tensor, *,
                 _plan: Optional[LutPlan] = None) -> torch.Tensor:
    """queries (b, d), codebooks (M, ksub, dsub) with d = M * dsub,
    coarse_centers (ncoarse, d), coarse_dot (ncoarse, M, ksub), cb_sq (M,
    ksub), float32 on one CUDA device. Returns the scan LUT (b, M, ncoarse
    * ksub) float32, ``ref.ref_pq_scan_luts``'s bits, whatever the tiling;
    ``_plan`` forces one (profiles only)."""
    if queries.dim() != 2 or codebooks.dim() != 3:
        raise ValueError("queries must be 2-D and codebooks 3-D")
    b, d = queries.shape
    m, ksub, dsub = codebooks.shape
    ncoarse = coarse_centers.shape[0]
    if m * dsub != d or ncoarse < 1:
        raise ValueError(f"queries of width {d} against {m} x {dsub} "
                         f"subspaces and {ncoarse} coarse centres")
    dev = queries.device
    _build.require(queries, "queries", (b, d), dev)
    _build.require(codebooks, "codebooks", (m, ksub, dsub), dev)
    _build.require(coarse_centers, "coarse_centers", (ncoarse, d), dev)
    _build.require(coarse_dot, "coarse_dot", (ncoarse, m, ksub), dev)
    _build.require(cb_sq, "cb_sq", (m, ksub), dev)
    return _luts(queries, codebooks, coarse_centers, coarse_dot, cb_sq,
                 NAME_LUTS, _plan)


@dataclasses.dataclass(frozen=True)
class AdcPart:
    """One launch of the ADC scan (``pq_adc_kernel``)."""
    q0: int          # first query
    groups: int      # query groups of ``qp`` slots (the grid's y)
    nq: int          # queries
    qp: int          # query slots a group: a power of two, <= ADC_GROUP
    vec: int         # floats a lane loads: min(4, qp)
    lanes: int       # lanes a row: qp / vec
    rows: int        # rows a block tile, a power of two
    tiles: int       # row tiles (the grid's x)
    smem: int        # dynamic shared memory in bytes


@dataclasses.dataclass(frozen=True)
class AdcPlan:
    bp: int          # the relayout LUT's row: b padded to the load width
    relayout: bool   # b > 1: the LUTs are copied to (M, K, bp) first
    parts: tuple     # one AdcPart, or two (full groups of 64, the tail)
    out_span: int    # b * n: the output's largest offset + 1
    lut_span: int    # M * K * bp: the relayout LUT's largest offset + 1


def adc_smem(qp: int, rows: int, m: int, code_bytes: int) -> int:
    """pq_adc's dynamic shared memory in bytes (the source's
    ``pq_adc_smem``): the tile's codes, padded to 16 bytes, and its
    (qp, rows + 1) fp32 output tile."""
    return ((rows * m * code_bytes + 15) & ~15) + 4 * qp * (rows + 1)


def adc_part(q0: int, groups: int, nq: int, qp: int, n: int, m: int,
             code_bytes: int) -> AdcPart:
    vec = min(4, qp)
    lanes = qp // vec
    step = (THREADS // 32) * ADC_UNROLL * (32 // lanes)  # rows a block step
    rows = max(ADC_ROWS, step)
    while rows > ADC_MIN_ROWS and adc_smem(qp, rows, m,
                                           code_bytes) > ADC_SMEM_TARGET:
        rows //= 2
    smem = adc_smem(qp, rows, m, code_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"M={m} codes a row do not fit in shared memory")
    tiles = max(1, math.ceil(n / rows))
    if tiles >= 2 ** 31:
        raise ValueError(f"n={n} rows past the grid's 2^31 - 1 tiles")
    return AdcPart(q0=q0, groups=groups, nq=nq, qp=qp, vec=vec, lanes=lanes,
                   rows=rows, tiles=tiles, smem=smem)


def adc_plan(n: int, b: int, m: int, k: int, code_bytes: int) -> AdcPlan:
    """Launch shape of ``pq_score_batch`` / ``pq_score`` for b queries over
    n rows of M codes (``code_bytes`` each) into a K-wide LUT. A group of
    queries takes qp = the next power of two of its size, at most 64
    slots: a lane loads min(4, qp) of a code's consecutive query entries,
    qp / that many lanes cover a row, and a warp instruction covers the
    rest of its 32 lanes' rows. A batch past 64 runs groups of 64 and a
    tail group of its own qp. The rows a tile start at a block's step, at
    least 256 (512 where a lane owns a row), and halve, down to 32, while
    the codes and the output tile would keep two blocks off an SM."""
    if b < 1 or m < 1 or k < 1:
        raise ValueError(f"no ADC scan of b={b}, M={m}, K={k}")
    vec0 = min(4, _pow2(b))
    bp = -(-b // vec0) * vec0
    parts = []
    if b <= ADC_GROUP:
        parts.append(adc_part(0, 1, b, _pow2(b), n, m, code_bytes))
    else:
        full = b // ADC_GROUP
        parts.append(adc_part(0, full, full * ADC_GROUP, ADC_GROUP, n, m,
                              code_bytes))
        tail = b - full * ADC_GROUP
        if tail:
            parts.append(adc_part(full * ADC_GROUP, 1, tail, _pow2(tail), n,
                                  m, code_bytes))
    return AdcPlan(bp=bp, relayout=b > 1, parts=tuple(parts), out_span=b * n,
                   lut_span=m * k * bp)


def _score(codes: torch.Tensor, luts: torch.Tensor, name: str):
    if codes.dim() != 2 or luts.dim() != 3:
        raise ValueError("codes must be 2-D and luts 3-D")
    n, m = codes.shape
    b, _, k = luts.shape
    dev = codes.device
    if codes.dtype not in CODE_BYTES:
        raise ValueError(f"codes must be uint8 or int32, got {codes.dtype}")
    _build.require(codes, "codes", (n, m), dev, codes.dtype)
    _build.require(luts, "luts", (b, m, k), dev)
    p = adc_plan(n, b, m, k, CODE_BYTES[codes.dtype])
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    lq = (torch.empty((m, k, p.bp), dtype=torch.float32, device=dev)
          if p.relayout else luts)
    parts = (ctypes.c_int * (5 * len(p.parts)))(*(
        v for a in p.parts
        for v in (a.q0, a.groups, a.nq, a.qp, a.rows.bit_length() - 1)))
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_pq_score(codes.data_ptr(), CODE_BYTES[codes.dtype],
                                 luts.data_ptr(), lq.data_ptr(),
                                 out.data_ptr(), n, b, p.bp, m, k,
                                 len(p.parts), parts, _build.stream(dev))
    _build.check(code, name)
    _build.count(name)
    return out


def pq_score_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (n, M) uint8 or int32 in [0, K), luts (b, M, K) float32, on one
    CUDA device. Returns squared distances (b, n) float32."""
    return _score(codes, luts, NAME_BATCH)


def pq_score(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (n, M) uint8 or int32 in [0, K), lut (M, K) float32. Returns
    squared distances (n,) float32."""
    if lut.dim() != 2:
        raise ValueError("lut must be 2-D (M, K)")
    return _score(codes, lut[None], NAME_SCORE)[0]


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    bq: int           # queries per pass-1 block (1, 2, 4, 8, 16)
    staged: bool      # the query tile's LUT slices live in shared memory
    blocks_per_sm: int  # pass-1 blocks an SM (2, or 1 where 2 do not fit)
    tile: int         # rows pass 1 scans between looks at its buffers
    margin: int       # a buffer past cap - margin words is cut after a tile
    cap: int          # pass-1 buffer words a query (0 on the selection path)
    nchunks: int      # chunks of grouped rows, one pass-1 block column each
    chunk_rows: int   # grouped rows per chunk (a multiple of 256)
    bp: int           # the relayout LUT's query stride: b padded
    sample: int       # rows the sample pass scores (0: no threshold)
    word_slots: int   # words a merge warp's buffer (buffered)
    word_warps: int   # warps a merge block (buffered)
    smem: int         # pass 1's dynamic shared memory in bytes
    select: bool      # the selection path


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def topk_smem(bq: int, staged: bool, cap: int, m: int, ksub: int) -> int:
    """pq_score_topk's pass-1 dynamic shared memory in bytes (the source's
    ``pq_topk_smem``): the tile's (M, ksub, bq) LUT slice when staged,
    padded to 16 bytes, and with buffers (``cap`` > 0) the queries' 8-byte
    words and each warp's 256 digit counters."""
    s = _round16(4 * bq * m * ksub) if staged else 0
    if cap:
        s += 8 * bq * cap + 4 * 256 * TOPK_WARPS
    return s


def word_plan(kk: int):
    """(slots, warps) of the merge block's word buffers (``stream_words``): kk plus room for a round of reads and for another
    list of kk, four rounds where shared memory holds eight warps' buffers;
    the warps halve until the buffers fit. None where one warp's does not."""
    for rounds in (4, 1):
        slots = kk + max(kk, rounds * WORD_ROUND)
        warps = WORD_WARPS
        while warps and warps * (8 * slots + 1024) > TOPK_SMEM_LIMIT:
            warps //= 2
        if warps == WORD_WARPS or (warps and rounds == 1):
            return slots, warps
    return None


def topk_plan(n: int, b: int, kk: int, m: int, ksub: int, num_sms: int,
              select: Optional[bool] = None) -> TopkPlan:
    """Launch shape of ``pq_score_topk`` for any 1 <= kk <= n. Pass 1 takes
    the widest query tile (16 down to 1, at most b's next power of two)
    that fits two blocks an SM (else one) with its (M, ksub) LUT slices
    staged (else read from L2) and, on the buffered path, buffers of kk +
    TOPK_MARGIN + at least TOPK_MIN_SLACK words a query (up to
    TOPK_MAX_SLACK of slack, as shared memory allows); it looks at its
    buffers every TOPK_TILE rows, an append past a buffer going to a spill
    area of TOPK_TILE words a (block, query) in device memory. The chunks
    fill one wave of blocks (floor: no tail wave). The sample pass runs on
    a corpus of at least 8 kk rows (``TOPK_SAMPLE`` rows, an eighth of n at
    most). The selection path takes a kk whose buffers or merge do not
    fit, past SELECT_FROM_KK, or whose merge would read more than
    MERGE_WORDS_MAX words a query (``select`` forces either path)."""
    if not 0 < kk <= n:
        raise ValueError(f"k={kk} outside 1..{n} (the corpus size)")
    widest = max(1, min(MAX_BQ, _pow2(b)))
    need = kk + TOPK_MARGIN + TOPK_MIN_SLACK

    def pick(buffered: bool):
        """(bq, staged, blocks an SM, cap) of the first query tile that
        fits, with buffers of ``need`` words a query or more (``buffered``)
        or none."""
        for per_sm, budget in ((2, TOPK_SMEM_TWO), (1, TOPK_SMEM_LIMIT)):
            for staged in (True, False):
                bq = widest
                while bq >= 1:
                    fixed = topk_smem(bq, staged, 0, m, ksub)
                    if not buffered and fixed <= budget:
                        return bq, staged, per_sm, 0
                    room = (budget - fixed - 4 * 256 * TOPK_WARPS) // (8 * bq)
                    if buffered and room >= need:
                        return (bq, staged, per_sm,
                                min(room, kk + TOPK_MARGIN + TOPK_MAX_SLACK))
                    bq //= 2
        return None

    def chunks(bq: int, per_sm: int) -> tuple:
        """(chunks, rows a chunk): one wave of blocks (floor: no tail)."""
        qtiles = math.ceil(b / bq)
        nch = max(1, min(math.ceil(n / 256), per_sm * num_sms // qtiles))
        rows = math.ceil(math.ceil(n / nch) / 256) * 256
        return math.ceil(n / rows), rows

    buf = pick(True)
    words = word_plan(kk)
    fits = buf is not None and words is not None
    if select is None:
        select = (not fits or kk > SELECT_FROM_KK
                  or chunks(buf[0], buf[2])[0] * kk > MERGE_WORDS_MAX)
    elif not select and not fits:
        raise ValueError(f"kk={kk}: the buffers do not fit")
    if select:
        fit = pick(False)
        if fit is None:
            raise ValueError(f"M={m} LUT entries past shared memory")
        words = (0, 0)
    else:
        fit = buf
    bq, staged, per_sm, cap = fit
    bp = b if b <= 2 else -(-b // max(bq, 4)) * max(bq, 4)
    nchunks, chunk_rows = chunks(bq, per_sm)
    if nchunks >= 65536:
        raise ValueError(f"{nchunks} chunks past the grid's 65535")
    sample = min(TOPK_SAMPLE, n // 8)
    if select or n < 8 * kk or sample < kk:
        sample = 0
    return TopkPlan(bq=bq, staged=staged, blocks_per_sm=per_sm,
                    tile=TOPK_TILE, margin=TOPK_MARGIN, cap=cap,
                    nchunks=nchunks, chunk_rows=chunk_rows, bp=bp,
                    sample=sample, word_slots=words[0], word_warps=words[1],
                    smem=topk_smem(bq, staged, cap, m, ksub), select=select)


class PqTopkArgs(ctypes.Structure):
    """csrc/pq_lut.cu's PqTopkArgs: the same fields in the same order."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("codes", "gid", "goff", "luts", "lq",
                                        "sw", "thr", "part", "spill", "sel",
                                        "stats", "vals", "ids")]
        + [(f, ctypes.c_longlong) for f in ("n", "chunk_rows", "sample")]
        + [(f, ctypes.c_int) for f in ("code_bytes", "ncoarse", "b", "bp",
                                       "m", "ksub", "bq", "staged", "kk",
                                       "cap", "tile", "margin", "nchunks",
                                       "wslots", "wwarps")])


# pass 1's optional profile (``_stats=``): words admitted to the buffers,
# cuts (a tile's and the chunk's last), the words those cuts read, and the
# (query, chunk) pairs, summed over the blocks
STAT_NAMES = ("admitted", "cuts", "cut_words", "query_chunks")
STATS = len(STAT_NAMES)


def pq_score_topk(codes: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, offsets_host: Sequence[int],
                  luts: torch.Tensor, k: int, *,
                  _select: Optional[bool] = None,
                  _sel_stats: Optional[torch.Tensor] = None,
                  _stats: Optional[torch.Tensor] = None,
                  _plan: Optional[TopkPlan] = None):
    """The fused ADC scan + first-occurrence top-k over the grouped layout:
    codes (n, M) uint8 or int32 and ids (n,) int32 (original row ids) in
    coarse-grouped order, offsets (ncoarse + 1,) int32 the groups' offsets
    on the card and ``offsets_host`` the same on the host, luts (b, M,
    ncoarse * ksub) float32. Returns (vals (b, k) f32 = -d2, ids (b, k)
    int32 original row ids), ranked by the order-preserving bits of -d2,
    then the smaller id. ``_select`` forces the selection path (True) or
    the buffered one (False), for holding one against the other;
    ``_sel_stats`` (``_build.select_stats``) takes the select's profile and
    ``_stats`` (an int64 tensor of STATS zeros on the card) pass 1's
    (``STAT_NAMES``); ``_plan`` replaces the planned launch (tests: smaller
    buffers, so that cuts run)."""
    if codes.dim() != 2 or luts.dim() != 3:
        raise ValueError("codes must be 2-D and luts 3-D")
    n, m = codes.shape
    b, _, width = luts.shape
    ncoarse = len(offsets_host) - 1
    dev = codes.device
    if codes.dtype not in CODE_BYTES:
        raise ValueError(f"codes must be uint8 or int32, got {codes.dtype}")
    if ncoarse < 1 or width % ncoarse or offsets_host[-1] != n:
        raise ValueError("offsets must hold ncoarse + 1 group offsets ending "
                         f"at n={n}, with luts {ncoarse} groups wide")
    ksub = width // ncoarse
    cb = CODE_BYTES[codes.dtype]
    _build.require(codes, "codes", (n, m), dev, codes.dtype)
    _build.require(ids, "ids", (n,), dev, torch.int32)
    _build.require(offsets, "offsets", (ncoarse + 1,), dev, torch.int32)
    _build.require(luts, "luts", (b, m, width), dev)
    if _stats is not None:
        _build.require(_stats, "_stats", (STATS,), dev, torch.int64)
    p = _plan or topk_plan(n, b, k, m, ksub, _num_sms(dev.index), _select)
    # one scratch: the relayout LUT, then the sample's words and the
    # thresholds, or the (b, n) scores of the selection path, then the
    # chunks' words and pass 1's spill area
    parts = {"lq": 0 if p.bp == 1 else 4 * m * width * p.bp,
             "sw": 8 * b * p.sample, "thr": 8 * b if p.sample else 0,
             "sel": 4 * b * n if p.select else 0,
             "part": 0 if p.select else 8 * b * p.nchunks * k,
             "spill": 0 if p.select else 8 * math.ceil(b / p.bq) * p.bq
             * p.nchunks * p.tile}
    scratch = torch.empty(sum(-(-v // 256) * 256 for v in parts.values()),
                          dtype=torch.uint8, device=dev)
    at, ptrs = scratch.data_ptr(), {}
    for name, nbytes in parts.items():
        ptrs[name] = at if nbytes else None
        at += -(-nbytes // 256) * 256
    if ptrs["lq"] is None:
        ptrs["lq"] = luts.data_ptr()
    sel_args = sel_scratch = None
    if p.select:
        sp = _build.select_plan(b, n, k, _num_sms(dev.index))
        sel_args, sel_scratch = _build.select_args(sp, b, k, dev, _sel_stats)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    args = PqTopkArgs(
        codes.data_ptr(), ids.data_ptr(), offsets.data_ptr(),
        luts.data_ptr(), ptrs["lq"], ptrs["sw"], ptrs["thr"], ptrs["part"],
        ptrs["spill"], ptrs["sel"], _build.ptr(_stats), vals.data_ptr(),
        out_ids.data_ptr(), n, p.chunk_rows, p.sample, cb, ncoarse, b, p.bp,
        m, ksub, p.bq, int(p.staged), k, p.cap, p.tile, p.margin,
        p.nchunks, p.word_slots, p.word_warps)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_pq_score_topk(ctypes.addressof(args),
                                      _build.addr(sel_args),
                                      _build.stream(dev))
    name = NAME_TOPK + ("_select" if p.select else "")
    _build.check(code, name)
    _build.count(name)
    if p.select:
        _build.count(_build.SELECT_NAME)
    return vals, out_ids
