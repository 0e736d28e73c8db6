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
  (``index.pq.PQIndex``'s grouped layout), staging each group's LUT slice
  in shared memory and never writing the (b, n) distances; its (vals, ids)
  are ``ref.ref_pq_score_topk``'s bits. Past the candidate buffers' kk it
  takes the selection path (counted ``pq_score_topk_select``). No serving
  path launches B9 any more.

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
ADC_GROUP = 64        # query slots a pq_adc block, at most (kAdcGroup)
ADC_UNROLL = 2        # row steps a pq_adc lane keeps in flight (kAdcUnroll)
ADC_ROWS = 256        # rows a pq_adc tile before shared memory halves it
ADC_MIN_ROWS = 32     # the fewest rows a pq_adc tile is cut to
# pq_adc's dynamic shared memory, at most: two blocks an SM
ADC_SMEM_TARGET = SMEM_LIMIT // 2 - 1024
# pq_score_topk's dynamic shared memory, beside its static thresholds
TOPK_SMEM_LIMIT = SMEM_LIMIT - 1024
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
    bq: int           # queries per pass-1 block (1..MAX_BQ)
    staged: bool      # the query tile's LUT slices live in shared memory
    cap: int          # pass-1 candidate buffer per query (power of two)
    nchunks: int      # chunks of grouped rows, one pass-1 block column each
    chunk_rows: int   # grouped rows per chunk (multiple of THREADS)
    merge_cap: int    # pass-2 candidate buffer (power of two)
    select: bool      # the selection path: no buffers (cap, merge_cap 0)


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def topk_smem(bq: int, staged: bool, cap: int, m: int, ksub: int) -> int:
    """pq_score_topk's pass-1 dynamic shared memory in bytes (the source's
    ``pq_topk_smem``): the tile's (M, ksub) LUT slices when staged, padded
    to 16 bytes, and its 8-byte candidate words."""
    lut = (bq * m * ksub * 4 + 15) & ~15 if staged else 0
    return lut + 8 * bq * cap


def topk_plan(n: int, b: int, kk: int, m: int, ksub: int, num_sms: int,
              select: Optional[bool] = None) -> TopkPlan:
    """Launch shape of ``pq_score_topk`` for any 1 <= kk <= n: the widest
    query tile (16, 8, 4, 2, 1) whose LUT slices (4 * M * ksub bytes a
    query) and candidate buffers (kk plus one step of rows: a step adds at
    most THREADS candidates a query, and a full buffer is cut back to kk)
    fit in shared memory; the slices are read from L2 when one query's do
    not fit. A kk whose buffers do not fit, or shrink the query tile to 4
    or fewer below what the slices alone allow, takes the selection path
    (``select`` forces either path). The chunk count gives about two
    blocks per SM."""
    if not 0 < kk <= n:
        raise ValueError(f"k={kk} outside 1..{n} (the corpus size)")
    cap = merge_cap = _pow2(kk + THREADS)
    widest = max(1, min(MAX_BQ, _pow2(b)))

    def pick(cap):
        for staged in (True, False):
            bq = widest
            while bq > 1 and topk_smem(bq, staged, cap, m, ksub) > \
                    TOPK_SMEM_LIMIT:
                bq //= 2
            if topk_smem(bq, staged, cap, m, ksub) <= TOPK_SMEM_LIMIT:
                return bq, staged
        return None

    fit, bare = pick(cap), pick(0)
    fits = fit is not None and 8 * merge_cap <= SMEM_LIMIT
    if select is None:
        # the buffers shrinking the tile to 4 or fewer: measured on the H100
        # at kk=2048, b=64, the buffered path's trims took 9.8 ms of a
        # 10.4 ms call, the selection path 3.7 ms in all
        select = not fits or fit[0] <= 4 < bare[0]
    elif not select and not fits:
        raise ValueError(f"kk={kk}: the buffers do not fit")
    if select:
        cap = merge_cap = 0
        fit = bare
    bq, staged = fit
    qtiles = math.ceil(b / bq)
    nchunks = max(1, min(math.ceil(n / THREADS),
                         math.ceil(2 * num_sms / qtiles)))
    chunk_rows = math.ceil(math.ceil(n / nchunks) / THREADS) * THREADS
    nchunks = math.ceil(n / chunk_rows)
    return TopkPlan(bq=bq, staged=staged, cap=cap, nchunks=nchunks,
                    chunk_rows=chunk_rows, merge_cap=merge_cap,
                    select=select)


def pq_score_topk(codes: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, offsets_host: Sequence[int],
                  luts: torch.Tensor, k: int, *,
                  _select: Optional[bool] = None,
                  _sel_stats: Optional[torch.Tensor] = None):
    """The fused ADC scan + first-occurrence top-k over the grouped layout:
    codes (n, M) uint8 or int32 and ids (n,) int32 (original row ids) in
    coarse-grouped order, offsets (ncoarse + 1,) int32 the groups' offsets
    on the card and ``offsets_host`` the same on the host, luts (b, M,
    ncoarse * ksub) float32. Returns (vals (b, k) f32 = -d2, ids (b, k)
    int32 original row ids), ranked by the order-preserving bits of -d2,
    then the smaller id. ``_select`` forces the selection path (True) or
    the buffered one (False), for holding one against the other;
    ``_sel_stats`` (``_build.select_stats``) takes the select's profile."""
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
    _build.require(codes, "codes", (n, m), dev, codes.dtype)
    _build.require(ids, "ids", (n,), dev, torch.int32)
    _build.require(offsets, "offsets", (ncoarse + 1,), dev, torch.int32)
    _build.require(luts, "luts", (b, m, width), dev)
    p = topk_plan(n, b, k, m, ksub,
                  torch.cuda.get_device_properties(dev).multi_processor_count,
                  _select)
    part = sel = sel_args = sel_scratch = None
    if p.select:
        sel = torch.empty((b, n), dtype=torch.float32, device=dev)
        sp = _build.select_plan(b, n, k, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        sel_args, sel_scratch = _build.select_args(sp, b, k, dev, _sel_stats)
    else:
        part = torch.empty((b, p.nchunks, k), dtype=torch.int64, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    ptr = _build.ptr
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_pq_score_topk(
            codes.data_ptr(), CODE_BYTES[codes.dtype], ids.data_ptr(),
            offsets.data_ptr(), ncoarse, luts.data_ptr(), n, b, m, ksub,
            p.bq, int(p.staged), k, p.cap, p.nchunks, p.chunk_rows,
            p.merge_cap, ptr(part), ptr(sel), _build.addr(sel_args),
            vals.data_ptr(), out_ids.data_ptr(), _build.stream(dev))
    name = NAME_TOPK + ("_select" if p.select else "")
    _build.check(code, name)
    _build.count(name)
    if p.select:
        _build.count(_build.SELECT_NAME)
    return vals, out_ids
