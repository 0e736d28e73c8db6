"""CUDA kernels B2/B3: fused L2 scan + first-occurrence top-k (+ rows).

One CUDA source (``csrc/fused_score_topk.cu``) serves both output contracts:

* ``score_topk`` (B2) replaces the plain, int8-scaled, masked and
  masked+scaled variants of the Pallas kernel
  ``repro/kernels/fused_score_topk.py::score_topk``;
* ``score_topk_rows`` (B3) replaces ``score_topk_rows``: the same (vals,
  ids) bit for bit, plus the winners' corpus rows (dequantized to fp32)
  and payload rows.

The corpus is stored as fp32, bf16 or int8 codes (the storage ladder); an
optional per-row ``scales`` (n,) multiplies each dot product's output, as
the int8 rung needs. Each stored dtype has its own launch counter
(``score_topk``, ``score_topk_bf16``, ``score_topk_int8``, and the same for
the rows variant); a CUDA corpus of any other dtype raises. An optional
``mask`` (n,) float 0/1 (the filter algebra's mask plan) restricts the
scan to the rows above 0.5, the only ones it reads; the masked launches
count apart
(``score_topk_masked``, ``score_topk_masked_bf16``,
``score_topk_masked_int8``), and slots left without an eligible row read
(-inf, id 0).

Pass 1 splits the corpus into chunks scanned by parallel blocks of one
warpgroup each: the dot products on the tensor cores (3xTF32 for fp32
rows, bf16 products against a three-term bf16 split of the queries for
bf16 and int8 rows), a query tile of up to 64 queries resident in shared
memory so a batch of 64 reads the corpus once, and per-query candidate
buffers cut back to kk by the warp that owns the query (see the source's
header); pass 2 merges the chunks per query. The masked variants scan the
eligible rows only, gathered by id (``eligible_ids`` builds them on the
card without a host synchronisation). A kk whose candidate buffers do not
fit in shared memory, or fit only at a query tile below 16 for a larger
batch, takes the selection path (every score to an (nq, n) scratch, then a
radix select per query), with the same (vals, ids) bits and its own
counters (``_select`` before the dtype suffix: ``score_topk_select``,
``score_topk_rows_select_int8``, ``score_topk_masked_select``, ...).
``plan`` sizes both passes from the shapes, the stored dtype and the
card's SM count; it is plain Python so the CPU tests reach it. The plain
versions are ``ref.ref_score_topk`` and ``ref.ref_score_topk_rows``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "score_topk"
NAME_ROWS = "score_topk_rows"

ROWS = 128            # corpus rows a tile, 64 a warpgroup (kRows)
MIN_STAGES, MAX_STAGES = 3, 4   # slots of the staging ring (kMaxStages)
STAGE_BYTES = ROWS * 128        # a slot: 128 rows of 128 bytes
SPILL = ROWS          # spill slots per (block, query) (kSpill)
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (bytes)
QUERY_TILES = (64, 32, 16, 8)   # the MMA's N
MIN_SLACK = 64        # slots past kk the buffers need (> kMargin, 16)
MAX_SLACK = 1024      # and the most it takes
# The buffered path first scores up to SAMPLE evenly spaced rows (at most an
# eighth of them) and starts each query's threshold at their kk-th best: a
# chunk then admits about kk * n / (SAMPLE * nchunks) candidates a query in
# place of about kk * (1 + ln(rows a chunk / kk)).
SAMPLE = 16384
# pass 1's optional profile (kStat* in the source): block thread 0's clock
# cycles by phase, summed over blocks, then the cuts and admitted candidates
STAT_NAMES = ("wait", "cut", "issue", "load", "mma", "epilogue", "cuts",
              "admitted")
STATS = len(STAT_NAMES)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    bq: int           # queries per pass-1 block: 64, 32, 16 or 8
    cap: int          # pass-1 candidate slots per query (0: selection)
    stages: int       # slots of pass 1's staging ring
    qstream: bool     # the query operand staged a column chunk at a time
    nchunks: int      # corpus chunks, one pass-1 block column each
    chunk_rows: int   # corpus rows per chunk (multiple of ROWS)
    select: bool      # the selection path: no buffers (cap 0)
    sample: int       # rows of the threshold's sample pass (0: none)


def elem_bytes(et: int) -> int:
    return (4, 2, 1)[et]


def stage_cols(et: int = 0) -> int:
    """Columns a staging slot holds (the source's ``stage_cols``): 128 bytes
    of a row (32 fp32, 64 bf16, 128 int8 values), past d zero-filled."""
    return 128 // elem_bytes(et)


def scan_smem(bq: int, cap: int, d: int, et: int = 0,
              stages: int = MIN_STAGES, qstream: bool = False) -> int:
    """Pass-1 dynamic shared memory in bytes (mirrors ``scan_smem`` in the
    source): the staging ring (128 bytes a row), the query operand over
    every column chunk, or two chunks with ``qstream`` (two tf32 terms for
    fp32 rows, three bf16 terms otherwise), ``cap`` candidate slots a query
    (8 bytes each), the warps' digit histograms, the per-query state and
    the ring's barriers."""
    kc = stage_cols(et)
    terms, op = (2, 4) if et == 0 else (3, 2)
    qop = terms * bq * (2 if qstream else -(-d // kc)) * kc * op
    ring = stages * STAGE_BYTES
    return (qop + ring + 8 * bq * cap + 4 * 256 * 8 + 16 * bq + 16
            + 16 * MAX_STAGES)


def merge_smem(kk: int) -> int:
    """Pass-2 dynamic shared memory in bytes (the source's stream_smem):
    eight warps' candidate buffers of kk + max(kk, 2048) slots where that
    fits in 200 KiB, else kk + max(kk, 512), and their digit histograms."""
    extra = 2048 if 64 * (kk + max(kk, 2048)) <= 200 * 1024 else 512
    return 8 * (8 * (kk + max(kk, extra)) + 4 * 256)


def stages_for(bq: int, cap: int, d: int, et: int = 0,
               qstream: bool = False) -> int:
    """Ring slots that fit beside the rest (at most MAX_STAGES; below
    MIN_STAGES the shapes do not fit)."""
    free = SMEM_LIMIT - scan_smem(bq, cap, d, et, 0, qstream)
    return min(MAX_STAGES, max(0, free // STAGE_BYTES))


def buffered_cap(bq: int, kk: int, d: int, et: int = 0,
                 qstream: bool = False):
    """(cap, stages) at a ``bq``-query tile: the ring as deep as shared
    memory allows beside kk + MIN_SLACK candidate slots a query, then the
    slots what is left leaves (at most kk + MAX_SLACK, a multiple of 32);
    (0, 0) where even MIN_STAGES do not fit (the buffers do not fit)."""
    least = -(-(kk + MIN_SLACK) // 32) * 32
    stages = stages_for(bq, least, d, et, qstream)
    if stages < MIN_STAGES:
        return 0, 0
    free = SMEM_LIMIT - scan_smem(bq, 0, d, et, stages, qstream)
    return min(free // (8 * bq), kk + MAX_SLACK) // 32 * 32, stages


def plan(n: int, nq: int, kk: int, d: int, num_sms: int,
         select: Optional[bool] = None, et: int = 0) -> ScanPlan:
    """Choose the launch shape for ``nq`` queries against ``n`` rows of
    width ``d`` stored as element type ``et`` (0 fp32, 1 bf16, 2 int8), for
    any 1 <= kk <= n. The query tile is the smallest of QUERY_TILES that
    holds the batch (64 at most), shrunk only where the candidate buffers
    (kk + MIN_SLACK slots a query or more) do not fit beside the query
    operand and the ring. The query operand is resident for every column
    chunk, or staged a chunk at a time (``qstream``) where that lets a
    wider tile fit (wide rows). Where the buffers fit only at a tile below
    16 while the batch holds more, or not at all, the scan takes the
    selection path (``select`` forces either path). One block per SM: the
    chunk count fills the card's SMs."""
    if not 0 < kk <= n:
        raise ValueError(f"k={kk} outside 1..{n} (the corpus size)")
    widest = next((b for b in reversed(QUERY_TILES) if b >= nq), 64)
    tiles = [b for b in QUERY_TILES if b <= widest]

    def widest_fit(qstream):   # (bq, cap, stages) of the buffered path
        fit = [(b, *buffered_cap(b, kk, d, et, qstream)) for b in tiles]
        return next((f for f in fit if f[1]), None)

    def widest_room(qstream):  # the selection path's bq
        return next((b for b in tiles if stages_for(b, 0, d, et, qstream)
                     >= MIN_STAGES), 0)

    resident, streamed = widest_fit(False), widest_fit(True)
    qstream = streamed is not None and (resident is None
                                        or streamed[0] > resident[0])
    fit = streamed if qstream else resident
    fits = fit is not None and merge_smem(kk) <= SMEM_LIMIT
    bq, cap, stages = fit if fit else (widest, 0, 0)
    if select is None:
        select = not fits or bq < min(16, widest)
    elif not select and not fits:
        raise ValueError(f"kk={kk} at d={d}: the buffers do not fit")
    if select:
        qstream = widest_room(True) > widest_room(False)
        bq, cap = widest_room(qstream), 0
        stages = stages_for(bq, 0, d, et, qstream)
    qtiles = math.ceil(nq / bq)
    nchunks = max(1, min(math.ceil(n / ROWS), math.ceil(num_sms / qtiles)))
    chunk_rows = math.ceil(math.ceil(n / nchunks) / ROWS) * ROWS
    nchunks = math.ceil(n / chunk_rows)
    sample = SAMPLE if not select and n // 8 >= kk else 0
    return ScanPlan(bq=bq, cap=cap, stages=stages, qstream=qstream,
                    nchunks=nchunks, chunk_rows=chunk_rows, select=select,
                    sample=sample)


def eligible_ids(mask: torch.Tensor):
    """The masked scan's rows: (ids (n + 1,) int32 whose first ``count``
    entries are the rows with mask > 0.5 in ascending order, count (1,)
    int32), built on the mask's device by a prefix sum and a scatter, with
    no host synchronisation (the kernel reads the count). Slot n takes the
    ineligible rows' writes and is never read."""
    n = mask.shape[0]
    keep = mask > 0.5
    pos = torch.cumsum(keep, 0, dtype=torch.int32)
    slot = torch.where(keep, pos - 1, n).long()
    ids = torch.empty(n + 1, dtype=torch.int32, device=mask.device)
    ids.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                        device=mask.device))
    return ids, pos[-1:]


def _launch(corpus, sq_norms, queries, k, payload_v=None, payload_f=None,
            scales=None, mask=None, select=None, stats=None, b5=None,
            sel_stats=None):
    """Check the operands, allocate outputs and scratch, launch. Returns
    (error code, counter name infix and suffix, vals, ids, rows). ``stats``,
    an (STATS,) int64 tensor or None, takes the scan's optional profile;
    ``sel_stats`` (``_build.select_stats``) the select's. ``b5`` (the IVF
    masked scan, ``ivf_score``'s ``mask=``): (elig, n_elig, the lists'
    member bits (nlist, words), rows a list) in place of ``mask``, over the
    grouped slab's flattened rows."""
    if corpus.dim() != 2 or queries.dim() != 2:
        raise ValueError("corpus and queries must be 2-D")
    n, d = corpus.shape
    nq = queries.shape[0]
    dev = corpus.device
    if n >= 2 ** 31:
        raise ValueError("corpus ids must fit in int32")
    et, suffix = _build.element_type(corpus, "corpus")
    _build.require(corpus, "corpus", (n, d), dev, corpus.dtype)
    _build.require(sq_norms, "sq_norms", (n,), dev)
    if scales is not None:
        _build.require(scales, "scales", (n,), dev)
    if mask is not None:
        _build.require(mask, "mask", (n,), dev)
    _build.require(queries, "queries", (nq, d), dev)
    p = plan(n, nq, k, d,
             torch.cuda.get_device_properties(dev).multi_processor_count,
             select, et)
    elig = n_elig = mbits = None
    mlist = 0
    if mask is not None:
        elig, n_elig = eligible_ids(mask)
    if b5 is not None:
        elig, n_elig, mbits, mlist = b5
    part_s = part_i = part_n = spill_s = spill_i = None
    sel = sel_args = sel_scratch = None
    sample_sel = thr0_s = thr0_i = None
    if p.select:
        sel = torch.empty((nq, n), dtype=torch.float32, device=dev)
        sp = _build.select_plan(nq, n, k, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        sel_args, sel_scratch = _build.select_args(sp, nq, k, dev, sel_stats)
    else:
        part_s = torch.empty((nq, p.nchunks * k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((nq, p.nchunks * k), dtype=torch.int32,
                             device=dev)
        part_n = torch.zeros(nq, dtype=torch.int32, device=dev)
        slots = math.ceil(nq / p.bq) * p.bq * p.nchunks * SPILL
        spill_s = torch.empty(slots, dtype=torch.float32, device=dev)
        spill_i = torch.empty(slots, dtype=torch.int32, device=dev)
        if p.sample:
            sample_sel = torch.empty((nq, p.sample), dtype=torch.float32,
                                     device=dev)
            thr0_s = torch.empty(nq, dtype=torch.float32, device=dev)
            thr0_i = torch.empty(nq, dtype=torch.int32, device=dev)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    rows = (None, None, None)
    dv = m = 0
    if payload_v is not None:
        dv, m = payload_v.shape[1], payload_f.shape[1]
        _build.require(payload_v, "payload_v", (n, dv), dev)
        _build.require(payload_f, "payload_f", (n, m), dev)
        rows = tuple(torch.empty((nq, k, w), dtype=torch.float32, device=dev)
                     for w in (d, dv, m))
    ptr = _build.ptr
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_score_topk(
            corpus.data_ptr(), et, sq_norms.data_ptr(), ptr(scales),
            ptr(elig), ptr(n_elig), mlist, ptr(mbits),
            0 if mbits is None else mbits.shape[1], queries.data_ptr(), n,
            nq, d, k, p.bq,
            p.cap, p.stages, int(p.qstream), p.nchunks, p.chunk_rows,
            ptr(part_s),
            ptr(part_i), ptr(part_n), ptr(spill_s), ptr(spill_i), p.sample,
            ptr(sample_sel), ptr(thr0_s), ptr(thr0_i), ptr(sel),
            _build.addr(sel_args), vals.data_ptr(), ids.data_ptr(),
            ptr(payload_v), ptr(payload_f), dv, m, *map(ptr, rows),
            ptr(stats), _build.stream(dev))
    tag = ("_select" if p.select else "") + suffix
    if p.select and not code:
        _build.count(_build.SELECT_NAME)
    return code, tag, vals, ids, rows


def score_topk(corpus: torch.Tensor, sq_norms: torch.Tensor,
               queries: torch.Tensor, k: int,
               scales: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None, *,
               _select: Optional[bool] = None,
               _stats: Optional[torch.Tensor] = None,
               _sel_stats: Optional[torch.Tensor] = None):
    """corpus (n, d) float32, bfloat16 or int8 codes, sq_norms (n,),
    queries (q, d), the optional per-row scales (n,) float32 and the
    optional row mask (n,) float32 0/1, on one CUDA device. Returns (scores
    (q, k) f32, ids (q, k) int32): negative squared L2, descending, ties to
    the smaller id; with a mask, rows at <= 0.5 never enter and unfilled
    slots read (-inf, 0). ``_select`` forces the selection path (True) or
    the buffered one (False), for holding one against the other;
    ``_stats`` (an int64 tensor of STATS zeros on the card) takes pass 1's
    profile (``STAT_NAMES``), ``_sel_stats`` (``_build.select_stats``) the
    select's, for ``scripts/profile_topk.py``."""
    code, tag, vals, ids, _ = _launch(corpus, sq_norms, queries, k,
                                      scales=scales, mask=mask,
                                      select=_select, stats=_stats,
                                      sel_stats=_sel_stats)
    name = NAME + ("_masked" if mask is not None else "") + tag
    _build.check(code, name)
    _build.count(name)
    return vals, ids


def score_topk_rows(corpus: torch.Tensor, sq_norms: torch.Tensor,
                    payload_v: torch.Tensor, payload_f: torch.Tensor,
                    queries: torch.Tensor, k: int,
                    scales: Optional[torch.Tensor] = None, *,
                    _select: Optional[bool] = None):
    """Gather-free scan: ``score_topk``'s (scores, ids) plus the winners'
    corpus rows dequantized to fp32 (q, k, d), payload_v rows (q, k, dv)
    and payload_f rows (q, k, m); payloads are fp32, row-aligned with the
    corpus."""
    code, tag, vals, ids, rows = _launch(corpus, sq_norms, queries, k,
                                         payload_v, payload_f, scales,
                                         select=_select)
    _build.check(code, NAME_ROWS + tag)
    _build.count(NAME_ROWS + tag)
    return (vals, ids, *rows)
