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
``mask`` (n,) float 0/1 (the filter algebra's mask plan) makes rows at
<= 0.5 score -inf inside the scan; the masked launches count apart
(``score_topk_masked``, ``score_topk_masked_bf16``,
``score_topk_masked_int8``), and slots left without an eligible row read
(-inf, id 0).

Pass 1 splits the corpus into chunks scanned by parallel blocks, each
keeping its chunk's top-kk per query; pass 2 merges the chunks per query
(see the source's header). Rows of any width are staged in column chunks
of ``_build.DC``. A kk whose candidate buffers do not fit in shared memory,
or fit only at a 4-query tile, takes the selection path (every score to an
(nq, n) scratch, then a radix select per query), with the same (vals, ids)
bits and its own counters (``_select`` before the dtype suffix:
``score_topk_select``, ``score_topk_rows_select_int8``,
``score_topk_masked_select``, ...). ``plan`` sizes both passes from the
shapes and the card's SM count; it is plain Python so the CPU tests reach
it. The plain versions are ``ref.ref_score_topk`` and
``ref.ref_score_topk_rows``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import staged_cols

NAME = "score_topk"
NAME_ROWS = "score_topk_rows"

TILE = 128            # corpus rows staged per step (kTile in the source)
THREADS = 256         # threads per block (kThreads)
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (bytes)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    bq: int           # queries per pass-1 block: 16, 8 or 4
    cap: int          # pass-1 candidate buffer per query (power of two)
    nchunks: int      # corpus chunks, one pass-1 block column each
    chunk_rows: int   # corpus rows per chunk (multiple of TILE)
    merge_cap: int    # pass-2 candidate buffer (power of two)
    select: bool      # the selection path: no buffers (cap, merge_cap 0)


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def scan_smem(bq: int, cap: int, dc: int) -> int:
    """Pass-1 dynamic shared memory in bytes for ``dc`` staged columns
    (``staged_cols``; mirrors ``scan_smem`` in the source). The same at
    every stored dtype: bf16 and int8 tiles are cast up to fp32 as they are
    stored, with no raw copy in shared memory; the tile's norms, scales and
    mask flags take a row each."""
    ds = dc + 4
    return 4 * (bq * ds + TILE * ds + 3 * TILE + 4 * bq + 4 + 2 * bq * cap)


def merge_smem(merge_cap: int) -> int:
    """Pass-2 dynamic shared memory in bytes (the source's)."""
    return 4 * (2 * merge_cap + 4)


def plan(n: int, nq: int, kk: int, d: int, num_sms: int,
         select: Optional[bool] = None) -> ScanPlan:
    """Choose the launch shape for ``nq`` queries against ``n`` rows of
    width ``d``, for any 1 <= kk <= n. Each buffer holds kk plus two tiles,
    so a trim is needed at most every few tiles; the query tile shrinks for
    large kk so the buffers fit in shared memory. Where they fit only at a
    tile of 4 queries while the batch holds more, or not at all, the scan
    takes the selection path (``select`` forces either path): at kk=2056 a
    4-query tile scans the corpus 16 times for 64 queries, and measured
    2.5x slower than the selection path on the H100. The chunk count gives
    about two blocks per SM."""
    if not 0 < kk <= n:
        raise ValueError(f"k={kk} outside 1..{n} (the corpus size)")
    dc = staged_cols(d)
    cap, merge_cap = _pow2(kk + 2 * TILE), _pow2(kk + 2 * THREADS)
    bq = widest = 16 if nq > 8 else 8 if nq > 4 else 4
    while bq > 4 and scan_smem(bq, cap, dc) > SMEM_LIMIT:
        bq //= 2
    fits = (scan_smem(bq, cap, dc) <= SMEM_LIMIT
            and merge_smem(merge_cap) <= SMEM_LIMIT)
    if select is None:
        select = not fits or bq == 4 < widest
    elif not select and not fits:
        raise ValueError(f"kk={kk} at d={d}: the buffers do not fit")
    if select:
        bq, cap, merge_cap = widest, 0, 0
    qtiles = math.ceil(nq / bq)
    nchunks = max(1, min(math.ceil(n / TILE), math.ceil(2 * num_sms / qtiles)))
    chunk_rows = math.ceil(math.ceil(n / nchunks) / TILE) * TILE
    nchunks = math.ceil(n / chunk_rows)
    return ScanPlan(bq=bq, cap=cap, nchunks=nchunks, chunk_rows=chunk_rows,
                    merge_cap=merge_cap, select=select)


def _launch(corpus, sq_norms, queries, k, payload_v=None, payload_f=None,
            scales=None, mask=None, select=None):
    """Check the operands, allocate outputs and scratch, launch. Returns
    (error code, counter name infix and suffix, vals, ids, rows)."""
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
             select)
    part_s = part_i = sel = sort_w = sort_pos = None
    sort_len = 0
    if p.select:
        sel = torch.empty((nq, n), dtype=torch.float32, device=dev)
        sort_len, sort_w, sort_pos = _build.select_scratch(nq, k, dev)
    else:
        part_s = torch.empty((nq, p.nchunks, k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((nq, p.nchunks, k), dtype=torch.int32,
                             device=dev)
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
            ptr(mask), queries.data_ptr(), n, nq, d, k, p.bq, p.cap,
            p.nchunks, p.chunk_rows, p.merge_cap, ptr(part_s), ptr(part_i),
            ptr(sel), sort_len, ptr(sort_w), ptr(sort_pos), vals.data_ptr(),
            ids.data_ptr(), ptr(payload_v), ptr(payload_f), dv, m,
            *map(ptr, rows), _build.stream(dev))
    tag = ("_select" if p.select else "") + suffix
    return code, tag, vals, ids, rows


def score_topk(corpus: torch.Tensor, sq_norms: torch.Tensor,
               queries: torch.Tensor, k: int,
               scales: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None, *,
               _select: Optional[bool] = None):
    """corpus (n, d) float32, bfloat16 or int8 codes, sq_norms (n,),
    queries (q, d), the optional per-row scales (n,) float32 and the
    optional row mask (n,) float32 0/1, on one CUDA device. Returns (scores
    (q, k) f32, ids (q, k) int32): negative squared L2, descending, ties to
    the smaller id; with a mask, rows at <= 0.5 never enter and unfilled
    slots read (-inf, 0). ``_select`` forces the selection path (True) or
    the buffered one (False), for holding one against the other."""
    code, tag, vals, ids, _ = _launch(corpus, sq_norms, queries, k,
                                      scales=scales, mask=mask,
                                      select=_select)
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
