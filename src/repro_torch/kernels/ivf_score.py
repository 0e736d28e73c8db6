"""CUDA kernels B5/B6/B7: IVF list scans + first-occurrence top-k.

One CUDA source (``csrc/ivf_score.cu``) serves the three output contracts
of ``repro/kernels/ivf_score.py``, for fp32 storage:

* ``ivf_score_topk_dedup`` (B5): the probe-major scan of the batch's unique
  probed lists (``uniq`` (s,), ``member`` (s, b));
* ``ivf_score_topk_dedup_rows`` (B6): B5's (vals, ids) bit for bit, plus the
  winners' grouped payload rows, zero rows for dead slots;
* ``ivf_score_topk_batch`` (B7) and ``ivf_score_topk``, its batch-1 call:
  the query-major scan over a (b, nprobe) probe grid.

Scores are ``2 <x, q> - ||x||^2`` (the caller adds ``-||q||^2`` back) and
ids are flat slot ids ``list * max_list + slot``. Ties go to the smaller
flat id for B5/B6 and to the earlier (probe position, slot) for B7, as the
TPU kernels' running top-k orders them; dead slots read (-inf, id 0).

Pass 1 is a persistent kernel whose blocks take work items, one list and
up to four of its member queries each, and scan the list for those queries
only; pass 2 merges each query's partials (see the source's header).
``plan`` sizes the buffers; it is plain Python so the CPU tests reach it.
The plain versions are ``ref.ref_ivf_score_topk_*`` (``ops.ivf_score_topk``
is the batch scan at batch 1 on either device, so it needs none of its
own).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

NAME_DEDUP = "ivf_score_topk_dedup"
NAME_ROWS = "ivf_score_topk_dedup_rows"
NAME_BATCH = "ivf_score_topk_batch"

TILE = 128            # list rows staged per step (kTile in the source)
THREADS = 256         # threads per block (kThreads)
BQ = 4                # member queries per pass-1 block (kBQ)
MAX_K = 2048          # largest k the kernels take
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (bytes)


@dataclasses.dataclass(frozen=True)
class ListPlan:
    cap: int          # pass-1 candidate buffer per member query (power of 2)
    merge_cap: int    # pass-2 candidate buffer (power of two)


def _pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


def scan_smem(cap: int, d: int) -> int:
    """Pass-1 dynamic shared memory in bytes (mirrors ``list_scan_smem`` in
    the source)."""
    ds = ((d + 3) & ~3) + 4
    return 4 * (BQ * ds + TILE * ds + 2 * TILE + 4 * BQ + 8 + 2 * BQ * cap)


def plan(k: int, d: int) -> ListPlan:
    """Buffer sizes for top-``k`` over rows of width ``d``: each buffer
    holds k plus two tiles, so a trim is needed at most every few tiles.
    Raises for a k beyond the kernels' buffers or a width that does not fit
    in shared memory."""
    if not 0 < k <= MAX_K:
        raise ValueError(f"k={k} outside the kernels' range 1..{MAX_K}")
    cap = _pow2(k + 2 * TILE)
    if scan_smem(cap, d) > SMEM_LIMIT:
        raise ValueError(f"d={d} with k={k} does not fit in shared memory")
    return ListPlan(cap=cap, merge_cap=_pow2(k + 2 * THREADS))


def _launch(grouped, grouped_sq, valid, src_list, member, queries, k,
            payload_v=None, payload_f=None):
    """Check the operands, allocate outputs and scratch, launch. ``member``
    None selects the batch scan (``src_list`` is the (b, nprobe) probe
    matrix), otherwise the dedup scan (``src_list`` is ``uniq``)."""
    if grouped.dim() != 3 or queries.dim() != 2:
        raise ValueError("grouped must be 3-D and queries 2-D")
    nlist, max_list, d = grouped.shape
    b = queries.shape[0]
    dev = grouped.device
    if nlist * max_list >= 2 ** 31:
        raise ValueError("flat slot ids (nlist * max_list) must fit in int32")
    _build.require(grouped, "grouped", (nlist, max_list, d), dev)
    _build.require(grouped_sq, "grouped_sq", (nlist, max_list), dev)
    _build.require(valid, "valid", (nlist, max_list), dev)
    _build.require(queries, "queries", (b, d), dev)
    if member is None:
        if src_list.dim() != 2 or src_list.shape[0] != b:
            raise ValueError(f"probes must be ({b}, nprobe), got "
                             f"{tuple(src_list.shape)}")
        nprobe = src_list.shape[1]
        if nprobe * max_list >= 2 ** 31:
            raise ValueError("nprobe * max_list must fit in int32")
        _build.require(src_list, "probes", (b, nprobe), dev, torch.int32)
        nsrc, nparts = b * nprobe, b * nprobe
    else:
        nprobe = 1
        nsrc = src_list.shape[0]
        _build.require(src_list, "uniq", (nsrc,), dev, torch.int32)
        _build.require(member, "member", (nsrc, b), dev)
        nparts = nsrc * b
    p = plan(k, d)
    part_s = torch.empty((nparts, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((nparts, k), dtype=torch.int32, device=dev)
    work = torch.empty((2 * nsrc + 2,), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    rows = (None, None)
    dv = m = 0
    if payload_v is not None:
        dv, m = payload_v.shape[-1], payload_f.shape[-1]
        _build.require(payload_v, "payload_v", (nlist, max_list, dv), dev)
        _build.require(payload_f, "payload_f", (nlist, max_list, m), dev)
        rows = tuple(torch.empty((b, k, w), dtype=torch.float32, device=dev)
                     for w in (dv, m))
    ptr = _build.ptr
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_ivf_score_topk(
            grouped.data_ptr(), grouped_sq.data_ptr(), valid.data_ptr(),
            src_list.data_ptr(), nsrc, ptr(member), queries.data_ptr(), b,
            nprobe, max_list, d, k, p.cap, p.merge_cap, part_s.data_ptr(),
            part_i.data_ptr(), work.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), ptr(payload_v), ptr(payload_f), dv, m,
            *map(ptr, rows), _build.stream(dev))
    return code, vals, ids, rows


def ivf_score_topk_dedup(grouped: torch.Tensor, grouped_sq: torch.Tensor,
                         valid: torch.Tensor, uniq: torch.Tensor,
                         member: torch.Tensor, queries: torch.Tensor, k: int):
    """grouped (nlist, max_list, d), grouped_sq / valid (nlist, max_list)
    float32, uniq (s,) int32, member (s, b) float 0/1, queries (b, d), on
    one CUDA device. Returns (vals (b, k) f32, flat ids (b, k) int32)."""
    code, vals, ids, _ = _launch(grouped, grouped_sq, valid, uniq, member,
                                 queries, k)
    _build.check(code, NAME_DEDUP)
    _build.count(NAME_DEDUP)
    return vals, ids


def ivf_score_topk_dedup_rows(grouped: torch.Tensor, grouped_sq: torch.Tensor,
                              valid: torch.Tensor, uniq: torch.Tensor,
                              member: torch.Tensor, queries: torch.Tensor,
                              payload_v: torch.Tensor,
                              payload_f: torch.Tensor, k: int):
    """``ivf_score_topk_dedup``'s (vals, ids) plus the winners' rows of the
    grouped payloads payload_v (nlist, max_list, dv) and payload_f (nlist,
    max_list, m): (b, k, dv) and (b, k, m), zero rows for dead slots."""
    code, vals, ids, rows = _launch(grouped, grouped_sq, valid, uniq, member,
                                    queries, k, payload_v, payload_f)
    _build.check(code, NAME_ROWS)
    _build.count(NAME_ROWS)
    return (vals, ids, *rows)


def ivf_score_topk_batch(grouped: torch.Tensor, grouped_sq: torch.Tensor,
                         valid: torch.Tensor, probes: torch.Tensor,
                         queries: torch.Tensor, k: int):
    """Query-major probed scan: probes (b, nprobe) int32 list ids, queries
    (b, d). Returns (vals (b, k) f32, flat ids (b, k) int32); ties go to the
    earlier probe position, then the earlier slot."""
    code, vals, ids, _ = _launch(grouped, grouped_sq, valid, probes, None,
                                 queries, k)
    _build.check(code, NAME_BATCH)
    _build.count(NAME_BATCH)
    return vals, ids
