"""CUDA kernels B5/B6/B7: IVF list scans + first-occurrence top-k.

One CUDA source (``csrc/ivf_score.cu``) serves the three output contracts
of ``repro/kernels/ivf_score.py``, at every storage dtype:

* ``ivf_score_topk_dedup`` (B5): the probe-major scan of the batch's unique
  probed lists (``uniq`` (s,), ``member`` (s, b)); its ``mask=`` (the
  filter algebra's mask and routed plans) runs the flat tensor-core scan
  of ``fused_score_topk`` over the eligible slots instead (below);
* ``ivf_score_topk_dedup_rows`` (B6): B5's (vals, ids) bit for bit, plus the
  winners' grouped payload rows, zero rows for dead slots;
* ``ivf_score_topk_batch`` (B7) and ``ivf_score_topk``, its batch-1 call:
  the query-major scan over a (b, nprobe) probe grid.

The grouped slab holds fp32, bf16 or int8 codes; the optional per-slot
``scales`` (nlist, max_list) (int8's ``grouped_scales``) multiplies each
dot product's output. Each stored dtype has its own launch counter (the
names below, then ``_bf16`` and ``_int8``); a CUDA slab of any other dtype
raises.

Scores are ``(2 <x, q>) scale - ||x||^2`` (the caller adds ``-||q||^2``
back) and ids are flat slot ids ``list * max_list + slot``. Ties go to the smaller
flat id for B5/B6 and to the earlier (probe position, slot) for B7, as the
TPU kernels' running top-k orders them; dead slots read (-inf, id 0).

``mask=`` builds its operands on the card (``masked_slots``: the eligible
slots, valid * mask > 0.5 in a list with a member query, as ascending flat
ids, and each list's member bits, with no host synchronisation) and runs
the flat scan over those rows of the slab viewed as (nlist * max_list, d),
with B5's epilogue (no -||q||^2, the member test per query); its selection
path is the flat scan's. The unmasked scans keep the list scans below.

Pass 1 is a persistent kernel whose blocks take work items, one source
each (a unique list with all its member queries, or one probe), and scan
the list once per ``plan().q`` of its member queries: a producer warp
keeps a ring of stages in flight (a tile of ``TILE_ROWS`` rows x one
128-byte column chunk, in the stored dtype, by the copy engine), the
consumer threads own a row each and score only the pass's member queries,
and the warp that owns a query cuts its candidate buffer; pass 2 merges
each query's partial lists (see the source's header). A k whose buffers do
not fit in shared memory takes the selection path (each member query's
scores of each list to a scratch, then a radix select per query), with the
same (vals, ids) bits and its own counters (``_select`` before the dtype
suffix: ``ivf_score_topk_dedup_select``,
``ivf_score_topk_dedup_rows_select_int8``, ...). ``plan`` sizes the ring and
the buffers; it is plain Python so the CPU tests reach it.
The plain versions are ``ref.ref_ivf_score_topk_*`` (``ops.ivf_score_topk``
is the batch scan at batch 1 on either device, so it needs none of its
own).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_score_topk as _scan

NAME_DEDUP = "ivf_score_topk_dedup"
NAME_ROWS = "ivf_score_topk_dedup_rows"
NAME_BATCH = "ivf_score_topk_batch"

TILE_ROWS = 256      # rows a tile, one a consumer thread (kTileRows)
BOX_ROWS = 32        # rows a copy-engine box, one a consumer warp (kBoxRows)
Q_MAX = 8            # member queries a pass, a register each (kQMax)
MIN_STAGES, MAX_STAGES = 3, 6   # the ring's stages (kMaxStages)
META_BYTES = 160     # a stage's metadata (sizeof(StageMeta))
MERGE_THREADS = 256  # a pass-2 block (kMergeThreads)
# pass 1's optional profile (kLs* in the source), summed over blocks:
# consumer thread 0's cycles waiting for stages, in dot products, in the
# tiles' epilogues, at tile starts (barrier and cuts) and at pass ends; the
# producer's cycles waiting for free stages and resolving items; the cuts,
# admitted candidates, tiles and passes
STAT_NAMES = ("wait", "compute", "epilogue", "cut", "end", "producer_wait",
              "producer_item", "cuts", "admitted", "tiles", "passes")
STATS = len(STAT_NAMES)
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (bytes)
MERGE_LIMIT = SMEM_LIMIT - 1024   # beside pass 2's 1 KB of static memory


@dataclasses.dataclass(frozen=True)
class ListPlan:
    q: int            # member queries a pass (1..Q_MAX)
    cap: int          # candidates a buffer (0 on the selection path)
    stages: int       # stages of pass 1's ring
    select: bool      # the selection path
    smem: int         # pass 1's dynamic shared memory (bytes)


def stage_bytes(elem: int) -> int:
    """A stage of the ring, for rows of ``elem``-byte values: the tile's
    rows (TILE_ROWS x 128 bytes: one column chunk of 128 / elem columns,
    whatever d), the member queries' columns of the chunk (fp32), the
    rows' norms and scales, the metadata. Rows of any width take more
    stages, not larger ones."""
    return (TILE_ROWS * 128 + Q_MAX * (128 // elem) * 4 + 2 * TILE_ROWS * 4
            + META_BYTES)


def scan_smem(elem: int, stages: int, q: int, cap: int) -> int:
    """Pass 1's dynamic shared memory in bytes (``scan_layout`` in the
    source): the ring, q candidate buffers of cap (score, key) pairs, the
    eight warps' digit histograms, the per-query state, the barriers."""
    fixed = 8 * q * cap + 8 * 256 * 4 + 4 * (4 * Q_MAX + 2)
    return stages * (stage_bytes(elem) + 16) + ((fixed + 7) & ~7)


def merge_smem(k: int) -> int:
    """Pass 2's dynamic shared memory in bytes (``stream_smem`` of
    ``ring_topk.cuh``): eight warps' buffers of k plus a margin, and their
    digit histograms."""
    warps, rnd = MERGE_THREADS // 32, 32 * 8
    extra = 8 * rnd
    if warps * 8 * (k + max(k, extra)) > 200 * 1024:
        extra = 2 * rnd
    return warps * (8 * (k + max(k, extra)) + 4 * 256)


def plan(k: int, d: int, dtype: torch.dtype = torch.float32,
         select: Optional[bool] = None) -> ListPlan:
    """Pass 1's ring and buffers for top-``k`` over rows of width ``d``
    stored as ``dtype``, for any k >= 1 (slots past the live candidates
    read (-inf, 0)). A buffer holds k plus two tiles where that leaves
    MIN_STAGES stages (else k plus one), for as many member queries a pass
    as fit, Q_MAX down to 1: the kernel cuts a buffer past k plus half a
    tile (at most cap minus a tile), so a tile never overflows it. A k
    whose buffers or merge do not fit in shared memory takes the selection
    path (``select`` forces either path). The stage does not grow with d."""
    if k <= 0:
        raise ValueError(f"k={k} must be at least 1")
    if d <= 0:
        raise ValueError(f"d={d} must be at least 1")
    elem = torch.empty((), dtype=dtype).element_size()

    def stages_for(q, cap):
        room = SMEM_LIMIT - scan_smem(elem, 0, q, cap)
        return min(MAX_STAGES, room // (stage_bytes(elem) + 16))

    buffered = None
    if merge_smem(k) <= MERGE_LIMIT:
        for q in (Q_MAX, 4, 2, 1):
            for cap in (k + 2 * TILE_ROWS, k + TILE_ROWS):
                if stages_for(q, cap) >= MIN_STAGES:
                    buffered = ListPlan(q, cap, stages_for(q, cap), False,
                                        scan_smem(elem, stages_for(q, cap),
                                                  q, cap))
                    break
            if buffered is not None:
                break
    if select is None:
        select = buffered is None
    elif not select and buffered is None:
        raise ValueError(f"k={k}: the buffers do not fit")
    if not select:
        return buffered
    stages = stages_for(Q_MAX, 0)
    return ListPlan(Q_MAX, 0, stages, True,
                    scan_smem(elem, stages, Q_MAX, 0))


def list_passes(member: torch.Tensor, q: int = Q_MAX) -> torch.Tensor:
    """(s,) int32: the passes pass 1 makes over each source's list, one per
    q of its member queries (member (s, b) float 0/1); a source with none
    is not read."""
    return torch.div(torch.sum(member > 0.5, dim=1) + q - 1, q,
                     rounding_mode="floor").to(torch.int32)


def _launch(grouped, grouped_sq, valid, src_list, member, queries, k,
            payload_v=None, payload_f=None, scales=None, select=None,
            sel_stats=None, stats=None):
    """Check the operands, allocate outputs and scratch, launch. ``member``
    None selects the batch scan (``src_list`` is the (b, nprobe) probe
    matrix), otherwise the dedup scan (``src_list`` is ``uniq``). Returns
    (error code, counter name infix and suffix, vals, ids, rows).
    ``stats`` (STATS int64 zeros on the card) takes pass 1's profile,
    ``sel_stats`` (``_build.select_stats``) the select's."""
    if grouped.dim() != 3 or queries.dim() != 2:
        raise ValueError("grouped must be 3-D and queries 2-D")
    nlist, max_list, d = grouped.shape
    b = queries.shape[0]
    dev = grouped.device
    if nlist * max_list >= 2 ** 31:
        raise ValueError("flat slot ids (nlist * max_list) must fit in int32")
    et, suffix = _build.element_type(grouped, "grouped")
    _build.require(grouped, "grouped", (nlist, max_list, d), dev,
                   grouped.dtype)
    _build.require(grouped_sq, "grouped_sq", (nlist, max_list), dev)
    if scales is not None:
        _build.require(scales, "scales", (nlist, max_list), dev)
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
        nsrc, nseg = b * nprobe, nprobe
    else:
        nprobe = 1
        nsrc = nseg = src_list.shape[0]
        _build.require(src_list, "uniq", (nsrc,), dev, torch.int32)
        _build.require(member, "member", (nsrc, b), dev)
    p = plan(k, d, grouped.dtype, select)
    part_s = part_i = sel = sel_args = sel_scratch = None
    if p.select:
        sel = torch.empty((max(1, b * nseg * max_list),), dtype=torch.float32,
                          device=dev)
        sp = _build.select_plan(b, nseg * max_list, k,
                                torch.cuda.get_device_properties(
                                    dev).multi_processor_count,
                                seg_len=max_list)
        sel_args, sel_scratch = _build.select_args(sp, b, k, dev, sel_stats)
    else:   # each query's partial lists: at most k from each of its sources
        part_s = torch.empty((b, nseg * k), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, nseg * k), dtype=torch.int32, device=dev)
    # the item counter, each query's partial count and threshold word
    work = torch.empty((1 + 2 * b,), dtype=torch.int64, device=dev)
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
            grouped.data_ptr(), et, grouped_sq.data_ptr(), ptr(scales),
            valid.data_ptr(), src_list.data_ptr(), nsrc, ptr(member),
            queries.data_ptr(), b, nprobe, nlist, max_list, d, k, p.q, p.cap,
            p.stages, ptr(part_s), ptr(part_i), ptr(sel),
            _build.addr(sel_args), work.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), ptr(payload_v), ptr(payload_f), dv, m,
            *map(ptr, rows), ptr(stats), _build.stream(dev))
    if p.select and not code:
        _build.count(_build.SELECT_NAME)
    return code, ("_select" if p.select else "") + suffix, vals, ids, rows


SLOT_CHUNK = 4 * 256   # slots a block of the eligible-slot builder (kSlotChunk)


def masked_slots(valid: torch.Tensor, mask: torch.Tensor, uniq: torch.Tensor,
                 member: torch.Tensor):
    """B5 ``mask=``'s operands on the card (``fcvi_ivf_masked_slots``, no
    host synchronisation): (elig (nlist * max_list,) int32 whose first
    ``count`` entries are the flat ids of the eligible slots, valid * mask
    > 0.5 in a list with a member query, ascending; count (1,) int32; the
    lists' member bits (nlist, ceil(b / 64)) int64, query j at bit j % 64
    of word j // 64, OR-ed over a list's sources). The plain version is
    ``ref.ref_ivf_masked_slots``."""
    nlist, L = valid.shape
    nsrc, b = member.shape
    dev = valid.device
    words = -(-b // 64)
    chunks = -(-nlist * L // SLOT_CHUNK)
    lbits = torch.empty((nlist, words), dtype=torch.int64, device=dev)
    elig = torch.empty(max(1, nlist * L), dtype=torch.int32, device=dev)
    work = torch.empty(2 * chunks + 1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = _build.library().fcvi_ivf_masked_slots(
            valid.data_ptr(), mask.data_ptr(), member.data_ptr(),
            uniq.data_ptr(), nsrc, b, nlist, L, words, lbits.data_ptr(),
            elig.data_ptr(), work.data_ptr(), _build.stream(dev))
    # the offsets follow the blocks' counts; their last is the count
    return code, elig, work[2 * chunks:], lbits


def _dedup_masked(grouped, grouped_sq, valid, uniq, member, queries, k,
                  scales, mask, select, sel_stats=None):
    """B5 ``mask=`` on the card: the flat tensor-core scan
    (``fused_score_topk``) over the eligible slots of the grouped slab
    viewed as (nlist * max_list, d) rows, with B5's epilogue (no -||q||^2
    term, the member test per query). Returns (error code, counter infix
    and suffix, vals, flat ids)."""
    if grouped.dim() != 3 or queries.dim() != 2:
        raise ValueError("grouped must be 3-D and queries 2-D")
    nlist, max_list, d = grouped.shape
    b, dev = queries.shape[0], grouped.device
    n = nlist * max_list
    _build.require(grouped, "grouped", (nlist, max_list, d), dev,
                   grouped.dtype)
    _build.require(grouped_sq, "grouped_sq", (nlist, max_list), dev)
    _build.require(valid, "valid", (nlist, max_list), dev)
    _build.require(mask, "mask", (nlist, max_list), dev)
    if uniq.dim() != 1:
        raise ValueError("uniq must be 1-D")
    _build.require(uniq, "uniq", (uniq.shape[0],), dev, torch.int32)
    _build.require(member, "member", (uniq.shape[0], b), dev)
    if scales is not None:
        _build.require(scales, "scales", (nlist, max_list), dev)
    if n == 0:
        raise ValueError("an empty slab")
    code, elig, count, lbits = masked_slots(valid, mask, uniq, member)
    if code:
        return code, "", None, None
    kk = min(k, n)
    code, tag, vals, ids, _ = _scan._launch(
        grouped.view(n, d), grouped_sq.view(n), queries, kk,
        scales=None if scales is None else scales.view(n), select=select,
        b5=(elig, count, lbits, max_list), sel_stats=sel_stats)
    if kk < k:   # past every slot: dead slots read (-inf, 0)
        vals = torch.cat([vals, vals.new_full((b, k - kk), float("-inf"))],
                         dim=1)
        ids = torch.cat([ids, ids.new_zeros((b, k - kk))], dim=1)
    return code, tag, vals, ids


def ivf_score_topk_dedup(grouped: torch.Tensor, grouped_sq: torch.Tensor,
                         valid: torch.Tensor, uniq: torch.Tensor,
                         member: torch.Tensor, queries: torch.Tensor, k: int,
                         scales: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None, *,
                         _select: Optional[bool] = None,
                         _sel_stats: Optional[torch.Tensor] = None,
                         _stats: Optional[torch.Tensor] = None):
    """grouped (nlist, max_list, d) float32, bfloat16 or int8 codes,
    grouped_sq / valid (nlist, max_list) float32, uniq (s,) int32, member
    (s, b) float 0/1, queries (b, d), the optional scales (nlist, max_list)
    float32, on one CUDA device. Returns (vals (b, k) f32, flat ids (b, k)
    int32).

    ``mask`` (nlist, max_list) float 0/1 (the filter algebra's candidate
    mask, ``mask=`` of the reference, which multiplies it into ``valid``
    outside its kernel) takes its own design: the flat scan's tensor-core
    kernel over the eligible slots only (``masked_slots``: valid * mask >
    0.5 in a list with a member query), gathered by flat id from the slab
    viewed as (nlist * max_list, d) rows, with B5's epilogue: no -||q||^2
    term, -inf where the query is no member of the slot's list, flat slot
    ids ordered by (score desc, flat id asc), unfilled slots (-inf, 0).
    The same function as the list scan's for any member matrix whose live
    sources (those with a member query) are distinct lists, in ascending
    order: both callers' (``index/ivf.py``; the routed plan's tail repeats
    a live id under an empty member row).
    Masked launches count apart (``ivf_score_topk_dedup_masked`` and its
    ``_select``/``_bf16``/``_int8`` forms). ``_select`` forces the
    selection path (True) or the buffered one (False), for holding one
    against the other; ``_sel_stats`` (``_build.select_stats``) takes the
    select's profile, ``_stats`` (STATS int64 zeros on the card) the list
    scan's (``STAT_NAMES``; not with ``mask``)."""
    if mask is not None:
        code, tag, vals, ids = _dedup_masked(grouped, grouped_sq, valid,
                                             uniq, member, queries, k,
                                             scales, mask, _select,
                                             _sel_stats)
        name = NAME_DEDUP + "_masked"
    else:
        code, tag, vals, ids, _ = _launch(grouped, grouped_sq, valid, uniq,
                                          member, queries, k, scales=scales,
                                          select=_select,
                                          sel_stats=_sel_stats, stats=_stats)
        name = NAME_DEDUP
    _build.check(code, name + tag)
    _build.count(name + tag)
    return vals, ids


def ivf_score_topk_dedup_rows(grouped: torch.Tensor, grouped_sq: torch.Tensor,
                              valid: torch.Tensor, uniq: torch.Tensor,
                              member: torch.Tensor, queries: torch.Tensor,
                              payload_v: torch.Tensor,
                              payload_f: torch.Tensor, k: int,
                              scales: Optional[torch.Tensor] = None, *,
                              _select: Optional[bool] = None,
                              _stats: Optional[torch.Tensor] = None):
    """``ivf_score_topk_dedup``'s (vals, ids) plus the winners' rows of the
    grouped fp32 payloads payload_v (nlist, max_list, dv) and payload_f
    (nlist, max_list, m): (b, k, dv) and (b, k, m), zero rows for dead
    slots."""
    code, tag, vals, ids, rows = _launch(grouped, grouped_sq, valid, uniq,
                                         member, queries, k, payload_v,
                                         payload_f, scales, _select,
                                         stats=_stats)
    _build.check(code, NAME_ROWS + tag)
    _build.count(NAME_ROWS + tag)
    return (vals, ids, *rows)


def ivf_score_topk_batch(grouped: torch.Tensor, grouped_sq: torch.Tensor,
                         valid: torch.Tensor, probes: torch.Tensor,
                         queries: torch.Tensor, k: int,
                         scales: Optional[torch.Tensor] = None, *,
                         _select: Optional[bool] = None,
                         _sel_stats: Optional[torch.Tensor] = None,
                         _stats: Optional[torch.Tensor] = None):
    """Query-major probed scan: probes (b, nprobe) int32 list ids, queries
    (b, d); the slab operands as in ``ivf_score_topk_dedup``. Returns (vals
    (b, k) f32, flat ids (b, k) int32); ties go to the earlier probe
    position, then the earlier slot."""
    code, tag, vals, ids, _ = _launch(grouped, grouped_sq, valid, probes,
                                      None, queries, k, scales=scales,
                                      select=_select, sel_stats=_sel_stats,
                                      stats=_stats)
    _build.check(code, NAME_BATCH + tag)
    _build.count(NAME_BATCH + tag)
    return vals, ids
