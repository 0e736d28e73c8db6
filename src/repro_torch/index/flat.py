"""Exact (flat) top-k search over the transformed corpus.

Candidate generation is the fused scan + top-k (``ops.score_topk`` /
``ops.score_topk_rows``: the CUDA kernel for tensors on the card, its plain
version on the CPU). It over-retrieves ``k + REFINE_PAD`` candidates and
finishes with an exact refine: the expansion ||q||^2 - 2<q,x> + ||x||^2 loses
about 1e-4 absolute precision at fp32 when norms are large and can misorder
near-ties, so the candidates are re-scored with a direct (q - x)^2 pass.

The corpus may be stored as fp32, bf16 or int8 codes with one fp32 scale
per row (``storage_dtype``, the storage ladder). The squared norms are
those of the stored rows cast up (or dequantized), the scan accumulates
fp32, and the refine runs on fp32 rows, so the scores are exact for the
stored corpus. Mirrors ``repro.index.flat``, the filter algebra's helpers
included (``search_masked``, ``filtered_d2``, ``lexsort_topk``,
``finalize_filtered``, ``masked_candidates``, ``filtered_refine``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.index import quant
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_first

Tensor = torch.Tensor

# extra candidates fetched before the exact refine; absorbs ordering flips at
# the top-k boundary caused by fp32 expansion error
REFINE_PAD = 8


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Corpus matrix (n, d) fp32, bf16 or int8 codes, its squared norms
    (n,) fp32 and, for int8, the per-row scales (n,) fp32: stored rows
    dequantize as ``vectors.float() * scales[:, None]``."""

    vectors: Tensor
    sq_norms: Tensor
    scales: Optional[Tensor] = None

    @property
    def size(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    def search(self, queries: Tensor, k: int):
        """SearchBackend entry point."""
        return search(self, queries, k)

    def search_rows(self, queries: Tensor, k: int, payload_v: Tensor,
                    payload_f: Tensor):
        """Gather-free entry point (rows, not just ids)."""
        return search_rows(self, queries, k, payload_v, payload_f)

    def slab(self):
        """The serving slab (``index.slab.FlatSlab``) to shard."""
        from repro_torch.index.slab import FlatSlab
        return FlatSlab(self.vectors, self.sq_norms, self.scales)


def from_stored(vectors: Tensor, scales: Optional[Tensor] = None
                ) -> FlatIndex:
    """A FlatIndex over rows as stored (fp32, bf16, or int8 codes with
    their ``scales``), with squared norms of the stored values in fp32."""
    vectors = vectors.contiguous()
    if scales is not None:
        scales = scales.to(torch.float32).contiguous()
        return FlatIndex(vectors=vectors,
                         sq_norms=quant.sq_norms_of(vectors, scales),
                         scales=scales)
    return FlatIndex(vectors=vectors, sq_norms=torch.sum(
        vectors.to(torch.float32) ** 2, dim=-1))


def build(vectors: Tensor, storage_dtype=None) -> FlatIndex:
    """Flat index over fp32 ``vectors``, stored at ``storage_dtype``: None
    (fp32), ``torch.bfloat16`` (a cast) or ``torch.int8`` (per-row codes
    and scales, ``quant.quantize_rows``)."""
    vectors = vectors.to(torch.float32)
    if quant.is_quantized(storage_dtype):
        return from_stored(*quant.quantize_rows(vectors))
    if storage_dtype is not None:
        vectors = vectors.to(storage_dtype)
    return from_stored(vectors)


def merge_topk(vals_a: Tensor, idx_a: Tensor, vals_b: Tensor, idx_b: Tensor,
               k: int):
    """Joint top-k (max score, first occurrence on ties) of two candidate
    sets. Pads with ``-inf`` scores / id 0 when the two hold fewer than k;
    duplicate ids across the sets both compete."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idxs = torch.cat([idx_a, idx_b], dim=-1)
    total = vals.shape[-1]
    if k > total:
        pad = k - total
        vals = torch.cat([vals, vals.new_full((*vals.shape[:-1], pad),
                                              float("-inf"))], dim=-1)
        idxs = torch.cat([idxs, idxs.new_zeros((*idxs.shape[:-1], pad))],
                         dim=-1)
    top_vals, pos = topk_first(vals, k)
    return top_vals, torch.gather(idxs, -1, pos)


def _exact_refine(vectors: Tensor, queries: Tensor, cand_idx: Tensor, k: int,
                  scales: Optional[Tensor] = None):
    """Re-score gathered candidates with a direct (q - x)^2 pass, top-k, in
    fp32 whatever the storage dtype: bf16 rows are cast up and int8 rows
    dequantized with their ``scales``."""
    idx = cand_idx.long()
    rows = vectors[idx].to(torch.float32)
    if scales is not None:
        rows = rows * scales[idx][..., None]
    vals, pos = _refine_carried(rows, queries, k)
    return vals, torch.gather(cand_idx, -1, pos)


def _refine_carried(scan_rows: Tensor, queries: Tensor, k: int):
    """Exact refine over the kernel-carried candidate rows: the arithmetic
    of ``_exact_refine`` without the gather. Returns (vals, pos) with pos
    into the carried candidate axis."""
    d2 = torch.sum((queries[:, None, :] - scan_rows) ** 2, dim=-1)
    return topk_first(-d2, k)


def _widths(index: FlatIndex, k: int):
    k_out = min(k, index.size)
    return k_out, min(index.size, k_out + REFINE_PAD)


def search(index: FlatIndex, queries: Tensor, k: int):
    """Top-k by squared L2, returned as NEGATIVE distance (higher is better).
    queries (q, d). Returns (scores (q, k) f32, ids (q, k) int32)."""
    k_out, kk = _widths(index, k)
    _, cand = ops.score_topk(index.vectors, index.sq_norms, queries, kk,
                             scales=index.scales)
    return _exact_refine(index.vectors, queries, cand, k_out, index.scales)


def search_rows(index: FlatIndex, queries: Tensor, k: int, payload_v: Tensor,
                payload_f: Tensor):
    """Gather-free top-k: the winners' PAYLOAD rows come out with the ids.

    payload_v (n, dv) / payload_f (n, m) are row-aligned with the corpus
    (for serving: the normalized originals the re-rank reads). Returns
    (scores (q, k), ids (q, k), rows_v (q, k, dv), rows_f (q, k, m)), with
    (scores, ids) equal to ``search``'s: the carried scan rows are the
    stored rows dequantized to fp32, so the refine is the same
    arithmetic."""
    k_out, kk = _widths(index, k)
    _, cand, scan_rows, rows_v, rows_f = ops.score_topk_rows(
        index.vectors, index.sq_norms, payload_v, payload_f, queries, kk,
        scales=index.scales)
    vals, pos = _refine_carried(scan_rows, queries, k_out)
    ids = torch.gather(cand, -1, pos)
    rows_v = torch.gather(rows_v, 1, pos[..., None].expand(-1, -1,
                                                           rows_v.shape[-1]))
    rows_f = torch.gather(rows_f, 1, pos[..., None].expand(-1, -1,
                                                           rows_f.shape[-1]))
    return vals, ids, rows_v, rows_f


def search_masked(index: FlatIndex, queries: Tensor, k: int, mask: Tensor):
    """Exact search restricted to ``mask`` (n,) bool, the pre-filtering
    primitive: the mask plan's candidate generation (``masked_candidates``,
    B2's masked variants on the card) and exact refine
    (``filtered_refine``). Returns (scores (q, k), ids (q, k)); slots past
    the eligible rows read (-inf, -1)."""
    k_out, kk = _widths(index, k)
    cand, valid = masked_candidates(index, queries, kk, mask)
    return finalize_filtered(*filtered_refine(
        index.vectors, index.scales, queries, cand, valid, mask, k_out))


# ---------------------------------------------------------------------------
# Filtered refine: the shared exactness anchor of the filter-algebra plans
# ---------------------------------------------------------------------------
#
# Every physical plan (psi fold / in-kernel mask / routed pruning) finishes
# through these primitives, which compute per-row fp32 squared distances
# with ONE canonical expression and break ties by (distance, id). Identical
# candidate rows therefore give identical bits under every plan: candidate
# generation only has to guarantee that the true filtered top-k is IN the
# candidate set, never how it is ordered.

#: id sentinel for dead (ineligible / unfilled) slots while sorting; -1 in
#: the final output. Sorts after every real id at equal distance.
DEAD_ID = 2 ** 31 - 1


def filtered_d2(queries: Tensor, rows: Tensor) -> Tensor:
    """Canonical fp32 squared distance: queries (b, d) x rows (b, c, d) or
    (c, d) -> (b, c).

    Elementwise subtract and multiply, then a sum over d in one fixed
    order: the last axis is zero-padded to a power of two and folded in
    halves, each fold one elementwise add. A reduction kernel would choose
    its summation order from the tensor's shape (and the plans' c differ:
    kp for the fold plan, k + 8 for mask and routed, nd for the delta
    tier); elementwise adds round the same way whatever the shape or
    device, so a row's d2 has the same bits under every plan, on the card
    and on the CPU. (The reference's ``jnp.sum`` agrees to fp32
    tolerance.)"""
    if rows.dim() == 2:
        rows = rows[None, :, :]
    diff = queries[:, None, :].to(torch.float32) - rows
    sq = diff * diff
    d = sq.shape[-1]
    width = 1 << max(0, (d - 1).bit_length())
    if width != d:
        sq = torch.nn.functional.pad(sq, (0, width - d))
    while sq.shape[-1] > 1:
        half = sq.shape[-1] // 2
        sq = sq[..., :half] + sq[..., half:]
    return sq[..., 0]


def lexsort_topk(d2: Tensor, ids: Tensor, k: int):
    """Smallest-k by (d2 asc, id asc) along the last axis; pads with
    (+inf, DEAD_ID) when fewer than ``k`` entries exist.

    One sort of a packed int64 key: d2 >= +0 or +inf (a sum of squares,
    never NaN), whose fp32 bits order as its values do, in the high word,
    and the id (0 <= id <= DEAD_ID) in the low word. Exact; the keys are
    unique except for equal dead slots."""
    c = d2.shape[-1]
    if c < k:
        pad = k - c
        d2 = torch.cat([d2, d2.new_full((*d2.shape[:-1], pad),
                                        float("inf"))], dim=-1)
        ids = torch.cat([ids, ids.new_full((*ids.shape[:-1], pad), DEAD_ID)],
                        dim=-1)
    bits = d2.to(torch.float32).contiguous().view(torch.int32).long()
    key = (bits << 32) | ids.long()
    key = torch.sort(key, dim=-1).values[..., :k]
    d2s = (key >> 32).to(torch.int32).view(torch.float32)
    return d2s, (key & 0xFFFFFFFF).to(torch.int32)


def finalize_filtered(d2: Tensor, ids: Tensor):
    """(d2, ids) -> (scores, ids) in the filtered-result convention:
    scores = -d2, dead slots = (-inf, -1)."""
    dead = torch.isinf(d2)
    return (torch.where(dead, float("-inf"), -d2),
            torch.where(dead, -1, ids))


def masked_candidates(index: FlatIndex, queries: Tensor, kk: int,
                      elig: Tensor):
    """Masked-scan candidate generation for the mask plan: the (n,)
    eligibility rides into the scan as its mask operand (B2's masked
    variants on the card), so ineligible rows score -inf inside the scan.
    Returns (cand (b, kk) corpus ids, valid (b, kk) bool) for
    ``filtered_refine``."""
    vals, cand = ops.score_topk(index.vectors, index.sq_norms, queries, kk,
                                scales=index.scales,
                                mask=elig.to(torch.float32))
    return torch.clamp(cand, min=0), ~torch.isneginf(vals)


def filtered_refine(vectors: Tensor, scales: Optional[Tensor],
                    queries: Tensor, cand_idx: Tensor, cand_valid: Tensor,
                    elig: Tensor, k: int, row_ids: Optional[Tensor] = None):
    """Exact filtered top-k over a candidate set.

    cand_idx: (b, c) row positions in ``vectors`` (valid entries
    duplicate-free); cand_valid: (b, c) bool (False = unfilled scan slot);
    elig: (n,) bool row eligibility; ``row_ids`` (n,) the rows' corpus ids
    when they are not their positions (a shard's block). Ineligible or
    invalid candidates get (+inf, DEAD_ID) and the rest sort by (exact fp32
    d2, corpus id). Returns (d2 (b, k), ids (b, k) int32); callers finish
    with ``finalize_filtered``."""
    idx = cand_idx.long()
    rows = vectors[idx].to(torch.float32)                   # (b, c, d)
    if scales is not None:
        rows = rows * scales[idx][..., None]
    d2 = filtered_d2(queries, rows)
    ok = cand_valid & elig[idx]
    d2 = torch.where(ok, d2, float("inf"))
    ids = cand_idx if row_ids is None else row_ids[idx]
    ids = torch.where(ok, ids.to(torch.int32), DEAD_ID)
    return lexsort_topk(d2, ids, k)
