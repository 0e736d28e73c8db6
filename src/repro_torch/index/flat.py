"""Exact (flat) top-k search over the transformed corpus.

Candidate generation is the fused scan + top-k (``ops.score_topk`` /
``ops.score_topk_rows``: the CUDA kernel for tensors on the card, its plain
version on the CPU). It over-retrieves ``k + REFINE_PAD`` candidates and
finishes with an exact refine: the expansion ||q||^2 - 2<q,x> + ||x||^2 loses
about 1e-4 absolute precision at fp32 when norms are large and can misorder
near-ties, so the candidates are re-scored with a direct (q - x)^2 pass.
Mirrors ``repro.index.flat`` for fp32 storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_first

Tensor = torch.Tensor

# extra candidates fetched before the exact refine; absorbs ordering flips at
# the top-k boundary caused by fp32 expansion error
REFINE_PAD = 8


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Corpus matrix (n, d) fp32 + its squared norms (n,) fp32."""

    vectors: Tensor
    sq_norms: Tensor

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


def build(vectors: Tensor, storage_dtype=None) -> FlatIndex:
    """fp32 flat index with squared norms computed from the stored rows.
    Reduced storage (bfloat16, int8) is ROADMAP A6."""
    if storage_dtype is not None:
        raise NotImplementedError(
            f"storage_dtype={storage_dtype!r}: reduced-precision storage is "
            "ROADMAP A6; the port stores flat indexes in float32")
    vectors = vectors.to(torch.float32).contiguous()
    return FlatIndex(vectors=vectors, sq_norms=torch.sum(vectors * vectors,
                                                         dim=-1))


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


def _exact_refine(vectors: Tensor, queries: Tensor, cand_idx: Tensor, k: int):
    """Re-score gathered candidates with a direct (q - x)^2 pass, top-k."""
    vals, pos = _refine_carried(vectors[cand_idx.long()], queries, k)
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
    _, cand = ops.score_topk(index.vectors, index.sq_norms, queries, kk)
    return _exact_refine(index.vectors, queries, cand, k_out)


def search_rows(index: FlatIndex, queries: Tensor, k: int, payload_v: Tensor,
                payload_f: Tensor):
    """Gather-free top-k: the winners' PAYLOAD rows come out with the ids.

    payload_v (n, dv) / payload_f (n, m) are row-aligned with the corpus
    (for serving: the normalized originals the re-rank reads). Returns
    (scores (q, k), ids (q, k), rows_v (q, k, dv), rows_f (q, k, m)), with
    (scores, ids) equal to ``search``'s: the carried scan rows are the
    stored rows, so the refine is the same arithmetic."""
    k_out, kk = _widths(index, k)
    _, cand, scan_rows, rows_v, rows_f = ops.score_topk_rows(
        index.vectors, index.sq_norms, payload_v, payload_f, queries, kk)
    vals, pos = _refine_carried(scan_rows, queries, k_out)
    ids = torch.gather(cand, -1, pos)
    rows_v = torch.gather(rows_v, 1, pos[..., None].expand(-1, -1,
                                                           rows_v.shape[-1]))
    rows_f = torch.gather(rows_f, 1, pos[..., None].expand(-1, -1,
                                                           rows_f.shape[-1]))
    return vals, ids, rows_v, rows_f
