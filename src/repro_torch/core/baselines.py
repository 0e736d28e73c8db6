"""Baseline filtered-search strategies the paper compares against (sections
2.2 and 6.1.2), in PyTorch.

* post-filter: exact flat search on raw vectors (B2), then drop the
  candidates that fail the predicate;
* pre-filter: the predicate over the corpus, then exact search inside the
  eligible rows (B2's masked variant, ``flat.search_masked``);
* hybrid: UNIFY-style, the corpus segmented by a primary filter key, and
  pre- or post-filtering chosen per batch from the predicate's range.

Predicates are axis-aligned boxes over raw filter values (range
predicates; a categorical equality is a zero-width box on its one-hot
column). Mirrors ``repro.core.baselines``. The searches run where their
index lives; ``build_hybrid`` builds on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index import flat as flat_mod
from repro_torch.kernels.ref import topk_first

Tensor = torch.Tensor


def linspace01(r: int, device=None) -> Tensor:
    """``jnp.linspace(0.0, 1.0, r)`` in float32, bit for bit: ``i * (1 /
    (r - 1))`` for i < r - 1, the reciprocal rounded to fp32 first (XLA
    turns the division by a constant into that product), then exactly
    1.0."""
    if r <= 1:
        return torch.zeros(max(r, 0), dtype=torch.float32, device=device)
    div = r - 1
    recip = torch.tensor(1.0, dtype=torch.float32, device=device) / div
    t = torch.arange(div, dtype=torch.float32, device=device) * recip
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


@dataclasses.dataclass(frozen=True)
class BoxPredicate:
    """Matches iff low_j <= f_j <= high_j for every column j; an
    unconstrained column has low=-inf and high=+inf. ``low`` and ``high``
    are (m,) float32 tensors."""

    low: Tensor
    high: Tensor

    def mask(self, filters: Tensor) -> Tensor:
        """(..., m) raw filters -> (...,) bool."""
        low, high = self.low.to(filters.device), self.high.to(filters.device)
        return torch.all((filters >= low) & (filters <= high), dim=-1)

    def _bounds(self):
        zero = torch.zeros((), dtype=self.low.dtype, device=self.low.device)
        return (torch.where(torch.isfinite(self.low), self.low, zero),
                torch.where(torch.isfinite(self.high), self.high, zero))

    def center(self) -> Tensor:
        lo, hi = self._bounds()
        return 0.5 * (lo + hi)

    def to_filter_query(self, filters: Tensor) -> Tensor:
        """Soft-predicate encoding (section 4.3): constrained columns take
        the range center, the others the corpus mean (the neutral value
        under per-column standardization)."""
        constrained = torch.isfinite(self.low) | torch.isfinite(self.high)
        mean = filters.mean(dim=0)
        return torch.where(constrained.to(mean.device),
                           self.center().to(mean.device), mean)

    def probes(self, r: int) -> Tensor:
        """r representative filter vectors (r, m) spanning the box, from
        its low corner to its high corner (multi-probe, section 4.3)."""
        lo, hi = self._bounds()
        t = linspace01(r, lo.device)[:, None]
        return lo[None, :] * (1 - t) + hi[None, :] * t


def post_filter_search(index: flat_mod.FlatIndex, filters: Tensor,
                       queries: Tensor, pred: BoxPredicate, k: int,
                       oversample: int = 10):
    """Exact flat search for k * oversample candidates, the predicate over
    them, then the top-k of the survivors; slots no survivor fills read
    -inf. Returns (scores (q, k), ids (q, k) int32)."""
    kp = min(k * oversample, index.size)
    vals, idx = flat_mod.search(index, queries, kp)
    ok = pred.mask(filters[idx.long()])
    vals = torch.where(ok, vals, float("-inf"))
    top, pos = topk_first(vals, k)
    return top, torch.gather(idx, -1, pos)


def pre_filter_search(index: flat_mod.FlatIndex, filters: Tensor,
                      queries: Tensor, pred: BoxPredicate, k: int):
    """The predicate over the whole corpus first, then exact search over the
    rows that pass (``flat.search_masked``); slots past them read (-inf,
    -1)."""
    return flat_mod.search_masked(index, queries, k, pred.mask(filters))


@dataclasses.dataclass(frozen=True)
class HybridIndex:
    """The corpus sorted by a primary filter key, with segment bounds.

    UNIFY's segmented inclusive graph in small: S contiguous segments of
    the sorted rows support range pre-filtering by segment; wide ranges
    post-filter over the whole index. ``seg_key_min``/``seg_key_max`` are
    host arrays: the strategy choice reads them on the host."""

    flat: flat_mod.FlatIndex    # rows sorted by the primary key
    filters: Tensor             # (n, m) in sorted order
    perm: Tensor                # (n,) int64: sorted row -> original id
    key_dim: int
    seg_starts: Tensor          # (S,) int64 first sorted row of a segment
    seg_key_min: np.ndarray     # (S,)
    seg_key_max: np.ndarray     # (S,)


def build_hybrid(vectors, filters, key_dim: int = 0, n_segments: int = 32,
                 device: DeviceLike = "cuda") -> HybridIndex:
    """Sort the rows stably by column ``key_dim`` of ``filters`` and cut
    them into ``n_segments`` segments of near-equal size (bounds from
    ``np.linspace``). vectors (n, d) and filters (n, m) are arrays or
    tensors; the index lives on ``device``."""
    dev = resolve_device(device)
    v = torch.as_tensor(vectors).detach().cpu().numpy()
    f = torch.as_tensor(filters).detach().cpu().numpy()
    keys = f[:, key_dim]
    perm = np.argsort(keys, kind="stable")
    bounds = np.linspace(0, len(perm), n_segments + 1).astype(np.int64)
    starts = bounds[:-1]
    return HybridIndex(
        flat=flat_mod.build(torch.tensor(v[perm], device=dev)),
        filters=torch.tensor(f[perm], device=dev),
        perm=torch.tensor(perm, dtype=torch.int64, device=dev),
        key_dim=key_dim,
        seg_starts=torch.tensor(starts, device=dev),
        seg_key_min=keys[perm[starts]],
        seg_key_max=keys[perm[bounds[1:] - 1]])


def hybrid_search(index: HybridIndex, queries: Tensor, pred: BoxPredicate,
                  k: int, pre_threshold: float = 0.25, oversample: int = 10):
    """Range-aware strategy choice for the batch: the share of segments
    whose key range meets the predicate's estimates its selectivity; at or
    below ``pre_threshold`` the search pre-filters over those segments'
    eligible rows, above it post-filters. Returns (scores, ids) with ids in
    the ORIGINAL corpus numbering (-1 for an empty slot)."""
    lo = float(pred.low[index.key_dim])
    hi = float(pred.high[index.key_dim])
    overlap = (index.seg_key_max >= lo) & (index.seg_key_min <= hi)
    frac = overlap.sum() / max(len(overlap), 1)
    if frac <= pre_threshold:
        dev = index.seg_starts.device
        seg_mask = torch.as_tensor(overlap, device=dev)
        rows = torch.arange(index.flat.size, device=dev)
        row_seg = torch.searchsorted(index.seg_starts, rows, right=True) - 1
        row_ok = seg_mask[row_seg] & pred.mask(index.filters)
        vals, idx = flat_mod.search_masked(index.flat, queries, k, row_ok)
    else:
        vals, idx = post_filter_search(index.flat, index.filters, queries,
                                       pred, k, oversample)
    ids = index.perm[idx.long().clamp(min=0)]
    return vals, torch.where(idx >= 0, ids, -1)


def ground_truth_filtered(vectors: Tensor, filters: Tensor, queries: Tensor,
                          pred: BoxPredicate, k: int):
    """Exact top-k by negative squared L2 among the rows that satisfy the
    predicate (the baselines' recall reference): the reference's
    expression ``-(|q|^2 - 2 q.v + |v|^2)``, its dot products one plain
    matmul, then the first-occurrence top-k (``topk_first``, not
    ``torch.topk``, whose tie order differs). Returns (scores (q, k), ids
    (q, k) int32)."""
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    sq = torch.sum(vectors * vectors, dim=-1)
    scores = -(q2 - 2.0 * (queries @ vectors.T) + sq[None, :])
    scores = torch.where(pred.mask(filters)[None, :], scores, float("-inf"))
    vals, pos = topk_first(scores, k)
    return vals, pos.to(torch.int32)
