"""Selectivity-aware query planner for the filter algebra.

Every compiled predicate executes under one of three PHYSICAL PLANS, all of
which feed the same exact filtered refine (so results are bit-identical —
the planner is a pure performance decision):

  * ``fold``   — psi fold, as the paper runs single-attribute filters: the
    predicate's representative filter vector folds into the query transform,
    candidates come from the UNMASKED scan (the fold geometry pulls matching
    rows to the top), and a per-query certificate (enough eligible rows in
    the candidate set) guards exactness, falling back to ``mask`` when it
    fails. Right for BROAD single-attribute predicates, where most scanned
    rows are eligible anyway.
  * ``mask``   — in-kernel candidate masking: the eligibility mask rides
    into ``ops.score_topk`` / ``ops.ivf_score_topk_dedup`` as an operand and
    ineligible rows score -inf inside the scan. Exhaustive over eligible
    rows — exact for ANY predicate, the safe default at mid selectivity.
  * ``routed`` — pruning: only the inverted lists of a meshless IVF index
    that hold at least one eligible row are scanned, with the in-scan mask
    finishing the job; on a sharded engine (``sharded=True``), only the
    shards holding an eligible row scan. Right for SELECTIVE predicates,
    where most of the corpus never needs to be touched.

The choice comes from cheap per-attribute equi-width histograms maintained
on the index (plus exact value counts for low-cardinality categorical
columns), combined under the attribute-independence assumption — the
Compass / filtered-PostgreSQL framing of pre-/post-/in-filter routing as a
per-query cost decision. Estimates only steer the plan choice; correctness
never depends on them.

Pure numpy, a copy of ``repro.serve.planner``: the same attribute table
gives the same plan and the same candidate width ``kp`` as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.filters import CompiledPredicate

PLAN_FOLD = "fold"
PLAN_MASK = "mask"
PLAN_ROUTED = "routed"
PLANS = (PLAN_FOLD, PLAN_MASK, PLAN_ROUTED)

#: Columns with at most this many distinct values keep exact value counts
#: (categorical estimation); everything else uses the histogram.
MAX_VALUE_COUNTS = 64

#: Exact-refine headroom on the mask/routed candidate sets (matches the
#: index layer's REFINE_PAD: absorbs scan-vs-refine ULP reorderings).
CANDIDATE_PAD = 8


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


@dataclasses.dataclass
class ColumnStats:
    """Per-attribute selectivity statistics: an equi-width histogram plus
    exact value counts when the column is low-cardinality categorical."""

    edges: np.ndarray          # (bins+1,) histogram bin edges
    counts: np.ndarray         # (bins,) rows per bin
    n: int
    value_counts: Optional[Dict[float, int]]  # exact, when distinct is small

    @classmethod
    def build(cls, col: np.ndarray, bins: int = 64) -> "ColumnStats":
        col = np.asarray(col, np.float32)
        n = int(col.shape[0])
        uniq, ucounts = np.unique(col, return_counts=True)
        vc = None
        if uniq.shape[0] <= MAX_VALUE_COUNTS:
            vc = {float(v): int(c) for v, c in zip(uniq, ucounts)}
        lo = float(col.min()) if n else 0.0
        hi = float(col.max()) if n else 1.0
        if hi <= lo:
            hi = lo + 1.0
        counts, edges = np.histogram(col, bins=bins, range=(lo, hi))
        return cls(edges=edges.astype(np.float64),
                   counts=counts.astype(np.float64), n=n, value_counts=vc)

    def _cdf(self, x: float) -> float:
        """Estimated fraction of rows with value <= x (linear within bins)."""
        if self.n == 0:
            return 0.0
        e, c = self.edges, self.counts
        if x <= e[0]:
            return 0.0
        if x >= e[-1]:
            return 1.0
        j = int(np.searchsorted(e, x, side="right")) - 1
        j = min(max(j, 0), c.shape[0] - 1)
        width = e[j + 1] - e[j]
        frac = (x - e[j]) / width if width > 0 else 1.0
        return float((c[:j].sum() + c[j] * frac) / self.n)

    def sel_range(self, lo: float, hi: float) -> float:
        if hi < lo:
            return 0.0
        return max(0.0, min(1.0, self._cdf(hi) - self._cdf(lo)))

    def sel_values(self, values) -> float:
        if self.n == 0:
            return 0.0
        if self.value_counts is not None:
            hit = sum(self.value_counts.get(float(v), 0) for v in values)
            return min(1.0, hit / self.n)
        # histogram fallback: charge each value its bin's density
        sel = 0.0
        for v in values:
            j = int(np.searchsorted(self.edges, float(v), side="right")) - 1
            if 0 <= j < self.counts.shape[0]:
                sel += float(self.counts[j]) / self.n
        return min(1.0, sel)


@dataclasses.dataclass
class QueryPlanner:
    """Compiles a predicate's selectivity estimate into a physical plan.

    Capability flags pin which plans the current (backend, topology,
    storage) can run: ``routed`` needs prunable structure (IVF inverted
    lists, or a sharded mesh whose shards can skip their scan); ``fold``
    needs the flat fp32 scan (its certificate reads exact scan scores) and a
    single-attribute predicate (psi folds one representative vector).
    """

    columns: List[ColumnStats]
    n: int
    backend: str
    storage_fp32: bool
    sharded: bool
    routed_max_sel: float = 0.05
    fold_min_sel: float = 0.5

    @classmethod
    def build(cls, attrs: np.ndarray, *, backend: str, storage_fp32: bool,
              sharded: bool, bins: int = 64) -> "QueryPlanner":
        attrs = np.asarray(attrs, np.float32)
        cols = [ColumnStats.build(attrs[:, j], bins=bins)
                for j in range(attrs.shape[1])]
        return cls(columns=cols, n=int(attrs.shape[0]), backend=backend,
                   storage_fp32=storage_fp32, sharded=sharded)

    def selectivity(self, cp: CompiledPredicate) -> float:
        """Estimated matching fraction under attribute independence."""
        sel = 1.0
        for j in cp.constrained:
            st = self.columns[j]
            c = int(cp.isin_count[j])
            if c > 0:
                s = st.sel_values(cp.isin_vals[j, :c])
                # an IN-list combined with range bounds on the same column
                # keeps the tighter of the two estimates
                s = min(s, st.sel_range(float(cp.lo[j]), float(cp.hi[j])))
            else:
                s = st.sel_range(float(cp.lo[j]), float(cp.hi[j]))
            sel *= s
        return sel

    def routed_capable(self) -> bool:
        return self.backend == "ivf" or self.sharded

    def fold_capable(self, cp: CompiledPredicate) -> bool:
        return (self.backend == "flat" and self.storage_fp32
                and len(cp.constrained) == 1)

    def choose(self, cp: CompiledPredicate) -> str:
        sel = self.selectivity(cp)
        if sel <= self.routed_max_sel and self.routed_capable():
            return PLAN_ROUTED
        if sel >= self.fold_min_sel and self.fold_capable(cp):
            return PLAN_FOLD
        return PLAN_MASK

    def kp_for(self, plan: str, cp: CompiledPredicate, k: int) -> int:
        """Candidate width per plan (a power of two for the fold plan, as
        in the reference). mask/routed scans are exhaustive over eligible
        rows, so a small refine pad suffices; the fold scan is unmasked, so
        it needs ~k/selectivity candidates for its certificate to usually
        hold."""
        if plan == PLAN_FOLD:
            sel = max(self.selectivity(cp), 1e-3)
            want = int(np.ceil(4.0 * k / sel))
            return min(self.n, _pow2_at_least(want)) if self.n else k
        return k + CANDIDATE_PAD
