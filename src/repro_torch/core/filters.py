"""Composable filter algebra over the index's attribute columns.

FCVI folds ONE filter vector through psi; real workloads filter on
predicates: ranges, equalities, categorical IN-lists, and conjunctions of
those over several attribute columns. This module is the predicate
*language* and its compiler; ``repro_torch.serve.planner`` picks the
physical execution plan (psi fold / in-kernel mask / routed pruning) per
query.

User surface (attribute columns are referred to by name)::

    from repro_torch.core.filters import F
    pred = F.range("price", 10, 50) & F.isin("region", [2, 5])
    engine.search(queries, filter=pred)

Compilation (``compile_predicate``) lowers any predicate tree to ONE
fixed-shape :class:`CompiledPredicate`: per-column ``[lo, hi]`` interval
bounds plus a padded IN-list table (``MAX_ISIN`` slots). Conjunctions merge
by interval intersection / IN-list intersection; an empty intersection
compiles to the always-false interval ``[+inf, -inf]``.

Evaluation semantics are defined over the engine's fp32 attribute table and
are PURE ELEMENTWISE comparisons (no accumulation, no dtype-dependent
rounding), so the numpy oracle (``CompiledPredicate.eval_np``) and the torch
evaluation (``eval_mask``, on either device) agree bit for bit on every
row. NaN attribute entries compare false on every bound, so they never
match. A copy of ``repro.core.filters`` with torch in place of jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

#: Static width of the compiled IN-list table: every predicate compiles to
#: the same shapes.
MAX_ISIN = 16


# ---------------------------------------------------------------------------
# The algebra (user-facing predicate trees)
# ---------------------------------------------------------------------------

class Predicate:
    """Base of the filter algebra; ``&`` builds conjunctions."""

    def __and__(self, other: "Predicate") -> "Predicate":
        if not isinstance(other, Predicate):
            return NotImplemented
        mine = self.children if isinstance(self, And) else (self,)
        theirs = other.children if isinstance(other, And) else (other,)
        return And(mine + theirs)


@dataclasses.dataclass(frozen=True)
class Range(Predicate):
    """``lo <= attr <= hi`` (either bound may be None = unbounded)."""

    attr: str
    lo: Optional[float]
    hi: Optional[float]


@dataclasses.dataclass(frozen=True)
class Eq(Predicate):
    """``attr == value`` (compiled as a one-element IN-list)."""

    attr: str
    value: float


@dataclasses.dataclass(frozen=True)
class IsIn(Predicate):
    """``attr in values`` (categorical membership, <= MAX_ISIN values)."""

    attr: str
    values: Tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    """Conjunction over any mix of leaves (flattened by ``&``)."""

    children: Tuple[Predicate, ...]


class F:
    """Constructor namespace: ``F.range(...) & F.isin(...) & F.eq(...)``."""

    @staticmethod
    def range(attr: str, lo: Optional[float] = None,
              hi: Optional[float] = None) -> Range:
        return Range(attr, lo, hi)

    @staticmethod
    def eq(attr: str, value: float) -> Eq:
        return Eq(attr, float(value))

    @staticmethod
    def isin(attr: str, values: Sequence[float]) -> IsIn:
        vals = tuple(float(v) for v in values)
        if not vals:
            raise ValueError("isin() needs at least one value")
        if len(vals) > MAX_ISIN:
            raise ValueError(
                f"isin() supports at most {MAX_ISIN} values, got {len(vals)}")
        return IsIn(attr, vals)


# ---------------------------------------------------------------------------
# Compilation: predicate tree -> fixed-shape column constraints
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompiledPredicate:
    """A predicate lowered to per-column fp32 constraint arrays (numpy).

    ``lo``/``hi``: (m,) interval bounds (-inf/+inf = unconstrained; an empty
    conjunction compiles to the always-false ``[+inf, -inf]``).
    ``isin_vals``: (m, MAX_ISIN) padded membership table, ``isin_count``:
    (m,) live slots (0 = no IN constraint on that column). ``constrained``
    names the columns any leaf touches (the planner's selectivity inputs).
    """

    lo: np.ndarray
    hi: np.ndarray
    isin_vals: np.ndarray
    isin_count: np.ndarray
    constrained: Tuple[int, ...]

    @property
    def n_attrs(self) -> int:
        return int(self.lo.shape[0])

    def as_arrays(self, device=None):
        """The four constraint arrays as torch tensors on ``device``, the
        operands of ``eval_mask``."""
        return tuple(torch.as_tensor(a, device=device)
                     for a in (self.lo, self.hi, self.isin_vals,
                               self.isin_count))

    def eval_np(self, attrs) -> np.ndarray:
        """(n,) bool eligibility over a raw fp32 attribute table (numpy
        brute-force oracle; bit-identical to ``eval_mask``)."""
        a = np.asarray(attrs, np.float32)
        ok = (a >= self.lo[None, :]) & (a <= self.hi[None, :])
        has = self.isin_count[None, :] > 0
        hit = a[:, :, None] == self.isin_vals[None, :, :]
        hit = hit & (np.arange(MAX_ISIN)[None, None, :]
                     < self.isin_count[None, :, None])
        ok = ok & np.where(has, hit.any(-1), True)
        return ok.all(-1)

    def fold_target_raw(self, col_means) -> np.ndarray:
        """(m,) raw-space filter query vector for the psi fold: constrained
        columns fold to their constraint's representative value (interval
        midpoint / finite bound / IN-list mean), unconstrained columns to the
        corpus column mean (whose normalized image is 0: no pull)."""
        t = np.asarray(col_means, np.float32).copy()
        for j in range(self.n_attrs):
            c = int(self.isin_count[j])
            if c > 0:
                t[j] = np.float32(np.mean(self.isin_vals[j, :c]))
                continue
            lo, hi = float(self.lo[j]), float(self.hi[j])
            if np.isfinite(lo) and np.isfinite(hi):
                t[j] = np.float32(0.5 * (lo + hi))
            elif np.isfinite(lo):
                t[j] = np.float32(lo)
            elif np.isfinite(hi):
                t[j] = np.float32(hi)
        return t


def eval_mask(attrs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              isin_vals: torch.Tensor, isin_count: torch.Tensor
              ) -> torch.Tensor:
    """(...,) bool eligibility over a (..., m) attribute table, with the
    same elementwise comparisons as ``eval_np``, on the table's device. NaN
    entries are never eligible. ``isin_vals`` (m, w) may hold fewer than
    ``MAX_ISIN`` slots when no column uses more than w (slots past a
    column's count never match), which spares the (..., m, w) comparison
    its unused width."""
    a = attrs.to(torch.float32)
    ok = (a >= lo) & (a <= hi)
    has = isin_count > 0
    hit = a[..., None] == isin_vals
    slots = torch.arange(isin_vals.shape[-1], device=isin_count.device)
    hit = hit & (slots < isin_count[..., None])
    ok = ok & torch.where(has, hit.any(-1), True)
    return ok.all(-1)


def compile_predicate(pred: Predicate,
                      attr_names: Sequence[str]) -> CompiledPredicate:
    """Lower a predicate tree onto the index's attribute schema.

    ``attr_names`` maps column order to names; unknown attribute names are a
    ValueError (they would otherwise silently match nothing).
    """
    if isinstance(pred, CompiledPredicate):
        return pred
    col: Dict[str, int] = {n: i for i, n in enumerate(attr_names)}
    m = len(attr_names)
    lo = np.full((m,), -np.inf, np.float32)
    hi = np.full((m,), np.inf, np.float32)
    isin_vals = np.zeros((m, MAX_ISIN), np.float32)
    isin_count = np.zeros((m,), np.int32)
    isin_sets: Dict[int, set] = {}
    touched = set()

    def leaf_col(attr: str) -> int:
        if attr not in col:
            raise ValueError(
                f"unknown attribute {attr!r}; index has {tuple(col)}")
        touched.add(col[attr])
        return col[attr]

    def walk(p: Predicate):
        if isinstance(p, And):
            for c in p.children:
                walk(c)
        elif isinstance(p, Range):
            j = leaf_col(p.attr)
            if p.lo is not None:
                lo[j] = max(lo[j], np.float32(p.lo))
            if p.hi is not None:
                hi[j] = min(hi[j], np.float32(p.hi))
        elif isinstance(p, (Eq, IsIn)):
            j = leaf_col(p.attr)
            vals = {np.float32(p.value)} if isinstance(p, Eq) else \
                {np.float32(v) for v in p.values}
            if j in isin_sets:
                isin_sets[j] &= vals
            else:
                isin_sets[j] = set(vals)
        else:
            raise TypeError(f"not a predicate: {p!r}")

    walk(pred)
    for j, vals in isin_sets.items():
        if not vals:
            # empty IN-list intersection: compile to the always-false interval
            lo[j], hi[j] = np.float32(np.inf), np.float32(-np.inf)
            continue
        ordered = sorted(vals)
        if len(ordered) > MAX_ISIN:
            raise ValueError(
                f"IN-list on column {j} has {len(ordered)} values; the "
                f"compiled table holds at most {MAX_ISIN}")
        isin_count[j] = len(ordered)
        isin_vals[j, :len(ordered)] = np.asarray(ordered, np.float32)
    return CompiledPredicate(lo=lo, hi=hi, isin_vals=isin_vals,
                             isin_count=isin_count,
                             constrained=tuple(sorted(touched)))
