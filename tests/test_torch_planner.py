"""The port's planner (``repro_torch.serve.planner``) against the JAX
package's: the golden plan-choice table of ``tests/test_planner.py``, and
selectivity, ``choose`` and ``kp_for`` equal to the reference's on the same
attribute tables.

The planner is pure numpy in both packages, so every estimate is compared
exactly. The reference's no-retrace tests have no counterpart: PyTorch runs
eagerly and traces nothing.
"""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import filters as jfilters
from repro.serve import planner as jplanner
from repro_torch.core import fcvi
from repro_torch.core import filters
from repro_torch.serve import planner
from repro_torch.serve.engine import EngineConfig, FCVIEngine
from repro_torch.serve.planner import (PLAN_FOLD, PLAN_MASK, PLAN_ROUTED,
                                       ColumnStats, QueryPlanner)

M = 4
NAMES = tuple(f"f{j}" for j in range(M))


def make_attrs(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    attrs = rng.normal(size=(n, M)).astype(np.float32)
    attrs[:, 2] = rng.integers(0, 8, size=n).astype(np.float32)  # categorical
    return attrs


def planner_for(attrs, *, backend="flat", storage_fp32=True, sharded=False):
    return QueryPlanner.build(attrs, backend=backend,
                              storage_fp32=storage_fp32, sharded=sharded)


def cp_of(pred):
    return filters.compile_predicate(pred, NAMES)


F = filters.F
BROAD = F.range("f0", -3.0, 3.0)              # sel ~ 0.997
MID = F.range("f0", -0.5, 0.5)                # sel ~ 0.38
NARROW = F.eq("f2", 5.0)                      # sel ~ 0.125
VERY_NARROW = F.range("f0", 3.0, 4.0)         # sel ~ 0.001
CONJ_BROAD = F.range("f0", -3.0, 3.0) & F.range("f1", -3.0, 3.0)


def test_histogram_selectivity_tracks_truth():
    attrs = make_attrs()
    pl = planner_for(attrs)
    for lo, hi in [(-0.5, 0.5), (-3.0, 3.0), (1.0, 2.0)]:
        est = pl.selectivity(cp_of(F.range("f0", lo, hi)))
        true = ((attrs[:, 0] >= lo) & (attrs[:, 0] <= hi)).mean()
        assert abs(est - true) < 0.05, (lo, hi, est, true)


def test_categorical_value_counts_are_exact():
    attrs = make_attrs()
    pl = planner_for(attrs)
    assert pl.columns[2].value_counts is not None  # 8 distinct -> exact
    est = pl.selectivity(cp_of(F.isin("f2", [0.0, 3.0])))
    true = np.isin(attrs[:, 2], [0.0, 3.0]).mean()
    assert abs(est - true) < 1e-6
    assert pl.selectivity(cp_of(F.eq("f2", 99.0))) == 0.0


def test_conjunction_multiplies_under_independence():
    pl = planner_for(make_attrs())
    a = pl.selectivity(cp_of(F.range("f0", -0.5, 0.5)))
    b = pl.selectivity(cp_of(F.range("f1", -0.5, 0.5)))
    ab = pl.selectivity(cp_of(F.range("f0", -0.5, 0.5)
                              & F.range("f1", -0.5, 0.5)))
    assert abs(ab - a * b) < 1e-6


@pytest.mark.parametrize("pred,backend,sharded,storage_fp32,want", [
    (BROAD, "flat", False, True, PLAN_FOLD),
    (MID, "flat", False, True, PLAN_MASK),
    (VERY_NARROW, "flat", False, True, PLAN_MASK),   # nothing to route
    (CONJ_BROAD, "flat", False, True, PLAN_MASK),    # fold is single-attr
    (BROAD, "flat", False, False, PLAN_MASK),        # fold needs fp32
    (VERY_NARROW, "ivf", False, True, PLAN_ROUTED),
    (BROAD, "ivf", False, True, PLAN_MASK),
    (NARROW, "ivf", False, True, PLAN_MASK),         # 0.125 > routed_max_sel
    (VERY_NARROW, "flat", True, True, PLAN_ROUTED),
    (BROAD, "flat", True, True, PLAN_FOLD),
])
def test_golden_plan_choice(pred, backend, sharded, storage_fp32, want):
    pl = planner_for(make_attrs(), backend=backend, sharded=sharded,
                     storage_fp32=storage_fp32)
    assert pl.choose(cp_of(pred)) == want


def test_kp_scales_inversely_with_fold_selectivity():
    pl = planner_for(make_attrs())
    kp_broad = pl.kp_for(PLAN_FOLD, cp_of(BROAD), k=10)
    kp_mid = pl.kp_for(PLAN_FOLD, cp_of(MID), k=10)
    assert kp_broad < kp_mid
    assert kp_broad >= 40
    assert pl.kp_for(PLAN_MASK, cp_of(MID), k=10) == 18
    assert pl.kp_for(PLAN_ROUTED, cp_of(MID), k=10) == 18


def _both(mod, seed):
    """(planner, the same predicates compiled) with one package."""
    attrs = make_attrs(n=3000, seed=seed)
    attrs[:, 3] = np.round(attrs[:, 3] * 2.0) / 2.0   # ~ a dozen values
    F_ = mod.F
    preds = [F_.range("f0", -3.0, 3.0), F_.range("f0", -0.5, 0.5),
             F_.eq("f2", 5.0), F_.range("f0", 3.0, 4.0),
             F_.isin("f2", [1.0, 2.0, 7.0]) & F_.range("f1", -1.0, 0.2),
             F_.range("f3", -0.5, 0.5) & F_.isin("f3", [0.0, 0.5, 9.0]),
             F_.range("f1", hi=-2.5), F_.range("f1", lo=0.0),
             F_.isin("f2", [1.0]) & F_.isin("f2", [2.0]),
             F_.eq("f3", 1.5), F_.range("f0", 1.0, 0.0)]
    return attrs, [mod.compile_predicate(p, NAMES) for p in preds]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("backend,storage_fp32", [
    ("flat", True), ("flat", False), ("ivf", True), ("ivf", False)])
def test_planner_equals_reference(seed, backend, storage_fp32):
    attrs, mine = _both(filters, seed)
    _, theirs = _both(jfilters, seed)
    kw = dict(backend=backend, storage_fp32=storage_fp32, sharded=False)
    pl = planner.QueryPlanner.build(attrs, **kw)
    jpl = jplanner.QueryPlanner.build(attrs, **kw)
    for a, b in zip(pl.columns, jpl.columns):
        np.testing.assert_array_equal(a.edges, b.edges)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.value_counts == b.value_counts and a.n == b.n
    for cp, jcp in zip(mine, theirs):
        assert pl.selectivity(cp) == jpl.selectivity(jcp)
        assert pl.choose(cp) == jpl.choose(jcp)
        assert pl.fold_capable(cp) == jpl.fold_capable(jcp)
        assert pl.routed_capable() == jpl.routed_capable()
        for plan in planner.PLANS:
            for k in (1, 5, 10, 40):
                assert pl.kp_for(plan, cp, k) == jpl.kp_for(plan, jcp, k)


def test_constants_match_reference():
    assert planner.PLANS == jplanner.PLANS
    assert planner.CANDIDATE_PAD == jplanner.CANDIDATE_PAD
    assert planner.MAX_VALUE_COUNTS == jplanner.MAX_VALUE_COUNTS
    assert filters.MAX_ISIN == jfilters.MAX_ISIN


def test_engine_plan_counters_follow_choice():
    rng = np.random.default_rng(3)
    n = 600
    v = rng.normal(size=(n, 16)).astype(np.float32)
    a = make_attrs(n=n, seed=3)
    idx = fcvi.build(v, a, fcvi.FCVIConfig(alpha=1.0, lam=0.6, c=8.0),
                     device="cpu")
    eng = FCVIEngine(idx, EngineConfig(k=5, batch_size=8), device="cpu",
                     attributes=a)
    q = rng.normal(size=(4, 16)).astype(np.float32)
    eng.search(q, filter=BROAD)
    assert eng.stats.plan_fold == 4
    eng.search(q, filter=MID)
    assert eng.stats.plan_mask == 4
    assert eng.stats.filtered_queries == 8
    assert eng.stats.queries == 8 and eng.stats.scan_batches == 2


def test_column_stats_degenerate_inputs():
    """Constant and tiny columns must not divide by zero or crash."""
    st = ColumnStats.build(np.zeros((50,), np.float32))
    assert st.sel_range(-1.0, 1.0) == pytest.approx(1.0)
    assert st.sel_range(0.5, 1.0) == 0.0
    st1 = ColumnStats.build(np.array([2.0], np.float32))
    assert st1.sel_values([2.0]) == pytest.approx(1.0)
    pl = QueryPlanner(columns=[st], n=0, backend="flat", storage_fp32=True,
                      sharded=False)
    assert pl.kp_for(PLAN_FOLD, cp_of(F.range("f0", 0.0, 1.0)), 5) == 5
    wide = ColumnStats.build(np.arange(200, dtype=np.float32))
    assert wide.value_counts is None              # > MAX_VALUE_COUNTS
    jwide = jplanner.ColumnStats.build(np.arange(200, dtype=np.float32))
    assert wide.sel_values([3.0, 150.0]) == jwide.sel_values([3.0, 150.0])
