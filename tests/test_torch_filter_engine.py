"""Predicate search (``FCVIEngine.search(q, filter=pred)``) in the port,
against the JAX engine and a numpy fp64 brute-force oracle.

The JAX package builds each index; its state is handed to the port
(``index_state`` with numpy leaves), and both engines get the same raw
attribute table. Cases come from ``make_case`` of
``tests/test_filter_oracle.py``: random corpora, mixed continuous and
categorical attributes, and predicate trees whose bounds are drawn from the
data (empty and all-rows matches included), over flat and IVF; seeds are
parametrised, and ``hypothesis`` draws more where it is installed, as the
reference's suite does.

Contract, as in the reference: every plan is exact against the oracle (ids
equal outside fp64 near-ties of 1e-4, scores within rtol = atol = 1e-4),
and every plan the index can run (the planner's choice and each forced
plan) gives the same bits within the port. Against the JAX engine: ids
equal outside near-ties, scores within rtol = atol = 1e-4 (the two
packages sum the squared differences in another order).
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import FCVIConfig as JConfig
from repro.core import build as jbuild
from repro.core import fcvi as jfcvi
from repro.core.filters import F as JF
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import FCVIEngine as JEngine
from repro_torch.core import fcvi
from repro_torch.core import filters
from repro_torch.core.filters import F
from repro_torch.serve.engine import EngineConfig, FCVIEngine
from test_filter_oracle import D, M, make_case
from test_torch_support import tensor, to_numpy_tree

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

TOL = dict(rtol=1e-4, atol=1e-4)


def to_port(pred):
    """The reference's predicate tree rebuilt with the port's ``F``."""
    from repro.core import filters as jfilters

    if isinstance(pred, jfilters.And):
        out = to_port(pred.children[0])
        for c in pred.children[1:]:
            out = out & to_port(c)
        return out
    if isinstance(pred, jfilters.Range):
        return F.range(pred.attr, pred.lo, pred.hi)
    if isinstance(pred, jfilters.Eq):
        return F.eq(pred.attr, pred.value)
    return F.isin(pred.attr, pred.values)


def engines(vectors, attrs, cfg_kw, eng_kw, **port_kw):
    """(JAX engine, port engine on the CPU over the handed-over state)."""
    jidx = jbuild(jnp.asarray(vectors), jnp.asarray(attrs),
                  JConfig(**cfg_kw))
    jeng = JEngine(jidx, JEngineConfig(**eng_kw), attributes=attrs, **port_kw)
    mine = fcvi.index_from_state(fcvi.FCVIConfig(**cfg_kw),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")
    eng = FCVIEngine(mine, EngineConfig(**eng_kw), device="cpu",
                     attributes=attrs, **port_kw)
    return jeng, eng


def oracle(eng, queries, pred, k, tie_tol=1e-4):
    """fp64 numpy filtered top-k over the port engine's own fold-transformed
    queries and dequantized stored rows, (d2 asc, id asc); returns (scores,
    ids, ambiguous) in the engine's convention (``brute_force_oracle`` of
    the reference, on the port's state)."""
    cp = filters.compile_predicate(pred, eng._attr_names)
    elig = cp.eval_np(eng._attrs_np)
    q_t = fcvi.fold_queries(eng.index, tensor(queries),
                            cp.fold_target_raw(eng._col_means))
    q_t = q_t.numpy().astype(np.float64)
    be = eng.index.backend
    rows = be.vectors.to(torch.float32).numpy().astype(np.float64)
    if be.scales is not None:
        rows = rows * be.scales.numpy().astype(np.float64)[:, None]
    n, b = rows.shape[0], q_t.shape[0]
    d2 = ((q_t[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
    d2[:, ~elig] = np.inf
    ids = np.broadcast_to(np.arange(n), (b, n))
    order = np.lexsort((ids, d2), axis=-1)
    sd2 = np.take_along_axis(d2, order, axis=-1)
    if n < k:
        sd2 = np.concatenate([sd2, np.full((b, k - n), np.inf)], axis=-1)
        order = np.concatenate([order, np.zeros((b, k - n), order.dtype)],
                               axis=-1)
    with np.errstate(invalid="ignore"):
        prev = np.concatenate([np.full((b, 1), -np.inf), sd2[:, :-1]], -1)
        nxt = np.concatenate([sd2[:, 1:], np.full((b, 1), np.inf)], -1)
        amb = ((sd2 - prev) < tie_tol) | ((nxt - sd2) < tie_tol)
    amb &= np.isfinite(sd2)
    top, order, amb = sd2[:, :k], order[:, :k], amb[:, :k]
    dead = np.isinf(top)
    return (np.where(dead, -np.inf, -top).astype(np.float32),
            np.where(dead, -1, order).astype(np.int64), amb)


def plans_for(eng, pred):
    cp = filters.compile_predicate(pred, eng._attr_names)
    plans = [None, "mask"]
    if eng.planner.fold_capable(cp):
        plans.append("fold")
    if eng.planner.routed_capable():
        plans.append("routed")
    return plans


def check_case(seed: int):
    vectors, attrs, queries, jpred, backend, _ = make_case(seed)
    cfg = dict(alpha=1.0, lam=0.6, c=8.0, backend=backend, nlist=8,
               nprobe=4)
    jeng, eng = engines(vectors, attrs, cfg, dict(k=5, batch_size=8),
                        attr_names=[f"f{j}" for j in range(M)])
    pred = to_port(jpred)
    want_s, want_i, amb = oracle(eng, queries, pred, k=5)
    outs = {pl: eng.search(queries, filter=pred, plan=pl)
            for pl in plans_for(eng, pred)}
    for pl, (s, i) in outs.items():
        assert s.dtype == np.float32 and i.dtype == np.int64
        assert ((i == want_i) | amb).all(), (
            f"ids vs oracle (plan={pl}, seed={seed}, pred={pred})")
        np.testing.assert_allclose(s, want_s, **TOL,
                                   err_msg=f"plan={pl}, seed={seed}")
    base = outs[None]
    for pl, (s, i) in outs.items():   # cross-plan: bit for bit
        assert np.array_equal(s, base[0]) and np.array_equal(i, base[1]), (
            f"plan {pl} != the planner's choice (seed={seed}, pred={pred})")
    js, ji = jeng.search(queries, filter=jpred)
    assert ((ji == base[1]) | amb).all(), f"ids vs JAX (seed={seed})"
    np.testing.assert_allclose(base[0], js, **TOL)
    for name in ("filtered_queries", "plan_fold", "plan_mask",
                 "plan_routed"):
        assert getattr(eng.stats, name) >= 0
    assert eng.stats.filtered_queries == len(outs) * queries.shape[0]


@pytest.mark.property
@pytest.mark.parametrize("seed", list(range(16)))
def test_differential_oracle_seeds(seed):
    check_case(seed)


if HAVE_HYPOTHESIS:

    @pytest.mark.property
    @settings(max_examples=10, deadline=None, derandomize=True)
    @given(seed=st.integers(min_value=0, max_value=50_000))
    def test_differential_oracle_property(seed):
        check_case(seed)


# -- deterministic edge cases -------------------------------------------------

@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(7)
    v = rng.normal(size=(120, D)).astype(np.float32)
    a = rng.normal(size=(120, M)).astype(np.float32)
    jeng, eng = engines(v, a, dict(alpha=1.0, lam=0.6, c=8.0),
                        dict(k=5, batch_size=8))
    q = rng.normal(size=(3, D)).astype(np.float32)
    return jeng, eng, a, q


def test_zero_match_returns_certified_empty(small):
    _, eng, _, q = small
    for pred in (F.range("f0", 100.0, 200.0),
                 F.isin("f1", [1.0]) & F.isin("f1", [2.0])):
        s, i = eng.search(q, filter=pred)
        assert (i == -1).all() and np.isneginf(s).all()
        assert s.shape == (3, 5) and i.dtype == np.int64


def test_single_row_match(small):
    jeng, eng, a, q = small
    s, i = eng.search(q, filter=F.eq("f0", float(a[17, 0])))
    assert (i[:, 0] == 17).all() and (i[:, 1:] == -1).all()
    assert np.isfinite(s[:, 0]).all() and np.isneginf(s[:, 1:]).all()
    js, _ = jeng.search(q, filter=JF.eq("f0", float(a[17, 0])))
    np.testing.assert_allclose(s, js, **TOL)


def test_all_rows_match_equals_unfiltered_topk(small):
    _, eng, _, q = small
    pred = F.range("f0", -1e9, 1e9)
    ws, wi, amb = oracle(eng, q, pred, k=5)
    for plan in (None, "fold", "mask"):
        s, i = eng.search(q, filter=pred, plan=plan)
        assert ((i == wi) | amb).all() and (i >= 0).all()
        np.testing.assert_allclose(s, ws, **TOL)


def test_k_exceeds_eligible_pads_dead_slots(small):
    _, eng, a, q = small
    order = np.argsort(a[:, 0])
    lo, hi = float(a[order[0], 0]), float(a[order[2], 0])
    s, i = eng.search(q, filter=F.range("f0", lo, hi))
    n_match = int(((a[:, 0] >= lo) & (a[:, 0] <= hi)).sum())
    assert 1 <= n_match < 5
    assert ((i >= 0).sum(axis=1) == n_match).all()
    assert np.isneginf(s[:, n_match:]).all()


def test_argument_errors(small):
    _, eng, a, q = small
    with pytest.raises(ValueError, match="unknown attribute"):
        eng.search(q, filter=F.range("price", 0.0, 1.0))
    with pytest.raises(ValueError, match="not both"):
        eng.search(q, a[:3, :], filter=F.range("f0", 0.0, 1.0))
    with pytest.raises(TypeError):
        eng.search(q)
    with pytest.raises(ValueError, match="plan= only applies"):
        eng.search(q, a[:3, :], plan="mask")
    with pytest.raises(ValueError, match="unknown plan"):
        eng.search(q, filter=F.range("f0", 0.0, 1.0), plan="scan")
    with pytest.raises(ValueError, match="fold"):
        eng.search(q, filter=F.range("f0", 0.0, 1.0) & F.range("f1", 0, 1),
                   plan="fold")
    with pytest.raises(ValueError, match="routed"):
        eng.search(q, filter=F.range("f0", 0.0, 1.0), plan="routed")
    with pytest.raises(ValueError, match="non-empty"):
        eng.search(q[:0], filter=F.range("f0", 0.0, 1.0))
    with pytest.raises(ValueError, match="dimension"):
        eng.search(q[:, :4], filter=F.range("f0", 0.0, 1.0))
    bad = q.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        eng.search(bad, filter=F.range("f0", 0.0, 1.0))
    with pytest.raises(ValueError, match="attributes must be"):
        FCVIEngine(eng.index, device="cpu", attributes=a[:10])
    with pytest.raises(ValueError, match="attr_names"):
        FCVIEngine(eng.index, device="cpu", attributes=a,
                   attr_names=["x", "y"])


def test_default_attributes_are_the_raw_filters(small):
    """Without ``attributes=`` predicates run over the de-normalized filter
    columns, as in the reference; the planner's histograms agree."""
    jeng, eng, a, q = small
    mine = FCVIEngine(eng.index, EngineConfig(k=5), device="cpu")
    theirs = JEngine(jeng.index, JEngineConfig(k=5))
    np.testing.assert_allclose(mine._attrs_np, theirs._attrs_np, rtol=1e-5,
                               atol=1e-5)
    assert mine._attr_names == ("f0", "f1", "f2", "f3")
    np.testing.assert_allclose(mine._col_means, theirs._col_means, rtol=1e-5,
                               atol=1e-6)
    pred = F.range("f1", -0.5, 0.7)
    ws, wi, amb = oracle(mine, q, pred, k=5)
    s, i = mine.search(q, filter=pred)
    assert ((i == wi) | amb).all()


def test_named_columns_and_stats(small):
    jeng, eng, a, q = small
    named = FCVIEngine(eng.index, EngineConfig(k=5, batch_size=2),
                       device="cpu", attributes=a,
                       attr_names=["price", "stock", "cat", "region"])
    pred = F.range("price", -0.5, 0.5) & F.range("region", -2.0, 2.0)
    s, i = named.search(q, filter=pred)
    s2, i2 = eng.search(q, filter=F.range("f0", -0.5, 0.5)
                        & F.range("f3", -2.0, 2.0))
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(i, i2)
    st_ = named.stats
    assert st_.filtered_queries == 3 and st_.queries == 3
    assert st_.plan_mask == 3 and st_.scan_batches == 2   # batches of 2
    assert st_.total_time_s > 0 and st_.cache_hits == 0


def test_fold_fallback_rows_rerun_under_mask():
    """A fold window too small for its certificate: the uncertified rows
    re-run under the mask plan and the result stays exact and equal to the
    forced mask plan bit for bit, as in the reference."""
    rng = np.random.default_rng(12)
    n = 400
    v = rng.normal(size=(n, D)).astype(np.float32)
    a = rng.normal(size=(n, M)).astype(np.float32)
    jeng, eng = engines(v, a, dict(alpha=1.0, lam=0.6, c=8.0),
                        dict(k=5, batch_size=8))
    q = rng.normal(size=(7, D)).astype(np.float32) * 3.0
    pred = F.range("f0", -0.3, 2.5)          # sel ~ 0.6: the fold plan
    eng.planner.fold_min_sel = 0.0
    eng.planner.kp_for = lambda plan, cp, k: k   # window of k: rarely certified
    s, i = eng.search(q, filter=pred, plan="fold")
    assert eng.stats.filtered_fallbacks > 0
    ms, mi = eng.search(q, filter=pred, plan="mask")
    np.testing.assert_array_equal(s, ms)
    np.testing.assert_array_equal(i, mi)
    ws, wi, amb = oracle(eng, q, pred, k=5)
    assert ((i == wi) | amb).all()
    js, ji = jeng.search(q, filter=JF.range("f0", -0.3, 2.5), plan="fold")
    np.testing.assert_allclose(s, js, **TOL)


def test_delta_rows_are_predicate_checked():
    """Pending inserts take part: their insert filters are their attribute
    values; eligible delta rows surface with ids >= index.size, ineligible
    ones never do; after compaction the same rows answer under corpus ids
    (the planner's histograms and column means are refreshed)."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(100, D)).astype(np.float32)
    a = rng.normal(size=(100, M)).astype(np.float32)
    jeng, eng = engines(v, a, dict(alpha=1.0, lam=0.6, c=8.0),
                        dict(k=4, batch_size=8, compact_threshold=10_000))
    q = rng.normal(size=(2, D)).astype(np.float32)
    pred, jpred = F.range("f0", 50.0, 60.0), JF.range("f0", 50.0, 60.0)
    s, i = eng.search(q, filter=pred)
    assert (i == -1).all()
    nv = rng.normal(size=(3, D)).astype(np.float32)
    nf = a[:3].copy()
    nf[:, 0] = 55.0
    for e in (eng, jeng):
        e.insert(nv, nf)
    s, i = eng.search(q, filter=pred)
    assert set(i[:, :3].ravel()) == {100, 101, 102}
    assert (i[:, 3] == -1).all()
    js, ji = jeng.search(q, filter=jpred)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)
    # a predicate over main and delta rows merges both tiers exactly
    both = F.range("f1", -0.5, 0.8)
    s, i = eng.search(q, filter=both)
    js, ji = jeng.search(q, filter=JF.range("f1", -0.5, 0.8))
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(s, js, **TOL)
    eng.compact()
    assert eng._attrs_np.shape == (103, M) and eng._attrs.shape == (103, M)
    s2, i2 = eng.search(q, filter=pred)
    assert (np.sort(i2[:, :3], axis=1) == [100, 101, 102]).all()
    assert (i2[:, 3] == -1).all()


@pytest.mark.parametrize("backend", ["flat", "ivf"])
@pytest.mark.parametrize("storage", ["bfloat16", "int8"])
def test_reduced_storage_matches_oracle_and_jax(backend, storage):
    """The mask plan (and routed, for IVF) over bf16 / int8 rows: exact
    with respect to the dequantized stored rows."""
    rng = np.random.default_rng(13)
    v = rng.normal(size=(150, D)).astype(np.float32)
    a = rng.normal(size=(150, M)).astype(np.float32)
    cfg = dict(alpha=1.0, lam=0.6, c=8.0, backend=backend, nlist=8,
               nprobe=4, storage_dtype=storage)
    jeng, eng = engines(v, a, cfg, dict(k=5, batch_size=8))
    q = rng.normal(size=(3, D)).astype(np.float32)
    pred = F.range("f0", -0.7, 0.9) & F.range("f2", -2.0, 2.0)
    ws, wi, amb = oracle(eng, q, pred, k=5)
    outs = [eng.search(q, filter=pred, plan=p)
            for p in plans_for(eng, pred)]
    for s, i in outs:
        assert ((i == wi) | amb).all()
        np.testing.assert_allclose(s, ws, **TOL)
        assert np.array_equal(s, outs[0][0]) and np.array_equal(i, outs[0][1])
    js, ji = jeng.search(q, filter=JF.range("f0", -0.7, 0.9)
                         & JF.range("f2", -2.0, 2.0))
    assert ((ji == outs[0][1]) | amb).all()
    np.testing.assert_allclose(outs[0][0], js, **TOL)


def test_pq_backend_rejects_predicates():
    rng = np.random.default_rng(17)
    v = rng.normal(size=(256, D)).astype(np.float32)
    a = rng.normal(size=(256, M)).astype(np.float32)
    idx = fcvi.build(v, a, fcvi.FCVIConfig(alpha=1.0, lam=0.6, c=8.0,
                                           backend="pq", pq_m=8, pq_ksub=16,
                                           pq_coarse=8), device="cpu")
    eng = FCVIEngine(idx, EngineConfig(k=5), device="cpu")
    assert eng.planner is None
    with pytest.raises(ValueError, match="flat or ivf"):
        eng.search(rng.normal(size=(2, D)).astype(np.float32),
                   filter=F.range("f0", 0.0, 1.0))


def test_ivf_routed_prunes_lists_and_matches_mask():
    """A selective predicate on IVF: the planner routes, the routed scan
    reaches only lists holding an eligible row, and mask and routed agree
    bit for bit; ids equal the JAX engine's outside near-ties."""
    rng = np.random.default_rng(21)
    n = 600
    v = rng.normal(size=(n, D)).astype(np.float32)
    a = rng.normal(size=(n, M)).astype(np.float32)
    a[:, 3] = rng.integers(0, 40, n).astype(np.float32)
    cfg = dict(alpha=1.0, lam=0.6, c=8.0, backend="ivf", nlist=16, nprobe=4)
    jeng, eng = engines(v, a, cfg, dict(k=5, batch_size=8))
    q = rng.normal(size=(9, D)).astype(np.float32)
    pred, jpred = F.eq("f3", 7.0), JF.eq("f3", 7.0)
    cp = filters.compile_predicate(pred, eng._attr_names)
    assert eng.planner.choose(cp) == "routed"
    from repro_torch.index import ivf

    uniq, n_live = ivf.eligible_lists(eng.index.backend.lists,
                                      tensor(cp.eval_np(a)))
    assert n_live < eng.index.backend.nlist
    s, i = eng.search(q, filter=pred)
    ms, mi = eng.search(q, filter=pred, plan="mask")
    np.testing.assert_array_equal(s, ms)
    np.testing.assert_array_equal(i, mi)
    assert eng.stats.plan_routed == 9 and eng.stats.plan_mask == 9
    ws, wi, amb = oracle(eng, q, pred, k=5)
    assert ((i == wi) | amb).all()
    js, ji = jeng.search(q, filter=jpred)
    assert ((ji == i) | amb).all()
    np.testing.assert_allclose(s, js, **TOL)
