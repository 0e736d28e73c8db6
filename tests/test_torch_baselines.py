"""The paper's query surfaces in the port against the JAX package: the
baselines (``BoxPredicate``, post-, pre- and hybrid filtering, the filtered
ground truth), ``fcvi.multi_probe_query`` and ``engine.search_predicate``
on handed-across state, the theory functions, ``psi_partition_inverse`` and
``tiled_filter``, the synthetic distribution shifts (bit-equal) and the
``core`` exports.

Tolerance: scores within rtol 1e-5 / atol 1e-4 for squared distances and
atol 1e-5 for combined scores; ids equal outside near-ties of the JAX
scores (``test_torch_support.assert_topk_match``). Every query's predicate
holds at least k rows, so no slot is empty.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

import repro.core as jcore
from repro.core import baselines as jbase
from repro.core import fcvi as jfcvi
from repro.core import theory as jtheory
from repro.core import transform as jtransform
from repro.data import synthetic as jsyn
from repro.index import flat as jflat
from repro.serve import engine as jengine
import repro_torch.core as core
from repro_torch.core import baselines, fcvi, theory, transform
from repro_torch.data import synthetic as syn
from repro_torch.index import flat
from repro_torch.serve import engine
from test_torch_support import (assert_topk_match, probe_ties, tensor,
                                to_numpy_tree)

L2 = dict(rtol=1e-5, atol=1e-4)
COS = dict(rtol=0.0, atol=1e-5)
INF = np.inf


@pytest.fixture(scope="module")
def corpus():
    spec = syn.CorpusSpec(n=3000, d=32, n_categories=4, n_numeric=4, seed=3)
    c = syn.make_corpus(spec)
    q, fq = syn.sample_queries(c, 24, seed=4)
    return c, q, fq


def _box(m, col, lo, hi):
    low = np.full(m, -INF, np.float32)
    high = np.full(m, INF, np.float32)
    low[col], high[col] = lo, hi
    return (baselines.BoxPredicate(low=torch.tensor(low),
                                   high=torch.tensor(high)),
            jbase.BoxPredicate(low=jnp.asarray(low), high=jnp.asarray(high)))


PREDS = {"price": (4, 0.3, 0.7), "narrow": (7, 0.30, 0.36),
         "category": (1, 0.5, 1.5)}


@pytest.mark.parametrize("r", list(range(1, 10)) + [33, 100])
def test_linspace_and_probes_bit_equal(r):
    np.testing.assert_array_equal(baselines.linspace01(r).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, r)))
    rng = np.random.default_rng(r)
    low = rng.normal(size=6).astype(np.float32)
    high = low + rng.random(6).astype(np.float32)
    low[0], high[1], low[2], high[2] = -INF, INF, -INF, INF
    mine = baselines.BoxPredicate(low=torch.tensor(low),
                                  high=torch.tensor(high)).probes(r)
    theirs = jbase.BoxPredicate(low=jnp.asarray(low),
                                high=jnp.asarray(high)).probes(r)
    assert mine.dtype == torch.float32 and mine.shape == (r, 6)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_box_predicate_mask_center_and_filter_query(corpus):
    c, _, _ = corpus
    m = c.filters.shape[1]
    for col, lo, hi in PREDS.values():
        mine, theirs = _box(m, col, lo, hi)
        np.testing.assert_array_equal(
            mine.mask(tensor(c.filters)).numpy(),
            np.asarray(theirs.mask(jnp.asarray(c.filters))))
        np.testing.assert_array_equal(mine.center().numpy(),
                                      np.asarray(theirs.center()))
        np.testing.assert_allclose(
            mine.to_filter_query(tensor(c.filters)).numpy(),
            np.asarray(theirs.to_filter_query(jnp.asarray(c.filters))),
            rtol=1e-6, atol=1e-6)


def _truth(c, q, jpred, k):
    vals, ids = jbase.ground_truth_filtered(
        jnp.asarray(c.vectors), jnp.asarray(c.filters), jnp.asarray(q),
        jpred, k)
    return np.asarray(vals), np.asarray(ids)


@pytest.mark.parametrize("pred", sorted(PREDS))
def test_ground_truth_filtered_matches_jax(corpus, pred):
    c, q, _ = corpus
    mine, theirs = _box(c.filters.shape[1], *PREDS[pred])
    jv, ji = _truth(c, q, theirs, 11)
    v, i = baselines.ground_truth_filtered(tensor(c.vectors),
                                           tensor(c.filters), tensor(q),
                                           mine, 10)
    assert i.dtype == torch.int32
    assert_topk_match(jv[:, :10], ji[:, :10], v.numpy(), i.numpy(), **L2,
                      next_vals=jv[:, 10])


@pytest.mark.parametrize("pred", sorted(PREDS))
def test_pre_filter_search_is_exact_and_matches_jax(corpus, pred):
    c, q, _ = corpus
    mine, theirs = _box(c.filters.shape[1], *PREDS[pred])
    v, i = baselines.pre_filter_search(flat.build(tensor(c.vectors)),
                                       tensor(c.filters), tensor(q), mine,
                                       10)
    jv, ji = jbase.pre_filter_search(jflat.build(jnp.asarray(c.vectors)),
                                     jnp.asarray(c.filters), jnp.asarray(q),
                                     theirs, 10)
    tv, ti = _truth(c, q, theirs, 11)
    assert_topk_match(np.asarray(jv), np.asarray(ji), v.numpy(), i.numpy(),
                      **L2)
    assert_topk_match(tv[:, :10], ti[:, :10], v.numpy(), i.numpy(), **L2,
                      next_vals=tv[:, 10])
    assert mine.mask(tensor(c.filters))[i.long()].all()


@pytest.mark.parametrize("oversample", [2, 10, 40])
@pytest.mark.parametrize("pred", sorted(PREDS))
def test_post_filter_search_matches_jax(corpus, pred, oversample):
    c, q, _ = corpus
    mine, theirs = _box(c.filters.shape[1], *PREDS[pred])
    v, i = baselines.post_filter_search(flat.build(tensor(c.vectors)),
                                        tensor(c.filters), tensor(q), mine,
                                        10, oversample)
    jv, ji = jbase.post_filter_search(jflat.build(jnp.asarray(c.vectors)),
                                      jnp.asarray(c.filters),
                                      jnp.asarray(q), theirs, 10,
                                      oversample)
    jv, ji = np.asarray(jv), np.asarray(ji)
    live = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(v.numpy()), live)
    # starved slots (-inf) carry arbitrary ids in both packages
    assert_topk_match(np.where(live, jv, -1e30), np.where(live, ji, -1),
                      np.where(live, v.numpy(), -1e30),
                      np.where(live, i.numpy(), -1), **L2)


@pytest.mark.parametrize("pred,threshold", [("price", 0.25), ("narrow", 0.25),
                                            ("price", 0.9)])
def test_hybrid_matches_jax_on_both_routes(corpus, pred, threshold):
    c, q, _ = corpus
    col = PREDS[pred][0]
    mine, theirs = _box(c.filters.shape[1], *PREDS[pred])
    h = baselines.build_hybrid(c.vectors, c.filters, key_dim=col,
                               n_segments=16, device="cpu")
    jh = jbase.build_hybrid(jnp.asarray(c.vectors), jnp.asarray(c.filters),
                            key_dim=col, n_segments=16)
    np.testing.assert_array_equal(h.perm.numpy(), np.asarray(jh.perm))
    np.testing.assert_array_equal(h.seg_starts.numpy(),
                                  np.asarray(jh.seg_starts))
    np.testing.assert_array_equal(h.seg_key_min, np.asarray(jh.seg_key_min))
    np.testing.assert_array_equal(h.seg_key_max, np.asarray(jh.seg_key_max))
    v, i = baselines.hybrid_search(h, tensor(q), mine, 10,
                                   pre_threshold=threshold)
    jv, ji = jbase.hybrid_search(jh, jnp.asarray(q), theirs, 10,
                                 pre_threshold=threshold)
    jv, ji = np.asarray(jv), np.asarray(ji)
    live = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(v.numpy()), live)
    assert_topk_match(np.where(live, jv, -1e30), np.where(live, ji, -1),
                      np.where(live, v.numpy(), -1e30),
                      np.where(live, i.numpy(), -1), **L2)
    # ids come back in the original numbering
    ok = torch.tensor(live)
    assert mine.mask(tensor(c.filters))[i[ok].long()].all()


MP_CONFIGS = {"flat": dict(alpha=2.0, lam=0.4, c=16.0),
              "cluster": dict(mode="cluster", n_clusters=6),
              "ivf": dict(backend="ivf", nlist=16, nprobe=6)}


def _indexes(c, name):
    jidx = jfcvi.build(jnp.asarray(c.vectors), jnp.asarray(c.filters),
                       jfcvi.FCVIConfig(**MP_CONFIGS[name]))
    mine = fcvi.index_from_state(fcvi.FCVIConfig(**MP_CONFIGS[name]),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")
    return jidx, mine


def _probe_ties(index, q, probes):
    """(b,) bool: queries one of whose probes sits at an IVF probe
    near-tie."""
    if index.config.backend != "ivf":
        return np.zeros(len(q), bool)
    b, r, _ = probes.shape
    qn = index.transform.vec_norm.apply(tensor(q))
    fqn = index.transform.filt_norm.apply(tensor(probes))
    q_t = index.transform.apply_normalized(
        qn[:, None, :].expand(b, r, qn.shape[-1]), fqn).reshape(b * r, -1)
    return probe_ties(index.backend.centroids.numpy(), q_t.numpy(),
                      index.config.nprobe).reshape(b, r).any(-1)


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(MP_CONFIGS))
def test_multi_probe_query_matches_jax(corpus, name, r):
    c, q, _ = corpus
    jidx, mine = _indexes(c, name)
    _, theirs = _box(c.filters.shape[1], *PREDS["price"])
    probes = np.broadcast_to(np.asarray(theirs.probes(r))[None],
                             (len(q), r, c.filters.shape[1])).copy()
    v, i = fcvi.multi_probe_query(mine, tensor(q), tensor(probes), 10)
    jv, ji = jfcvi.multi_probe_query(jidx, jnp.asarray(q),
                                     jnp.asarray(probes), 10)
    keep = ~_probe_ties(mine, q, probes)
    assert keep.sum() >= 20
    assert_topk_match(np.asarray(jv)[keep], np.asarray(ji)[keep],
                      v.numpy()[keep], i.numpy()[keep], **COS)
    # no id twice in a row of the result
    ids = i.numpy()
    assert all(len(set(row)) == len(row) for row in ids)


def test_multi_probe_with_k_prime_and_pallas_reference(corpus):
    """The JAX side through its Pallas kernels in interpret mode at an
    explicit k' = 40, and a k' past the corpus (clamped to it by the
    port's scan) against the JAX plain path at k' = n."""
    import dataclasses

    c, q, _ = corpus
    jidx, mine = _indexes(c, "flat")
    _, theirs = _box(c.filters.shape[1], *PREDS["narrow"])
    probes = np.broadcast_to(np.asarray(theirs.probes(3))[None],
                             (4, 3, c.filters.shape[1])).copy()
    jpal = dataclasses.replace(jidx, config=dataclasses.replace(
        jidx.config, use_pallas=True))
    for jix, kp, jkp in ((jpal, 40, 40), (jidx, 5000, 3000)):
        v, i = fcvi.multi_probe_query(mine, tensor(q[:4]), tensor(probes),
                                      10, k_prime=kp)
        jv, ji = jfcvi.multi_probe_query(jix, jnp.asarray(q[:4]),
                                         jnp.asarray(probes), 10,
                                         k_prime=jkp)
        assert_topk_match(np.asarray(jv), np.asarray(ji), v.numpy(),
                          i.numpy(), **COS)


@pytest.mark.parametrize("name", ["flat", "ivf"])
def test_search_predicate_matches_jax_engine(corpus, name):
    c, q, _ = corpus
    jidx, mine = _indexes(c, name)
    pm, pj = _box(c.filters.shape[1], *PREDS["price"])
    jeng = jengine.FCVIEngine(jidx, jengine.EngineConfig(multi_probe_r=3))
    eng = engine.FCVIEngine(mine, engine.EngineConfig(multi_probe_r=3),
                            device="cpu")
    jv, ji = jeng.search_predicate(q, pj)
    v, i = eng.search_predicate(q, pm)
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    assert v.shape == i.shape == (len(q), 10)
    probes = np.broadcast_to(np.asarray(pj.probes(3))[None],
                             (len(q), 3, c.filters.shape[1]))
    keep = ~_probe_ties(mine, q, probes)
    assert_topk_match(np.asarray(jv)[keep], np.asarray(ji)[keep],
                      v.numpy()[keep], i.numpy()[keep], **COS)


def test_theory_functions_match_jax():
    rng = np.random.default_rng(9)
    va, vb = (rng.normal(size=(5, 12)).astype(np.float32) for _ in range(2))
    fa, fb = (rng.normal(size=(5, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        theory.transformed_sq_distance(tensor(va), tensor(vb), tensor(fa),
                                       tensor(fb), 1.7).numpy(),
        np.asarray(jtheory.transformed_sq_distance(
            jnp.asarray(va), jnp.asarray(vb), jnp.asarray(fa),
            jnp.asarray(fb), 1.7)), rtol=1e-5, atol=1e-4)
    # Thm 5.1: the closed form equals the distance of the transformed rows
    direct = ((transform.psi_partition(tensor(va), tensor(fa), 1.7)
               - transform.psi_partition(tensor(vb), tensor(fb), 1.7)) ** 2
              ).sum(-1)
    np.testing.assert_allclose(
        theory.transformed_sq_distance(tensor(va), tensor(vb), tensor(fa),
                                       tensor(fb), 1.7).numpy(),
        direct.numpy(), rtol=1e-4, atol=1e-4)
    for d_v, delta_f, d, m in [(0.5, 2.0, 32, 4), (3.0, 0.5, 32, 4),
                               (1.0, 1.0, 16, 8), (0.1, 5.0, 128, 8)]:
        mine = theory.alpha_star(d_v, delta_f, d, m)
        theirs = np.asarray(jtheory.alpha_star(d_v, delta_f, d, m))
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-6)
        for alpha in (1.0, 2.5):
            np.testing.assert_allclose(
                theory.separation_margin(d_v, delta_f, d, m, alpha).numpy(),
                np.asarray(jtheory.separation_margin(d_v, delta_f, d, m,
                                                     alpha)),
                rtol=1e-6, atol=1e-6)
    dv_t = tensor(np.array([0.5, 3.0], np.float32))
    df_t = tensor(np.array([2.0, 0.5], np.float32))
    np.testing.assert_allclose(
        theory.alpha_star(dv_t, df_t, 32, 4).numpy(),
        np.asarray(jtheory.alpha_star(jnp.asarray(dv_t.numpy()),
                                      jnp.asarray(df_t.numpy()), 32, 4)),
        rtol=1e-6)
    f = rng.normal(size=(20, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 20)
    for lab in (None, labels):
        mine = theory.cluster_stats(
            tensor(f), None if lab is None else torch.tensor(lab))
        theirs = jtheory.cluster_stats(
            jnp.asarray(f), None if lab is None else jnp.asarray(lab))
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)


def test_partition_inverse_and_tiled_filter_match_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(2, 7, 20)).astype(np.float32)
    f = rng.normal(size=(2, 7, 5)).astype(np.float32)
    t = transform.psi_partition(tensor(v), tensor(f), 2.5)
    back = transform.psi_partition_inverse(t, tensor(f), 2.5)
    np.testing.assert_allclose(back.numpy(), v, atol=1e-5)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jtransform.psi_partition_inverse(
            jnp.asarray(t.numpy()), jnp.asarray(f), 2.5)))
    tiled = transform.tiled_filter(tensor(f), 20)
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(jtransform.tiled_filter(jnp.asarray(f),
                                                          20)))
    np.testing.assert_allclose(t.numpy(), (tensor(v) - 2.5 * tiled).numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="d % m"):
        transform.tiled_filter(tensor(f), 21)


def _same_corpus(a, b):
    for field in ("vectors", "filters", "vec_labels", "cat_labels"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_shifts_bit_equal(seed):
    kw = dict(n=900, d=16, n_vec_clusters=8, n_categories=6, n_numeric=2,
              seed=seed)
    mine = syn.make_corpus(syn.CorpusSpec(**kw))
    theirs = jsyn.make_corpus(jsyn.CorpusSpec(**kw))
    _same_corpus(syn.shift_filter_distribution(mine, seed=seed + 7),
                 jsyn.shift_filter_distribution(theirs, seed=seed + 7))
    _same_corpus(syn.shift_vector_distribution(mine, 0.3, seed=seed + 8),
                 jsyn.shift_vector_distribution(theirs, 0.3, seed=seed + 8))
    for a, b in zip(syn.shifted_query_pattern(mine, 30, seed=seed + 9),
                    jsyn.shifted_query_pattern(theirs, 30, seed=seed + 9)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_core_exports_the_reference_names():
    assert len(jcore.__all__) == 23
    assert set(jcore.__all__) <= set(core.__all__)
    assert set(core.__all__) - set(jcore.__all__) == {"index_state",
                                                      "index_from_state"}
    for name in core.__all__:
        assert getattr(core, name) is not None
    assert core.theory.alpha_star is theory.alpha_star
