"""The port's index and query path against the JAX package's.

The state handoff is the anchor: the JAX package builds an index,
``repro.core.fcvi.index_state`` exports it, the port loads it with
``repro_torch.core.fcvi.index_from_state``, and both answer the same
queries, so no difference in fitting enters the comparison. The port's own
``build`` from the same numpy corpus is held against the JAX ``build``
(normalizers and transformed corpus within 1e-5). Combined scores: atol
1e-5; ids equal outside near-ties.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.data.synthetic import CorpusSpec as JSpec
from repro.data.synthetic import make_corpus as j_make_corpus
from repro.data.synthetic import sample_queries as j_sample_queries
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from test_torch_support import assert_topk_match, tensor, to_numpy_tree

TOL = dict(rtol=0.0, atol=1e-5)
SPEC = dict(n=3000, d=64, n_categories=5, n_numeric=3, seed=2)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(**SPEC))
    q, fq = sample_queries(corpus, 20, seed=3)
    return corpus, q, fq


def _jax_index(corpus, use_pallas=False, **cfg):
    return jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters),
                       jfcvi.FCVIConfig(use_pallas=use_pallas, **cfg))


def _port_from(jidx, **cfg):
    return fcvi.index_from_state(fcvi.FCVIConfig(**cfg),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")


def test_synthetic_copy_matches_jax_draw_for_draw():
    mine = make_corpus(CorpusSpec(n=500, d=16, seed=7))
    theirs = j_make_corpus(JSpec(n=500, d=16, seed=7))
    for name in ("vectors", "filters", "vec_labels", "cat_labels"):
        np.testing.assert_array_equal(getattr(mine, name),
                                      getattr(theirs, name))
    for a, b in zip(sample_queries(mine, 9, seed=4),
                    j_sample_queries(theirs, 9, seed=4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cfg", [dict(), dict(lam=0.6, c=16.0),
                                 dict(alpha=2.0, mode="embedding")])
def test_query_from_jax_state_matches_jax(data, use_pallas, cfg):
    corpus, q, fq = data
    jidx = _jax_index(corpus, use_pallas, **cfg)
    idx = _port_from(jidx, **cfg)
    vals, ids = fcvi.query(idx, tensor(q), tensor(fq), 10)
    jv, ji = jfcvi.query(jidx, jnp.asarray(q), jnp.asarray(fq), 10)
    assert_topk_match(jv, ji, vals, ids, **TOL)


def test_cluster_mode_serves_handed_over_centers(data):
    corpus, q, fq = data
    jidx = _jax_index(corpus, mode="cluster", n_clusters=6)
    idx = _port_from(jidx, mode="cluster")
    np.testing.assert_array_equal(idx.transform.centers.numpy(),
                                  np.asarray(jidx.transform.centers))
    vals, ids = fcvi.query(idx, tensor(q), tensor(fq), 10)
    jv, ji = jfcvi.query(jidx, jnp.asarray(q), jnp.asarray(fq), 10)
    assert_topk_match(jv, ji, vals, ids, **TOL)
    # the port now fits cluster mode itself: n_clusters centers of the
    # normalized filters, each the mean of its members
    own = fcvi.build(corpus.vectors, corpus.filters,
                     fcvi.FCVIConfig(mode="cluster", n_clusters=6),
                     device="cpu")
    assert own.transform.centers.shape == (6, corpus.filters.shape[1])
    assert torch.isfinite(own.transform.centers).all()


@pytest.mark.parametrize("cfg", [dict(), dict(alpha=2.0, mode="embedding"),
                                 dict(normalize=False, auto_alpha=True,
                                      lam=0.2)])
def test_build_matches_jax_build(data, cfg):
    corpus, q, fq = data
    idx = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(**cfg),
                     device="cpu")
    jidx = _jax_index(corpus, **cfg)
    close = dict(rtol=1e-5, atol=1e-5)
    assert idx.transform.alpha == pytest.approx(float(jidx.transform.alpha))
    for mine, theirs in [
            (idx.transform.vec_norm.mean, jidx.transform.vec_norm.mean),
            (idx.transform.vec_norm.std, jidx.transform.vec_norm.std),
            (idx.transform.filt_norm.mean, jidx.transform.filt_norm.mean),
            (idx.transform.filt_norm.std, jidx.transform.filt_norm.std),
            (idx.vectors_n, jidx.vectors_n), (idx.filters_n, jidx.filters_n),
            (idx.backend.vectors, jidx.backend.vectors)]:
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **close)
    np.testing.assert_allclose(idx.backend.sq_norms.numpy(),
                               np.asarray(jidx.backend.sq_norms), rtol=1e-5)
    vals, ids = fcvi.query(idx, tensor(q), tensor(fq), 10)
    jv, ji = jfcvi.query(jidx, jnp.asarray(q), jnp.asarray(fq), 10)
    assert_topk_match(jv, ji, vals, ids, rtol=1e-5, atol=1e-5)


def test_state_round_trip_and_norm_rematerialisation(data):
    corpus, q, fq = data
    idx = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(),
                     device="cpu")
    state = fcvi.index_state(idx)
    assert "sq_norms" not in state["backend"]   # derived, not stored
    back = fcvi.index_from_state(idx.config, state, device="cpu")
    assert torch.equal(back.backend.sq_norms, idx.backend.sq_norms)
    for a, b in [(back.vectors_n, idx.vectors_n),
                 (back.backend.vectors, idx.backend.vectors)]:
        assert torch.equal(a, b)
    # the port's own state loads in the JAX package too
    jidx = jfcvi.index_from_state(jfcvi.FCVIConfig(), to_numpy_tree(state))
    jv, ji = jfcvi.query(jidx, jnp.asarray(q), jnp.asarray(fq), 10)
    vals, ids = fcvi.query(back, tensor(q), tensor(fq), 10)
    assert_topk_match(jv, ji, vals, ids, **TOL)


def test_scoring_helpers_match_jax(data):
    corpus, q, fq = data
    jidx = _jax_index(corpus)
    idx = _port_from(jidx)
    qn, fqn = idx.transform.normalize(tensor(q), tensor(fq))
    jqn, jfqn = jidx.transform.normalize(jnp.asarray(q), jnp.asarray(fq))
    cand = np.random.default_rng(1).integers(0, SPEC["n"], (20, 50))
    cand = cand.astype(np.int32)
    np.testing.assert_allclose(
        fcvi.combined_score(idx.vectors_n[cand], idx.filters_n[cand], qn,
                            fqn, 0.5).numpy(),
        np.asarray(jfcvi.combined_score(jidx.vectors_n[cand],
                                        jidx.filters_n[cand], jqn, jfqn,
                                        0.5)), **TOL)
    vals, ids = fcvi.rescore(idx, qn, fqn, tensor(cand), 10)
    jv, ji = jfcvi.rescore(jidx, jqn, jfqn, jnp.asarray(cand), 10)
    assert_topk_match(jv, ji, vals, ids, **TOL)
    gv, gi = fcvi.ground_truth_combined(idx.vectors_n, idx.filters_n, qn,
                                        fqn, 10, 0.5)
    jgv, jgi = jfcvi.ground_truth_combined(jidx.vectors_n, jidx.filters_n,
                                           jqn, jfqn, 10, 0.5)
    assert_topk_match(jgv, jgi, gv, gi, **TOL)
    assert fcvi.recall_at_k(gi.numpy(), np.asarray(jgi)) == pytest.approx(
        float(jfcvi.recall_at_k(jnp.asarray(gi.numpy()), jgi)))
    assert fcvi.recall_at_k([[1, 2], [3, 4]], [[2, 9], [8, 7]]) == 0.25
    np.testing.assert_allclose(
        fcvi.cosine_sim(qn, qn.flip(0)).numpy(),
        np.asarray(jfcvi.cosine_sim(jqn, jqn[::-1])), **TOL)


def test_extend_matches_jax(data):
    corpus, q, fq = data
    jidx = _jax_index(corpus)
    idx = _port_from(jidx)
    rng = np.random.default_rng(5)
    nv = rng.normal(size=(50, 64)).astype(np.float32)
    nf = corpus.filters[:50]
    grown = fcvi.extend(idx, tensor(nv), tensor(nf))
    jgrown = jfcvi.extend(jidx, jnp.asarray(nv), jnp.asarray(nf))
    assert grown.size == jgrown.size == SPEC["n"] + 50
    np.testing.assert_allclose(grown.backend.vectors.numpy(),
                               np.asarray(jgrown.backend.vectors),
                               rtol=1e-5, atol=1e-5)
    vals, ids = fcvi.query(grown, tensor(q), tensor(fq), 10)
    jv, ji = jfcvi.query(jgrown, jnp.asarray(q), jnp.asarray(fq), 10)
    assert_topk_match(jv, ji, vals, ids, **TOL)


@pytest.mark.parametrize("cfg,item", [(dict(backend="ivf",
                                            storage_dtype="int8"), "A6"),
                                      (dict(backend="pq"), "A9"),
                                      (dict(storage_dtype="int8"), "A6"),
                                      (dict(storage_dtype="bfloat16"), "A6")])
def test_later_slices_refuse_by_roadmap_item(data, cfg, item):
    corpus, _, _ = data
    with pytest.raises(NotImplementedError, match=item):
        fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(**cfg),
                   device="cpu")
    with pytest.raises(ValueError):
        fcvi.FCVIConfig(backend="hnsw").check_supported()
