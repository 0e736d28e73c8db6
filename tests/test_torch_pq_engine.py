"""``fcvi.query`` and the serving engine over a residual-PQ index, against
the JAX package's.

Both packages serve the same PQ state (the JAX package builds it, the port
loads it with ``index_from_state``) and get the same calls: partial
batches, escalation to k' = 320 in power-of-two sub-batches, cache hits, a
pending delta tier and compaction. The JAX engine runs its plain path (and
``fcvi.query`` also its Pallas path in interpret mode); the kernels' parity
is held in ``test_torch_pq_kernels.py``. PQ always takes the id-gather step,
in both packages, so ``gather_free`` True and False give the same results
and the delta tier scans ids only. A query at a candidate near-tie (its
k'-th and (k'+1)-th ADC scores within the L2 tolerance, at k' = 80 or 320)
may get candidate sets that differ by one row from the two packages'
rounding; such queries (4 of the 70 here) are left out of the
comparisons. The fixed seeds put no query within 1e-5 of the escalation
margin. Combined scores: atol 1e-5; ids equal outside near-ties.

Compaction re-trains PQ's k-means (``fcvi.extend`` rebuilds the backend, as
the reference does), and the packages' k-means draw from different
generators: after a compaction the port is held against itself (a fresh
seed-0 build of the same rows) and against the JAX engine on the JAX
package's post-compaction state handed across.
"""
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.serve import engine as jengine
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.index import pq
from repro_torch.serve import engine
from test_torch_support import (assert_topk_match, candidate_ties, tensor,
                                to_numpy_tree)

TOL = dict(rtol=0.0, atol=1e-5)
CFG = dict(backend="pq", pq_m=8, pq_ksub=32, pq_coarse=8)
N = 2500


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(n=N, d=32, n_categories=5, n_numeric=3,
                                    seed=2))
    q, fq = sample_queries(corpus, 70, seed=3)
    rng = np.random.default_rng(4)
    new_v = (corpus.vectors[rng.integers(0, N, 400)]
             + 0.1 * rng.normal(size=(400, 32))).astype(np.float32)
    new_f = corpus.filters[rng.integers(0, N, 400)]
    jidx = jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters), jfcvi.FCVIConfig(**CFG))
    return corpus, q, fq, new_v, new_f, jidx


def _port(jidx):
    return fcvi.index_from_state(fcvi.FCVIConfig(**CFG),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")


def _engines(jidx, **cfg):
    """(JAX engine, port engine) over the same PQ state and EngineConfig."""
    return (jengine.FCVIEngine(jidx, jengine.EngineConfig(**cfg)),
            engine.FCVIEngine(_port(jidx), engine.EngineConfig(**cfg),
                              device="cpu"))


def _ties(index, q, fq):
    """(b,) bool: the queries at a candidate near-tie at k' = 80 or 320."""
    qn, fqn = index.transform.normalize(tensor(q), tensor(fq))
    q_t = index.transform.apply_normalized(qn, fqn)
    ties = np.zeros(len(q), bool)
    for kp in (80, 320):
        ties |= candidate_ties(pq.search(index.backend, q_t, kp + 1)[0], kp)
    return ties


def _same_search(engines, q, fq, ties):
    (js, ji), (s, i) = (e.search(q, fq) for e in engines)
    assert s.dtype == np.float32 and i.dtype == np.int64
    keep = ~ties
    assert_topk_match(js[keep], ji[keep], s[keep], i[keep], **TOL)
    return s, i


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pq_query_matches_jax(data, use_pallas):
    _, q, fq, _, _, jidx = data
    idx = _port(jidx)
    assert isinstance(idx.backend, pq.PQIndex)
    assert idx.backend.codes.dtype == torch.uint8
    ties = _ties(idx, q, fq)
    assert ties.sum() == 4
    nq = 16 if use_pallas else 70       # interpret mode is slow
    vals, ids = fcvi.query(idx, tensor(q[:nq]), tensor(fq[:nq]), 10)
    jcfg = jfcvi.FCVIConfig(use_pallas=use_pallas, **CFG)
    jv, ji = jfcvi.query(dataclasses.replace(jidx, config=jcfg),
                         jnp.asarray(q[:nq]), jnp.asarray(fq[:nq]), 10)
    keep = ~ties[:nq]
    assert_topk_match(np.asarray(jv)[keep], np.asarray(ji)[keep],
                      vals.numpy()[keep], ids.numpy()[keep], **TOL)


@pytest.mark.parametrize("gather_free", [True, False])
def test_pq_search_cache_and_escalation_match_jax(data, gather_free):
    _, q, fq, _, _, jidx = data
    engines = _engines(jidx, batch_size=32, escalate_margin=0.05,
                       gather_free=gather_free)
    jeng, mine = engines
    ties = _ties(mine.index, q, fq)
    s, i = _same_search(engines, q, fq, ties)  # 70: the last batch has 6
    assert mine.stats.escalations == jeng.stats.escalations > 0
    assert mine.stats.scan_batches == jeng.stats.scan_batches == 3
    # the PQ bytes model: the code matrix and the coarse ids, per batch
    assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned
    be = mine.index.backend
    assert mine._batch_scan_bytes(2) == mine._batch_scan_bytes(32) == (
        N * 8 + N * 4) == be.codes.nbytes + be.coarse_ids.nbytes
    s2, i2 = _same_search(engines, q, fq, ties)  # all cache hits
    assert mine.stats.cache_hits == jeng.stats.cache_hits == 70
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(i2, i)


@pytest.mark.parametrize("gather_free", [True, False])
def test_pq_delta_tier_matches_jax(data, gather_free):
    """20 pending rows (all scored), then 320 (the delta scan: kd=80)."""
    _, q, fq, new_v, new_f, jidx = data
    engines = _engines(jidx, batch_size=32, escalate_margin=0.0,
                       compact_threshold=450, gather_free=gather_free)
    jeng, mine = engines
    ties = _ties(mine.index, q, fq)
    for lo, hi in [(0, 20), (20, 320)]:
        for e in engines:
            e.insert(new_v[lo:hi], new_f[lo:hi])
        assert mine.delta_size() == jeng.delta_size() == hi
        _, i = _same_search(engines, q, fq, ties)
        assert (i >= N).any()               # delta rows do surface
    assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned
    assert mine.stats.compactions == jeng.stats.compactions == 0


def test_pq_gather_free_takes_the_id_gather_step(data, monkeypatch):
    """With gather_free=True the PQ engine never reaches a rows scan (the
    delta tier's included), and its results equal gather_free=False's bit
    for bit."""
    _, q, fq, new_v, new_f, jidx = data

    def refuse(*args, **kwargs):
        raise AssertionError("PQ reached a rows scan")

    monkeypatch.setattr(engine.flat_mod, "search_rows", refuse)
    out = []
    for gather_free in (True, False):
        eng = engine.FCVIEngine(_port(jidx), engine.EngineConfig(
            batch_size=32, gather_free=gather_free), device="cpu")
        first = eng.search(q, fq)
        eng.insert(new_v[:300], new_f[:300])
        out.append((first, eng.search(q, fq)))
    for (a, b), (c, d) in zip(*out):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_pq_compaction_against_jax_state_and_own_rebuild(data):
    _, q, fq, new_v, new_f, jidx = data
    jeng, mine = _engines(jidx, batch_size=32, escalate_margin=0.0,
                          compact_threshold=300)
    for e in (jeng, mine):
        e.search(q[:8], fq[:8])
        e.insert(new_v[:300], new_f[:300])  # reaches the threshold
    assert mine.stats.compactions == jeng.stats.compactions == 1
    assert mine.index.size == jeng.index.size == N + 300

    # against itself: the re-trained backend is a fresh seed-0 build
    tfm = mine.index.transform
    fresh = fcvi.build_backend(
        tfm.apply_normalized(mine.index.vectors_n, mine.index.filters_n),
        mine.index.config)
    for name in ("codebooks", "codes", "coarse_centers", "coarse_ids"):
        assert torch.equal(getattr(fresh, name),
                           getattr(mine.index.backend, name)), name
    s, i = mine.search(q, fq)
    assert np.isfinite(s).all() and ((i >= 0) & (i < N + 300)).all()

    # against JAX: its post-compaction state handed across
    handed = engine.FCVIEngine(_port(jeng.index),
                               engine.EngineConfig(batch_size=32,
                                                   escalate_margin=0.0),
                               device="cpu")
    _same_search((jeng, handed), q, fq, _ties(handed.index, q, fq))


def test_pq_ignores_storage_dtype(data):
    """PQ stores codes: ``storage_dtype`` does not apply, as in the
    reference, and an unknown one still raises."""
    corpus = data[0]
    v, f = corpus.vectors[:600], corpus.filters[:600]
    base = fcvi.build(v, f, fcvi.FCVIConfig(**CFG), device="cpu")
    for dtype in ("bfloat16", "int8"):
        other = fcvi.build(v, f, fcvi.FCVIConfig(storage_dtype=dtype, **CFG),
                           device="cpu")
        assert torch.equal(other.backend.codes, base.backend.codes)
    with pytest.raises(ValueError, match="storage_dtype"):
        fcvi.build(v, f, fcvi.FCVIConfig(storage_dtype="fp8", **CFG),
                   device="cpu")
