"""The port's serving engine over an IVF index, against the JAX package's.

Both engines serve the same IVF state (the JAX package builds it, the port
loads it with ``index_from_state``) and get the same calls: partial
batches, escalation, cache hits, a pending delta tier, and both step
variants (``gather_free`` True: the IVF rows scan carries the re-rank rows;
False: they are gathered by id). The JAX engine runs its plain path; the
kernels' parity is held in ``test_torch_ivf_kernels.py``. The fixed seeds
put no query at a probe near-tie (asserted) and none within 1e-5 of the
escalation margin, so both engines probe the same lists and escalate the
same queries. Combined scores: atol 1e-5; ids equal outside near-ties.

Compaction re-trains the IVF k-means (``fcvi.extend`` rebuilds the
backend, as the reference does), and the two packages' k-means draw from
different generators. So after a compaction the port is held against the
JAX engine on the JAX package's post-compaction state handed across, and
against itself: the compacted index equals a fresh build of the same rows
with the same (seed-0) generator.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.serve import engine as jengine
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.serve import engine
from test_torch_support import (assert_topk_match, probe_ties, tensor,
                                to_numpy_tree)

TOL = dict(rtol=0.0, atol=1e-5)
CFG = dict(backend="ivf", nlist=16, nprobe=4)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(n=2500, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 70, seed=3)
    rng = np.random.default_rng(4)
    new_v = (corpus.vectors[rng.integers(0, 2500, 400)]
             + 0.1 * rng.normal(size=(400, 64))).astype(np.float32)
    new_f = corpus.filters[rng.integers(0, 2500, 400)]
    jidx = jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters), jfcvi.FCVIConfig(**CFG))
    return corpus, q, fq, new_v, new_f, jidx


def _port(jidx):
    return fcvi.index_from_state(fcvi.FCVIConfig(**CFG),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")


def _engines(jidx, **cfg):
    """(JAX engine, port engine) over the same IVF state and EngineConfig."""
    return (jengine.FCVIEngine(jidx, jengine.EngineConfig(**cfg)),
            engine.FCVIEngine(_port(jidx), engine.EngineConfig(**cfg),
                              device="cpu"))


def _no_probe_ties(index, q, fq):
    qn, fqn = index.transform.normalize(tensor(q), tensor(fq))
    q_t = index.transform.apply_normalized(qn, fqn)
    assert not probe_ties(index.backend.centroids.numpy(), q_t.numpy(),
                          index.config.nprobe).any()


def _same_search(engines, q, fq):
    (js, ji), (s, i) = (e.search(q, fq) for e in engines)
    assert s.dtype == np.float32 and i.dtype == np.int64
    assert_topk_match(js, ji, s, i, **TOL)
    return s, i


@pytest.mark.parametrize("gather_free", [True, False])
def test_ivf_search_cache_and_escalation_match_jax(data, gather_free):
    _, q, fq, _, _, jidx = data
    engines = _engines(jidx, batch_size=32, escalate_margin=0.05,
                       gather_free=gather_free)
    jeng, mine = engines
    _no_probe_ties(mine.index, q, fq)
    s, i = _same_search(engines, q, fq)     # 70 queries: the last batch has 6
    assert mine.stats.escalations == jeng.stats.escalations > 0
    assert mine.stats.scan_batches == jeng.stats.scan_batches == 3
    # the IVF bytes model: the probed share of the grouped slabs + centroids
    assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned
    be = mine.index.backend
    slab = be.grouped.nbytes + be.grouped_sq.nbytes
    assert mine._batch_scan_bytes(2) == slab * 8 // 16 + be.centroids.nbytes
    assert mine._batch_scan_bytes(32) == slab + be.centroids.nbytes
    s2, i2 = _same_search(engines, q, fq)   # all cache hits
    assert mine.stats.cache_hits == jeng.stats.cache_hits == 70
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(i2, i)
    assert (mine._grouped_payload is not None) == gather_free


@pytest.mark.parametrize("gather_free", [True, False])
def test_ivf_delta_tier_matches_jax(data, gather_free):
    """20 pending rows (all scored), then 320 (the delta scan: kd=80)."""
    _, q, fq, new_v, new_f, jidx = data
    engines = _engines(jidx, batch_size=32, escalate_margin=0.0,
                       compact_threshold=450, gather_free=gather_free)
    jeng, mine = engines
    for lo, hi in [(0, 20), (20, 320)]:
        for e in engines:
            e.insert(new_v[lo:hi], new_f[lo:hi])
        assert mine.delta_size() == jeng.delta_size() == hi
        _, i = _same_search(engines, q, fq)
        assert (i >= 2500).any()            # delta rows do surface
    assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned
    assert mine.stats.compactions == jeng.stats.compactions == 0


def test_ivf_compaction_against_jax_state_and_own_rebuild(data):
    _, q, fq, new_v, new_f, jidx = data
    jeng, mine = _engines(jidx, batch_size=32, escalate_margin=0.0,
                          compact_threshold=300)
    for e in (jeng, mine):
        e.search(q[:8], fq[:8])             # builds the grouped payloads
        e.insert(new_v[:300], new_f[:300])  # reaches the threshold
    assert mine.stats.compactions == jeng.stats.compactions == 1
    assert mine.index.size == jeng.index.size == 2800
    assert mine._grouped_payload is None    # stale slabs dropped

    # against itself: the re-trained backend is a fresh seed-0 build
    tfm = mine.index.transform
    fresh = fcvi.build_backend(
        tfm.apply_normalized(mine.index.vectors_n, mine.index.filters_n),
        mine.index.config)
    for name in ("centroids", "lists", "grouped", "valid"):
        assert torch.equal(getattr(fresh, name),
                           getattr(mine.index.backend, name)), name
    s, i = mine.search(q, fq)
    assert np.isfinite(s).all() and ((i >= 0) & (i < 2800)).all()
    assert mine._grouped_payload is not None

    # against JAX: its post-compaction state handed across
    handed = engine.FCVIEngine(_port(jeng.index),
                               engine.EngineConfig(batch_size=32,
                                                   escalate_margin=0.0),
                               device="cpu")
    _no_probe_ties(handed.index, q, fq)
    _same_search((jeng, handed), q, fq)


def test_ivf_engine_refusals_name_a6(data):
    corpus = data[0]
    for dtype in ("bfloat16", "int8"):
        with pytest.raises(NotImplementedError, match="A6"):
            fcvi.build(corpus.vectors, corpus.filters,
                       fcvi.FCVIConfig(storage_dtype=dtype, **CFG),
                       device="cpu")
