"""The port's meshless serving engine against the JAX package's.

Both engines serve the same index state (the JAX package builds it, the
port loads it through ``index_from_state``) and get the same calls: partial
batches, cache hits, inserts below and above ``compact_threshold``, an
explicit ``compact()``, escalation, and the same input errors. Combined
scores: atol 1e-5; ids equal outside near-ties. Escalation is a threshold
on each query's top-k margin; the fixed seeds here put no query's margin
within 1e-5 of ``escalate_margin``, so both engines escalate the same
queries and the counts must agree.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.serve import engine as jengine
from repro_torch.core import fcvi
from repro_torch.core.baselines import BoxPredicate
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.serve import engine
from repro_torch.serve.health import BackpressureError, TransientShardError
from test_torch_support import assert_topk_match, to_numpy_tree

TOL = dict(rtol=0.0, atol=1e-5)


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
                       jnp.asarray(corpus.filters), jfcvi.FCVIConfig())
    return corpus, q, fq, new_v, new_f, jidx


def _engines(jidx, **cfg):
    """(JAX engine, port engine) over the same state and EngineConfig. The
    JAX engine runs its plain path: the kernels' parity is held in
    ``test_torch_kernels.py``."""
    mine = engine.FCVIEngine(
        fcvi.index_from_state(fcvi.FCVIConfig(),
                              to_numpy_tree(jfcvi.index_state(jidx)),
                              device="cpu"),
        engine.EngineConfig(**cfg), device="cpu")
    return jengine.FCVIEngine(jidx, jengine.EngineConfig(**cfg)), mine


def _same_search(engines, q, fq):
    (js, ji), (s, i) = (e.search(q, fq) for e in engines)
    assert s.dtype == np.float32 and i.dtype == np.int64
    assert_topk_match(js, ji, s, i, **TOL)
    return s, i


@pytest.mark.parametrize("gather_free", [True, False])
def test_search_cache_and_escalation_match_jax(data, gather_free):
    _, q, fq, _, _, jidx = data
    engines = _engines(jidx, batch_size=32, escalate_margin=0.05,
                       gather_free=gather_free)
    s, i = _same_search(engines, q, fq)     # 70 queries: the last batch has 6
    jeng, mine = engines
    assert mine.stats.escalations == jeng.stats.escalations > 0
    assert mine.stats.scan_batches == jeng.stats.scan_batches == 3
    assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned
    s2, i2 = _same_search(engines, q, fq)   # all cache hits
    assert mine.stats.cache_hits == jeng.stats.cache_hits == 70
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(i2, i)
    assert mine.stats.queries == 140 and mine.stats.qps > 0


@pytest.mark.parametrize("gather_free", [True, False])
def test_delta_tier_and_compaction_match_jax(data, gather_free):
    """20 pending rows (all scored), 320 (the delta scan: kd=80 < 320), 480
    > compact_threshold (compaction), then an explicit compact(). No query
    escalates here (escalation is held by the test above), which keeps the
    JAX engine's compiles few."""
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
    assert mine.stats.compactions == jeng.stats.compactions == 0
    for e in engines:
        e.insert(new_v[320:], new_f[320:])  # 400 pending: still below
        e.insert(new_v[:80], new_f[:80])    # 480 pending: compacts
    assert mine.stats.compactions == jeng.stats.compactions == 1
    assert mine.index.size == jeng.index.size == 2980
    assert mine.delta_size() == 0
    _same_search(engines, q, fq)
    for e in engines:
        e.insert(new_v[:10], new_f[:10])
        e.compact()
    assert mine.stats.compactions == jeng.stats.compactions == 2
    assert mine.index.size == 2990
    _same_search(engines, q, fq)
    assert mine.stats.inserts == jeng.stats.inserts == 490


def _bad_inputs(q, fq):
    nan_q = q.copy()
    nan_q[0, 0] = np.nan
    inf_f = fq.copy()
    inf_f[1, 2] = np.inf
    big = q.copy()
    big[0, 0] = 1e19
    return [(nan_q, fq), (q, inf_f), (big, fq), (q[:0], fq[:0]),
            (q[:3], fq[:4]), (q[:, :60], fq), (q, fq[:, :7]), (q[0], fq[0])]


def test_input_errors_match_jax(data):
    _, q, fq, _, _, jidx = data
    engines = _engines(jidx)
    for bq, bf in _bad_inputs(q, fq):
        for e in engines:
            with pytest.raises(ValueError):
                e.search(bq, bf)
    for e in _engines(jidx, k=2501):
        with pytest.raises(ValueError, match="exceeds corpus"):
            e.search(q, fq)


def test_backpressure_matches_jax(data):
    _, q, fq, _, _, jidx = data
    engines = _engines(jidx, queue_budget=8)
    for e in engines:
        with pytest.raises(BackpressureError if e is engines[1]
                           else jengine.BackpressureError):
            e.search(q[:10], fq[:10])
        e.search(q[:8], fq[:8])             # within budget
        e.search(q[:10], fq[:10])           # 8 cached, 2 queued
    assert engines[1].stats.backpressure_drops == 10
    assert engines[0].stats.backpressure_drops == 10


class _Flaky:
    """Raises TransientShardError on the first ``fails`` batches."""

    def __init__(self, fails):
        self.fails = fails

    def before_batch(self):
        if self.fails:
            self.fails -= 1
            raise TransientShardError("injected")


def test_retry_and_deadline(data):
    _, q, fq, _, _, jidx = data
    _, mine = _engines(jidx, batch_size=32, retry_backoff_s=0.0,
                       deadline_s=1e-9)
    want = _engines(jidx, batch_size=32)[1].search(q, fq)
    mine.fault_injector = _Flaky(2)
    got = mine.search(q, fq)
    np.testing.assert_array_equal(got[1], want[1])
    assert mine.stats.retries == 2
    assert mine.stats.deadline_misses == 3
    mine.fault_injector = _Flaky(10)
    with pytest.raises(TransientShardError):
        mine.search(q[:1] + 1.0, fq[:1])
    assert mine.stats.retries == 2 + 3      # max_retries=2, then it raises


def test_later_slices_refuse_by_roadmap_item(data, tmp_path):
    _, q, fq, _, _, jidx = data
    _, mine = _engines(jidx)
    # predicate search (A7) is served now: what is not a predicate, and a
    # plan in similarity mode, are refused as the reference refuses them
    with pytest.raises(TypeError, match="not a predicate"):
        mine.search(q, filter=object())
    with pytest.raises(ValueError, match="plan= only applies"):
        mine.search(q, fq, plan="mask")
    # multi-probe (A11) and checkpoints (A10) are served now
    m = fq.shape[1]
    box = BoxPredicate(low=torch.full((m,), -np.inf),
                       high=torch.full((m,), np.inf))
    assert mine.search_predicate(q, box)[1].shape == (len(q), 10)
    mine.save(str(tmp_path))
    assert engine.FCVIEngine.restore(str(tmp_path),
                                     device="cpu").index.size == 2500
    # sharded serving (A12) is served now: what is not a mesh, routing
    # without one and heal() on a meshless engine are refused as the
    # reference refuses them
    for call, err, item in [
            (lambda: mine.heal("ckpt"), RuntimeError, "sharded engine"),
            (lambda: engine.FCVIEngine(mine.index, mesh=object(),
                                       device="cpu"), TypeError, "ShardMesh"),
            (lambda: engine.FCVIEngine(mine.index, device="cpu",
                                       routing="routed"), ValueError,
             "requires a device mesh"),
            (lambda: engine.FCVIEngine.restore(
                str(tmp_path), device="cpu", mesh=object()), TypeError,
             "ShardMesh")]:
        with pytest.raises(err, match=item):
            call()
    with pytest.raises(TypeError):
        mine.search(q)
