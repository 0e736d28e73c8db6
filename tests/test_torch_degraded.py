"""Degraded serving on the port's engine: shard loss, stragglers, heal.

With shards marked dead on an 8-shard CPU mesh the engine serves every
query; the results equal, bit for bit, a meshless search over the
surviving rows (``faultinject.surviving_reference``: flat dead rows at a
+inf squared norm, IVF dead lists emptied); no dead row surfaces; and the
coverage certificate never under-flags: a query whose HEALTHY top-k held a
dead row is flagged (it may over-flag). Flat (cluster routed and dense,
contiguous) and IVF (balanced routed and dense, affinity routed), one and
two dead shards, deaths one after another, a live delta tier, fp32 and
int8. Also: the health layer's policies (straggler eviction with its
small-fleet bound, recovery, heartbeat timeouts) and the restart plans
against the reference's, the straggler-eviction flow end to end, retries
within and beyond the budget, backpressure, deadline counts, poisoned
inputs, corrupt checkpoints, predicate search while degraded, and
``heal`` in the foreground and on a thread, back to full coverage and
bit-equal to a meshless engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import CheckpointCorruptError, load
from repro_torch.core import fcvi
from repro_torch.core.filters import F, compile_predicate
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.distributed import fault
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import faultinject as fi
from repro_torch.serve.engine import EngineConfig, FCVIEngine
from repro_torch.serve.health import (BackpressureError, ShardHealth,
                                      TransientShardError)
from test_torch_support import one_thread  # noqa: F401  (autouse)

SPEC = dict(n=3000, d=64, n_categories=5, n_numeric=3, seed=11)
BACKEND = {"flat": dict(), "ivf": dict(backend="ivf", nlist=16, nprobe=4)}
ENGINE = dict(batch_size=16, escalate_margin=0.1, retry_backoff_s=0.0)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(**SPEC))
    q, fq = sample_queries(corpus, 32, seed=12)
    return corpus, q, fq


_BUILT = {}


def _index(data, backend, storage="float32"):
    if (backend, storage) not in _BUILT:
        corpus = data[0]
        _BUILT[backend, storage] = fcvi.build(
            corpus.vectors, corpus.filters,
            fcvi.FCVIConfig(lam=0.6, c=8.0, storage_dtype=storage,
                            **BACKEND[backend]), device="cpu")
    return _BUILT[backend, storage]


def _engine(data, backend, placement, routing, storage="float32", n=8,
            **kw):
    return FCVIEngine(_index(data, backend, storage),
                      EngineConfig(**dict(ENGINE, **kw)), device="cpu",
                      mesh=make_mesh((n, 1), ("data", "model"), device="cpu"),
                      placement=placement, routing=routing)


def _same(a, b):
    np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(b[0], a[0])


def _check_degraded(eng, q, fq, dead):
    """Healthy search, mark ``dead``, degraded search: equal to the
    surviving reference, no dead row, coverage never under-flagged.
    Returns (affected queries, flagged queries)."""
    s_h, i_h = eng.search(q, fq)
    assert eng.stats.last_coverage.all()
    eng.health.mark_dead(dead)
    got = eng.search(q, fq)
    cov = eng.stats.last_coverage.copy()
    _same(fi.surviving_reference(eng).search(q, fq), got)
    mask = fi.surviving_row_mask(eng)
    n = eng.index.size
    i_d = got[1]
    # no dead row surfaces; id 0 on a dead row 0 can only be an unfilled
    # slot (the meshless id-0 convention, when every list a query probes
    # is dead), which the surviving reference returns too
    ok = mask[np.minimum(i_d, n - 1)] | (i_d >= n) | ((i_d == 0) & ~mask[0])
    assert ok.all()
    affected = np.array([(~mask[row[row < n]]).any() for row in i_h])
    assert not (affected & cov).any(), "a coverage flag missed a query"
    assert eng.stats.degraded_batches > 0
    return int(affected.sum()), int((~cov).sum())


COMBOS = [("flat", "cluster", "routed"), ("flat", "cluster", "dense"),
          ("flat", "contiguous", "dense"), ("ivf", "balanced", "routed"),
          ("ivf", "balanced", "dense"), ("ivf", "affinity", "routed")]


@pytest.mark.parametrize("dead", [[2], [1, 6]])
@pytest.mark.parametrize("backend,placement,routing", COMBOS)
def test_dead_shards_bit_equal_to_surviving_reference(data, backend,
                                                      placement, routing,
                                                      dead):
    _, q, fq = data
    eng = _engine(data, backend, placement, routing)
    affected, flagged = _check_degraded(eng, q, fq, dead)
    assert flagged >= affected
    assert eng.stats.coverage_rate < 1.0 or affected == 0


@pytest.mark.parametrize("backend,placement", [("flat", "cluster"),
                                               ("ivf", "balanced")])
def test_incremental_death_and_int8(data, backend, placement):
    _, q, fq = data
    eng = _engine(data, backend, placement, "routed", storage="int8")
    eng.search(q, fq)
    for dead in ([1], [6], [0]):
        eng.health.mark_dead(dead)
        _same(fi.surviving_reference(eng).search(q, fq), eng.search(q, fq))
    assert eng.health.dead_shards() == [0, 1, 6]
    assert eng._sharded.last_active <= 5


@pytest.mark.parametrize("backend,placement", [("flat", "cluster"),
                                               ("ivf", "affinity")])
def test_dead_shard_with_a_live_delta_tier(data, backend, placement):
    corpus, q, fq = data
    rng = np.random.default_rng(7)
    for nd in (20, 150):       # the delta taken whole; scanned per shard
        eng = _engine(data, backend, placement, "dense")
        rows = rng.integers(0, SPEC["n"], nd)
        eng.insert(corpus.vectors[rows] + 0.05 * rng.normal(
            size=(nd, SPEC["d"])).astype(np.float32), corpus.filters[rows])
        eng.search(q, fq)
        eng.health.mark_dead([4])
        s, i = eng.search(q, fq)
        ref = fi.surviving_reference(eng)
        assert ref.delta_size() == nd
        _same(ref.search(q, fq), (s, i))
        assert (i >= SPEC["n"]).any()
        # the delta tier lives on the live shards only
        assert eng._sharded_delta.shards[4] is None


def test_predicate_search_while_degraded(data):
    _, q, _ = data
    pred = F.eq("f1", 1.0) & F.range("f6", 0.0, 0.6)
    for backend, placement in (("flat", "cluster"), ("ivf", "balanced")):
        eng = _engine(data, backend, placement, "dense")
        healthy = eng.search(q, filter=pred)
        assert eng.stats.last_coverage.all()
        eng.health.mark_dead([3])
        got = eng.search(q, filter=pred)
        _same(fi.surviving_reference(eng).search(q, filter=pred,
                                                 plan="mask"), got)
        # a dead shard holding eligible rows flags every query
        assert not eng.stats.last_coverage.any()
        mask = fi.surviving_row_mask(eng)
        assert mask[got[1][got[1] >= 0]].all()
        assert not np.array_equal(got[1], healthy[1])
        # a fold choice runs the mask plan over the live shards
        broad = F.range("f6", 0.0, 0.9)
        if backend == "flat":
            assert eng.planner.choose(
                compile_predicate(broad, eng._attr_names)) == "fold"
        _same(fi.surviving_reference(eng).search(q, filter=broad,
                                                 plan="mask"),
              eng.search(q, filter=broad))


def _poison_block(eng, s):
    """Swap shard ``s``'s block for meta tensors of the same shapes: any
    step that reads them (an op beside the live tensors, a copy out) then
    raises, as a lost card would."""
    slab = eng._sharded.slab
    sh = slab.shards[s]
    meta = {f.name: getattr(sh, f.name).to("meta")
            for f in dataclasses.fields(sh)
            if isinstance(getattr(sh, f.name), torch.Tensor)}
    shards = list(slab.shards)
    shards[s] = dataclasses.replace(sh, **meta)
    object.__setattr__(slab, "shards", tuple(shards))


@pytest.mark.parametrize("backend,placement,routing",
                         [("flat", "cluster", "routed"),
                          ("flat", "contiguous", "dense"),
                          ("ivf", "balanced", "routed")])
def test_degraded_serving_never_reads_a_dead_shard(data, backend, placement,
                                                   routing):
    corpus, q, fq = data
    eng = _engine(data, backend, placement, routing)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, SPEC["n"], 40)
    eng.insert(corpus.vectors[rows], corpus.filters[rows])
    eng.health.mark_dead([3])
    ref = fi.surviving_reference(eng)
    _poison_block(eng, 3)
    _same(ref.search(q, fq), eng.search(q, fq))
    pred = F.eq("f1", 1.0) & F.range("f6", 0.0, 0.6)
    plans = ["mask", "routed"] if backend == "ivf" else ["mask"]
    for plan in plans:
        _same(ref.search(q, filter=pred, plan="mask"),
              eng.search(q, filter=pred, plan=plan))
        assert not eng.stats.last_coverage.any()
    # a fold choice runs the mask plan over the live shards
    broad = F.range("f6", 0.0, 0.9)
    _same(ref.search(q, filter=broad, plan="mask"),
          eng.search(q, filter=broad))


def test_heal_restores_full_coverage(data, tmp_path):
    _, q, fq = data
    for j, (placement, routing) in enumerate([("cluster", "routed"),
                                              ("contiguous", "dense")]):
        eng = _engine(data, "flat", placement, routing)
        eng.health.mark_dead([3])
        eng.search(q, fq)
        assert not eng.stats.last_coverage.all()
        assert eng.heal(str(tmp_path / str(j)), q, fq) is True
        assert eng._sharded.n_shards == 7 and eng._mesh.size == 7
        assert eng.stats.heals == 1 and not eng.health.any_dead()
        got = eng.search(q, fq)
        assert eng.stats.last_coverage.all()
        meshless = FCVIEngine(_index(data, "flat"), EngineConfig(**ENGINE),
                              device="cpu")
        _same(meshless.search(q, fq), got)
        assert eng._routing == routing and eng._placement == placement


def test_heal_on_a_background_thread(data, tmp_path):
    corpus, q, fq = data
    eng = _engine(data, "ivf", "balanced", "dense")
    eng.insert(corpus.vectors[:10] + 0.01, corpus.filters[:10])
    eng.health.mark_dead([0])
    eng.search(q, fq)
    t = eng.heal(str(tmp_path), q, fq, background=True)
    t.join(timeout=300)
    assert not t.is_alive()
    assert eng.stats.heals == 1 and eng._sharded.n_shards == 7
    assert eng.delta_size() == 10
    eng.search(q, fq)
    assert eng.stats.last_coverage.all()
    with pytest.raises(RuntimeError, match="sharded"):
        FCVIEngine(_index(data, "flat"), device="cpu").heal(str(tmp_path))


def test_straggler_eviction_to_degraded_serving(data):
    _, q, fq = data
    eng = _engine(data, "flat", "cluster", "routed", straggler_z=2.0)
    eng.fault_injector = fi.FaultInjector(slow_shards={5: 10.0})
    rng = np.random.default_rng(1)
    for _ in range(6):
        eng.search(q + rng.normal(size=q.shape).astype(np.float32) * 0.01,
                   fq)
    assert eng.health.dead_shards() == [5]
    assert eng.stats.straggler_evictions == 1
    _same(fi.surviving_reference(eng).search(q, fq), eng.search(q, fq))


# -- the resilience envelope ----------------------------------------------------

def test_retries_backpressure_deadline_and_healthy_coverage(data):
    _, q, fq = data
    eng = _engine(data, "flat", "contiguous", "dense")
    want = eng.search(q, fq)
    assert eng.stats.last_coverage.all() and eng.stats.coverage_rate == 1.0
    assert eng.stats.degraded_batches == 0
    eng._cache.clear()
    eng.fault_injector = fi.FaultInjector(transient_failures=2)
    _same(want, eng.search(q, fq))
    assert eng.stats.retries == 2 and eng.fault_injector.injected == 2
    eng._cache.clear()
    eng.fault_injector = fi.FaultInjector(transient_failures=10)
    with pytest.raises(TransientShardError):
        eng.search(q, fq)
    assert eng.stats.retries == 2 + eng.cfg.max_retries + 1
    eng.fault_injector = None
    eng.cfg.queue_budget = 2
    with pytest.raises(BackpressureError):
        eng.search(q, fq)
    assert eng.stats.backpressure_drops == len(q)
    eng.cfg.queue_budget = 0
    eng.cfg.deadline_s = 1e-9
    eng.search(q, fq)                       # recovers once the budget lifts
    assert eng.stats.deadline_misses == 2   # two batches of 16, both late


def test_poisoned_inputs_rejected(data):
    _, q, fq = data
    eng = _engine(data, "flat", "contiguous", "dense")
    for name, bad_q, bad_f in fi.poisoned_inputs(q.shape[1], fq.shape[1]):
        with pytest.raises(ValueError):
            eng.search(bad_q, bad_f)
    s, _ = eng.search(q, fq)
    assert np.isfinite(s).all()


@pytest.mark.parametrize("mode", ["truncate", "flip", "erase_manifest"])
def test_corrupt_checkpoint_detected(data, tmp_path, mode):
    eng = _engine(data, "flat", "cluster", "dense")
    eng.save(str(tmp_path), step=1)
    fi.corrupt_checkpoint(str(tmp_path), 1, mode)
    with pytest.raises(CheckpointCorruptError):
        load(str(tmp_path), step=1)


# -- the health layer's policies ----------------------------------------------

def test_shard_health_straggler_eviction_and_small_fleet_bound():
    h = ShardHealth(4, straggler_z=1.4, straggler_patience=3)
    evicted = []
    for _ in range(6):
        evicted += h.record_batch([0.01, 0.01, 0.01, 0.2])
    assert evicted == [3] and h.dead_shards() == [3]
    assert h.alive_mask().tolist() == [True, True, True, False]
    assert h.n_alive() == 3 and h.any_dead()
    # one outlier among 8 reaches z = 7 / sqrt(8) ~ 2.47 at most: a
    # threshold of 3.0 never evicts it, 2.0 does
    for z, want in ((3.0, []), (2.0, [5])):
        h = ShardHealth(8, straggler_z=z)
        ev = []
        for _ in range(6):
            ev += h.record_batch([1.0 if s == 5 else 0.01 for s in range(8)])
        assert ev == want


def test_shard_health_recovery_timeout_and_dead_shards_skipped():
    h = ShardHealth(4, alpha=1.0, straggler_z=1.4, straggler_patience=3)
    slow, fast = [0.01, 0.01, 0.01, 0.2], [0.01] * 4
    ev = []
    for times in [slow, slow, slow, fast, slow, slow, fast]:
        ev += h.record_batch(times)       # never 3 slow checks in a row
    assert ev == [] and h.dead_shards() == []
    h = ShardHealth(3, timeout_steps=2)
    assert h.check_failures() == []
    for _ in range(4):
        h.record_batch([0.01, 0.01])      # shard 2 never heartbeats
    assert h.check_failures() == [2] and h.dead_shards() == [2]
    h.mark_alive([2])
    assert h.dead_shards() == []
    h = ShardHealth(2)
    h.mark_dead([1])
    h.record_batch([0.01, 0.01])          # must not resurrect shard 1
    assert h.dead_shards() == [1]


def test_restart_plans_match_the_reference():
    jfault = pytest.importorskip("repro.distributed.fault")

    def fields(plan):
        return None if plan is None else dataclasses.asdict(plan)

    for args in [(14, 2, (8, 2), [3]), (255, 16, (16, 16), [1, 7]),
                 (511, 16, (2, 16, 16), [0]), (1, 2, (2, 2), [0, 1])]:
        for pods in (1, 2):
            assert fields(fault.plan_restart(*args, pods=pods)) == \
                fields(jfault.plan_restart(*args, pods=pods))
    assert fault.reassign_microbatches(10, [5, 1, 3]) == \
        jfault.reassign_microbatches(10, [5, 1, 3])
