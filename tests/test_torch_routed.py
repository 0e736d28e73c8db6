"""Routed sharded serving on the port's engine (8 shards on the CPU).

``routing="routed"`` is a deployment knob: routed == dense-sharded ==
meshless, bit for bit, for flat (cluster placement: the ball-bound flag
and the dense fallback) and IVF (balanced and affinity: ownership of the
probed lists, exact), with a live delta tier and escalations. The JAX
package's routed flat step does not equal its own meshless result
(``tests/test_routed_serving.py::test_routed_eight_device_parity``), so the
port's routed flat is held to the port's own meshless engine here. Also:
forced fallbacks (queries midway between psi-clusters, one probed
cluster), the router counters and a skip rate above zero on localized
traffic, the signatures the dispatch sorts by against the step's route
mask, the routing tables' soundness, the refusals (PQ, no mesh, flat
without cluster placement), and predicate search over shards (the mask
and routed plans, forced plans, the delta tier, a zero-match predicate)
equal to the meshless engine.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fcvi
from repro_torch.core.clustering import assign
from repro_torch.core.filters import F
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.launch.mesh import ShardMesh, make_mesh
from repro_torch.serve.engine import EngineConfig, FCVIEngine
from test_torch_support import one_thread  # noqa: F401  (autouse)

SPEC = dict(n=3000, d=64, n_categories=5, n_numeric=3, seed=7)
BACKEND = {"flat": dict(), "ivf": dict(backend="ivf", nlist=16, nprobe=4)}
ENGINE = dict(batch_size=16, escalate_margin=0.1)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(**SPEC))
    q, fq = sample_queries(corpus, 40, seed=8)
    idx = {b: fcvi.build(corpus.vectors, corpus.filters,
                         fcvi.FCVIConfig(lam=0.6, c=8.0, **kw), device="cpu")
           for b, kw in BACKEND.items()}
    return corpus, q, fq, idx


def _mesh(n=8):
    return make_mesh((n, 1), ("data", "model"), device="cpu")


def _same(a, b):
    np.testing.assert_array_equal(b[1], a[1])
    np.testing.assert_array_equal(b[0], a[0])


def _engines(idx, placement, **kw):
    ek = dict(ENGINE, **kw)
    return (FCVIEngine(idx, EngineConfig(**ek), device="cpu"),
            FCVIEngine(idx, EngineConfig(**ek), device="cpu", mesh=_mesh(),
                       placement=placement, routing="dense"),
            FCVIEngine(idx, EngineConfig(**ek), device="cpu", mesh=_mesh(),
                       placement=placement, routing="routed"))


@pytest.mark.parametrize("gather_free", [True, False])
@pytest.mark.parametrize("backend,placement", [
    ("flat", "cluster"), ("ivf", "balanced"), ("ivf", "affinity")])
def test_routed_equals_dense_equals_meshless(data, backend, placement,
                                             gather_free):
    corpus, q, fq, idx = data
    e0, ed, er = _engines(idx[backend], placement, gather_free=gather_free)
    a, b, c = e0.search(q, fq), ed.search(q, fq), er.search(q, fq)
    _same(a, c)
    _same(b, c)
    rng = np.random.default_rng(0)
    nv = rng.normal(size=(100, SPEC["d"])).astype(np.float32)
    for e in (e0, ed, er):
        e.insert(nv, corpus.filters[:100])
    _same(e0.search(q, fq), er.search(q, fq))
    assert er.stats.routed_batches > 0 and ed.stats.routed_batches == 0
    assert er.stats.escalations == e0.stats.escalations > 0
    assert er.stats.shard_steps == 8 * er.stats.routed_batches
    if backend == "ivf":
        assert er.stats.router_fallbacks == 0        # exact by construction


def test_localized_traffic_skips_shards(data):
    """Queries around one corpus row with its own filter route to few
    shards: the skip rate is above zero, the results still equal."""
    corpus, _, _, idx = data
    rng = np.random.default_rng(7)
    for backend, placement in (("flat", "cluster"), ("ivf", "affinity")):
        e0, _, er = _engines(idx[backend], placement, router_nprobe=2)
        qq = (corpus.vectors[3] + 0.05 * rng.normal(size=(16, SPEC["d"]))
              ).astype(np.float32)
        ff = np.repeat(corpus.filters[3:4], 16, axis=0)
        _same(e0.search(qq, ff), er.search(qq, ff))
        assert er.stats.shard_skip_rate > 0.0, backend
        assert er.stats.shards_active < er.stats.shard_steps
        # far out-of-support filters still route somewhere and stay exact
        far = 25.0 * np.ones_like(ff)
        sig = er._sharded.route_signatures(qq, far)
        assert (np.unpackbits(sig, axis=1)[:, :8].sum(axis=1) >= 1).all()
        _same(e0.search(qq, far), er.search(qq, far))


def test_forced_fallbacks_stay_exact(data):
    """Queries midway between psi-clusters with one probed cluster set the
    clipping flag; flagged queries re-run dense, and the results equal."""
    corpus, _, _, idx = data
    e0, _, er = _engines(idx["flat"], "cluster", router_nprobe=1)
    rc = er._sharded.slab.router_centers.numpy()
    pairs = np.random.default_rng(3).integers(0, rc.shape[0], size=(16, 2))
    qm = torch.tensor((rc[pairs[:, 0]] + rc[pairs[:, 1]]) / 2)
    tfm = e0.index.transform
    q_raw = tfm.vec_norm.inverse(qm).numpy()
    f_raw = tfm.filt_norm.inverse(torch.zeros((16, corpus.filters.shape[1]))
                                  ).numpy()
    _same(e0.search(q_raw, f_raw), er.search(q_raw, f_raw))
    assert er.stats.router_fallbacks > 0


def test_signatures_match_the_route_mask_and_tables_are_sound(data):
    corpus, q, fq, idx = data
    _, _, er = _engines(idx["flat"], "cluster")
    sh = er._sharded
    qn, fqn = er.index.transform.normalize(torch.tensor(q), torch.tensor(fq))
    mask = sh.route_masks(er.index.transform.apply_normalized(qn, fqn))[0]
    np.testing.assert_array_equal(
        np.unpackbits(sh.route_signatures(q, fq), axis=1)[:, :8],
        mask.numpy())
    # every row's ACTUAL shard is in its cluster's incidence row
    slab = sh.slab
    labels = assign(er.index.backend.vectors.float(),
                    slab.router_centers).numpy()
    inc = slab.cluster_to_shard.numpy()
    pos = np.arange(SPEC["n"])
    assert (inc[labels[slab.perm], pos // slab.n_local] == 1.0).all()
    # every row lies inside its cluster's ball
    v = er.index.backend.vectors.float()
    dist = torch.linalg.vector_norm(
        v - slab.router_centers[torch.as_tensor(labels)], dim=-1)
    assert (dist <= slab.router_radii[torch.as_tensor(labels)]).all()


def test_routing_refusals_and_one_shard_mesh(data):
    corpus, q, fq, idx = data
    with pytest.raises(ValueError, match="requires a device mesh"):
        FCVIEngine(idx["flat"], device="cpu", routing="routed")
    with pytest.raises(ValueError, match="placement='cluster'"):
        FCVIEngine(idx["flat"], device="cpu", mesh=_mesh(),
                   routing="routed", placement="contiguous")
    with pytest.raises(ValueError, match="routing must be"):
        FCVIEngine(idx["flat"], device="cpu", mesh=_mesh(),
                   routing="sideways")
    with pytest.raises(TypeError, match="ShardMesh"):
        FCVIEngine(idx["flat"], device="cpu", mesh=object())
    pq_idx = fcvi.build(corpus.vectors[:500], corpus.filters[:500],
                        fcvi.FCVIConfig(backend="pq", pq_ksub=16,
                                        pq_coarse=4), device="cpu")
    with pytest.raises(ValueError, match="PQ backend"):
        FCVIEngine(pq_idx, device="cpu", mesh=_mesh(), routing="routed")
    # one shard: no routing tables, routing is a no-op
    e0 = FCVIEngine(idx["flat"], EngineConfig(**ENGINE), device="cpu")
    e1 = FCVIEngine(idx["flat"], EngineConfig(**ENGINE), device="cpu",
                    mesh=_mesh(1), placement="cluster", routing="routed")
    assert e1._sharded.slab.router_centers is None
    _same(e0.search(q, fq), e1.search(q, fq))
    assert e1.stats.routed_batches > 0 and e1.stats.shard_skip_rate == 0.0


def test_mesh_on_another_device_refused(data, tmp_path):
    corpus, q, fq, idx = data
    meta = np.empty((8, 1), dtype=object)
    meta[:] = torch.device("meta")
    mesh = ShardMesh(devices=meta, axis_names=("data", "model"))
    with pytest.raises(ValueError, match="engine's device"):
        FCVIEngine(idx["flat"], device="cpu", mesh=mesh)
    FCVIEngine(idx["flat"], device="cpu").save(str(tmp_path))
    with pytest.raises(ValueError, match="engine's device"):
        FCVIEngine.restore(str(tmp_path), device="cpu", mesh=mesh)


# -- predicate search over shards ---------------------------------------------

PREDS = {
    "broad": F.range("f5", 0.1, 0.9),
    "mid": F.eq("f1", 1.0) & F.range("f6", 0.0, 0.5),
    "narrow": F.eq("f0", 1.0) & F.range("f5", 0.0, 0.03),
    "none": F.range("f5", 5.0, 6.0),
}


@pytest.mark.parametrize("storage", ["float32", "int8"])
@pytest.mark.parametrize("backend,placement", [("flat", "cluster"),
                                               ("ivf", "balanced")])
def test_predicates_over_shards_equal_meshless(data, backend, placement,
                                               storage):
    corpus, q, _, _ = data
    idx = fcvi.build(corpus.vectors, corpus.filters,
                     fcvi.FCVIConfig(storage_dtype=storage,
                                     **BACKEND[backend]), device="cpu")
    e0 = FCVIEngine(idx, EngineConfig(), device="cpu")
    e1 = FCVIEngine(idx, EngineConfig(), device="cpu", mesh=_mesh(),
                    placement=placement)
    assert e1.planner.routed_capable()
    for name, pred in PREDS.items():
        want = e0.search(q, filter=pred)
        for plan in (None, "mask", "routed"):
            got = e1.search(q, filter=pred, plan=plan)
            _same(want, got)
        if name == "none":
            assert (got[1] == -1).all()
    assert e1.stats.plan_routed > 0 and e1.stats.plan_mask > 0
    rng = np.random.default_rng(5)
    nv = rng.normal(size=(40, SPEC["d"])).astype(np.float32)
    for e in (e0, e1):
        e.insert(nv, corpus.filters[:40])
    _same(e0.search(q, filter=PREDS["mid"]), e1.search(q, filter=PREDS["mid"]))


def test_routed_predicate_skips_shards_without_eligible_rows(data,
                                                            monkeypatch):
    """The routed plan scans only the shards holding an eligible row (one
    masked scan each), the mask plan every shard; both equal meshless."""
    from repro_torch.core.filters import compile_predicate, eval_mask
    from repro_torch.serve import sharded

    corpus, q, _, idx = data
    e0 = FCVIEngine(idx["flat"], EngineConfig(), device="cpu")
    e1 = FCVIEngine(idx["flat"], EngineConfig(), device="cpu", mesh=_mesh(),
                    placement="cluster")
    cp = compile_predicate(PREDS["narrow"], e1._attr_names)
    lo, hi, iv, ic = cp.as_arrays(e1.device)
    arrays = (lo, hi, iv[:, :1], ic)
    eligs, counts = e1._sharded.eligibility(arrays,
                                            eval_mask(e1._attrs, *arrays))
    # the counts come from the home table: each equals its block's own
    np.testing.assert_array_equal(counts, [int(e.sum()) for e in eligs])
    assert (counts == 0).any() and counts.sum() > 0
    scans = []
    real = sharded.ops.score_topk

    def counted(*args, **kw):
        scans.append(kw.get("mask") is not None)
        return real(*args, **kw)

    want = e0.search(q, filter=PREDS["narrow"])
    monkeypatch.setattr(sharded.ops, "score_topk", counted)
    _same(want, e1.search(q, filter=PREDS["narrow"], plan="routed"))
    assert scans == [True] * int((counts > 0).sum())
    scans.clear()
    _same(want, e1.search(q, filter=PREDS["narrow"], plan="mask"))
    assert scans == [True] * 8
