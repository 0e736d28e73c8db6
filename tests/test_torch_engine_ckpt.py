"""Engine checkpoints across the two packages, both ways.

An engine of one package serves an index built by the JAX package (the
port's over the same state handed across), a named raw attribute table and
pending delta rows; it saves; the other package's ``FCVIEngine.restore``
reads the checkpoint; the restored engine must answer as the writer does:
similarity search (combined scores within 1e-5, ids equal outside
near-ties) and, for flat and IVF, predicate search over the restored
attribute names. Flat fp32 and bf16, cluster mode, IVF int8 and PQ. A JAX
checkpoint that carries a routed engine's ``router|centers`` and
``routing: "routed"`` restores meshless. Queries at an IVF probe near-tie
or a PQ candidate near-tie are left out, as in the engine tests.
"""
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.checkpoint import ckpt as jckpt
from repro.core import fcvi as jfcvi
from repro.core import filters as jfilters
from repro.serve import engine as jengine
from repro_torch.checkpoint import ckpt
from repro_torch.core import fcvi, filters
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.index import pq
from repro_torch.serve import engine
from test_torch_support import (assert_topk_match, candidate_ties,
                                probe_ties, tensor, to_numpy_tree)

TOL = dict(rtol=0.0, atol=1e-5)
N, D = 1500, 32
NAMES = ["c0", "c1", "c2", "c3", "c4", "price", "rating", "age"]
CONFIGS = {
    "flat": dict(),
    "flat-bf16": dict(storage_dtype="bfloat16"),
    "cluster": dict(mode="cluster", n_clusters=6),
    "ivf-int8": dict(backend="ivf", nlist=12, nprobe=4, storage_dtype="int8"),
    "pq": dict(backend="pq", pq_m=8, pq_ksub=32, pq_coarse=6),
}
# no escalation: which queries escalate is a threshold test the engine
# tests hold; here the two engines must serve the same step
ENGINE = dict(escalate_margin=0.0, batch_size=32)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(n=N, d=D, n_categories=5, n_numeric=3,
                                    seed=6))
    q, fq = sample_queries(corpus, 40, seed=7)
    rng = np.random.default_rng(8)
    new_v = (corpus.vectors[rng.integers(0, N, 30)]
             + 0.1 * rng.normal(size=(30, D))).astype(np.float32)
    new_f = corpus.filters[rng.integers(0, N, 30)]
    jidx = {name: jfcvi.build(jnp.asarray(corpus.vectors),
                              jnp.asarray(corpus.filters),
                              jfcvi.FCVIConfig(**cfg))
            for name, cfg in CONFIGS.items()}
    return corpus, q, fq, new_v, new_f, jidx


def _jax_engine(data, name):
    corpus, _, _, new_v, new_f, jidx = data
    eng = jengine.FCVIEngine(jidx[name], jengine.EngineConfig(**ENGINE),
                             attributes=corpus.filters, attr_names=NAMES)
    eng.insert(new_v, new_f)
    return eng


def _port_engine(data, name):
    corpus, _, _, new_v, new_f, jidx = data
    index = fcvi.index_from_state(fcvi.FCVIConfig(**CONFIGS[name]),
                                  to_numpy_tree(jfcvi.index_state(jidx[name])),
                                  device="cpu")
    eng = engine.FCVIEngine(index, engine.EngineConfig(**ENGINE),
                            device="cpu", attributes=corpus.filters,
                            attr_names=NAMES)
    eng.insert(new_v, new_f)
    return eng


def _left_out(port_eng, q, fq):
    """(b,) bool: queries at an IVF probe near-tie or a PQ candidate
    near-tie at the step's k'."""
    index = port_eng.index
    qn, fqn = index.transform.normalize(tensor(q), tensor(fq))
    q_t = index.transform.apply_normalized(qn, fqn)
    if index.config.backend == "ivf":
        return probe_ties(index.backend.centroids.numpy(), q_t.numpy(),
                          index.config.nprobe)
    if index.config.backend == "pq":
        return candidate_ties(pq.search(index.backend, q_t, 81)[0], 80)
    return np.zeros(len(q), bool)


def _same_answers(jeng, port_eng, data):
    _, q, fq, _, _, _ = data
    keep = ~_left_out(port_eng, q, fq)
    assert keep.sum() >= 30
    (js, ji), (s, i) = jeng.search(q, fq), port_eng.search(q, fq)
    assert (i >= N).any()                      # the delta rows answer too
    assert_topk_match(js[keep], ji[keep], s[keep], i[keep], **TOL)
    if port_eng.index.config.backend == "pq":
        return
    (js, ji), (s, i) = (
        jeng.search(q, filter=jfilters.F.range("price", 0.2, 0.6)
                    & jfilters.F.eq("c1", 0.0)),
        port_eng.search(q, filter=filters.F.range("price", 0.2, 0.6)
                        & filters.F.eq("c1", 0.0)))
    np.testing.assert_allclose(s, js, rtol=1e-5, atol=1e-4)
    assert_topk_match(js, ji, s, i, rtol=1e-5, atol=1e-4)


def _same_state(a, b):
    """The serving state a restore must carry: configs, attribute table and
    names, pending rows and the insert count."""
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
    assert list(a._attr_names) == list(b._attr_names) == NAMES
    np.testing.assert_array_equal(a._attrs_np, b._attrs_np)
    assert a.delta_size() == b.delta_size() == 30
    assert a.stats.inserts == b.stats.inserts == 30
    np.testing.assert_array_equal(np.concatenate(a._delta_v),
                                  np.concatenate(b._delta_v))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_checkpoint_restores_in_the_port(tmp_path, data, name):
    jeng = _jax_engine(data, name)
    jeng.save(str(tmp_path), step=4)
    mine = engine.FCVIEngine.restore(str(tmp_path), device="cpu")
    assert mine.index.config == fcvi.FCVIConfig(**CONFIGS[name])
    _same_state(jeng, mine)
    _same_answers(jeng, mine, data)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_checkpoint_restores_in_jax(tmp_path, data, name):
    mine = _port_engine(data, name)
    mine.save(str(tmp_path), step=2)
    _, _, meta = ckpt.load(str(tmp_path))
    assert meta["serving"] == {"placement": "contiguous", "routing": "dense",
                               "attr_names": NAMES}
    jeng = jengine.FCVIEngine.restore(str(tmp_path))
    assert jeng.index.config == jfcvi.FCVIConfig(**CONFIGS[name])
    _same_state(jeng, mine)
    _same_answers(jeng, mine, data)
    # and back: the port restores its own checkpoint to the same answers
    again = engine.FCVIEngine.restore(str(tmp_path), device="cpu")
    s, i = mine.search(data[1], data[2])
    s2, i2 = again.search(data[1], data[2])
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(i2, i)


def test_routed_jax_checkpoint_restores_meshless(tmp_path, data):
    """A JAX checkpoint of a routed, cluster-placed engine (its tree holds
    ``router|centers``, its metadata ``routing: "routed"``) restores
    meshless in both packages, which ignore the router, and the port's
    answers equal the JAX engine's."""
    jeng = _jax_engine(data, "flat")
    jeng.save(str(tmp_path / "dense"), step=1)
    tree, _, meta = jckpt.load(str(tmp_path / "dense"))
    tree["router"] = {"centers": np.random.default_rng(0).normal(
        size=(16, D)).astype(np.float32)}
    meta["serving"].update(placement="cluster", routing="routed")
    jckpt.save(str(tmp_path / "routed"), 1, tree, metadata=meta)
    _, _, man = ckpt.load(str(tmp_path / "routed"))
    assert man["serving"]["routing"] == "routed"
    mine = engine.FCVIEngine.restore(str(tmp_path / "routed"), device="cpu")
    theirs = jengine.FCVIEngine.restore(str(tmp_path / "routed"))
    _same_state(theirs, mine)
    _same_answers(jeng, mine, data)


def test_configs_cross_both_ways():
    """Each package's configs take what the other writes: the port drops
    the JAX FCVIConfig's ``use_pallas`` (kernels follow the device) and
    refuses any other unknown field."""
    jf = dataclasses.asdict(jfcvi.FCVIConfig(use_pallas=True, nlist=7))
    assert engine._config_from(fcvi.FCVIConfig, jf, ignore=("use_pallas",)) \
        == fcvi.FCVIConfig(nlist=7)
    assert jfcvi.FCVIConfig(**dataclasses.asdict(fcvi.FCVIConfig(nlist=7))) \
        == jfcvi.FCVIConfig(nlist=7)
    je = dataclasses.asdict(jengine.EngineConfig(multi_probe_r=6))
    assert engine.EngineConfig(**je) == engine.EngineConfig(multi_probe_r=6)
    assert set(je) == {f.name for f in dataclasses.fields(engine.EngineConfig)}
    assert jengine.EngineConfig(**dataclasses.asdict(engine.EngineConfig()))
    with pytest.raises(ValueError, match="unknown fields"):
        engine._config_from(fcvi.FCVIConfig, dict(jf, shards=2),
                            ignore=("use_pallas",))


def test_restore_refuses_a_mesh_and_an_unknown_field(tmp_path, data):
    mine = _port_engine(data, "flat")
    mine.save(str(tmp_path), step=0)
    with pytest.raises(TypeError, match="ShardMesh"):
        engine.FCVIEngine.restore(str(tmp_path), device="cpu", mesh=object())
    # routing is forced dense meshless, as the reference does
    eng = engine.FCVIEngine.restore(str(tmp_path), device="cpu",
                                    routing="routed")
    assert eng.delta_size() == 30
    tree, _, meta = ckpt.load(str(tmp_path))
    meta["fcvi_config"]["shards"] = 4
    ckpt.save(str(tmp_path), 1, tree, metadata=meta)
    with pytest.raises(ValueError, match="shards"):
        engine.FCVIEngine.restore(str(tmp_path), device="cpu")


def test_restore_takes_a_config_and_a_step(tmp_path, data):
    mine = _port_engine(data, "flat")
    mine.save(str(tmp_path), step=1)
    mine.compact()
    mine.save(str(tmp_path), step=2)
    old = engine.FCVIEngine.restore(str(tmp_path), step=1, device="cpu",
                                    config=engine.EngineConfig(k=5))
    new = engine.FCVIEngine.restore(str(tmp_path), device="cpu")
    assert old.cfg.k == 5 and old.delta_size() == 30
    assert old.index.size == N
    assert new.delta_size() == 0 and new.index.size == N + 30
    assert new.stats.inserts == 0
    s, i = new.search(data[1], data[2])
    assert torch.equal(torch.as_tensor(i), torch.as_tensor(
        mine.search(data[1], data[2])[1]))
    assert s.shape == (40, 10) and old.search(data[1], data[2])[0].shape \
        == (40, 5)
