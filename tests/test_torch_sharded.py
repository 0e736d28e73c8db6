"""Sharded serving on the port's engine: 8 shards on the CPU.

* ``FCVIEngine(index, cfg, mesh=make_mesh((8, 1), ("data", "model"),
  device="cpu"))`` over flat (contiguous and cluster placement), IVF
  (balanced and affinity) and PQ (contiguous), flat and IVF at fp32, bf16
  and int8, with ``gather_free`` on and off: ids and scores BIT-EQUAL to
  the port's meshless engine on the same state, on a first batch (with
  escalations), with a delta tier the step takes whole, with one it scans
  per shard, and after ``compact()``.
* One subprocess with 8 forced host devices runs the JAX package's sharded
  engines (kernels off) and writes an npz: their results and index
  states. The port's sharded engines over the handed-over states match
  the JAX results: ids outside near-ties, scores within 1e-5, queries at
  an IVF probe near-tie or a PQ candidate near-tie left out.
* Checkpoints both ways with ``router|centers``: the subprocess restores
  the port's cluster-placed checkpoint onto its mesh and writes its own;
  each package routes from the other's centers and answers as the writer.
  The elastic restore: 8 shards -> 2 shards and meshless, bit-equal.
* A (4, 2) mesh whose rules shard the corpus over both axes, and a
  1-shard mesh, bit-equal.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the card's machine has no JAX

from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.distributed.sharding import AxisRules
from repro_torch.index import pq
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve.engine import EngineConfig, FCVIEngine
from test_torch_support import (assert_topk_match, candidate_ties,  # noqa: F401
                                one_thread, probe_ties, tensor)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPEC = dict(n=4000, d=64, n_categories=5, n_numeric=3, seed=2)
NQ = 48
BACKEND = {"flat": dict(), "ivf": dict(backend="ivf", nlist=16, nprobe=4),
           "pq": dict(backend="pq", pq_m=8, pq_ksub=32, pq_coarse=6)}
# escalate_margin 0.1: a few queries per batch take the escalation step
ENGINE = dict(batch_size=32, escalate_margin=0.1)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(**SPEC))
    q, fq = sample_queries(corpus, NQ, seed=3)
    rng = np.random.default_rng(4)
    new_v = (corpus.vectors[rng.integers(0, SPEC["n"], 120)]
             + 0.1 * rng.normal(size=(120, SPEC["d"]))).astype(np.float32)
    new_f = corpus.filters[rng.integers(0, SPEC["n"], 120)]
    return corpus, q, fq, new_v, new_f


_BUILT = {}


def _index(data, backend, storage="float32"):
    key = (backend, storage)
    if key not in _BUILT:
        corpus = data[0]
        cfg = fcvi.FCVIConfig(storage_dtype=storage, **BACKEND[backend])
        _BUILT[key] = fcvi.build(corpus.vectors, corpus.filters, cfg,
                                 device="cpu")
    return _BUILT[key]


def _mesh(n=8):
    return make_mesh((n, 1), ("data", "model"), device="cpu")


def _same(a, b):
    (s0, i0), (s1, i1) = a, b
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(s1, s0)


CASES = ([("flat", p, st) for p in ("contiguous", "cluster")
          for st in ("float32", "bfloat16", "int8")]
         + [("ivf", p, st) for p in ("balanced", "affinity")
            for st in ("float32", "bfloat16", "int8")]
         + [("pq", "contiguous", "float32")])


@pytest.mark.parametrize("gather_free", [True, False])
@pytest.mark.parametrize("backend,placement,storage", CASES)
def test_sharded_bit_equal_to_meshless(data, backend, placement, storage,
                                       gather_free):
    _, q, fq, new_v, new_f = data
    idx = _index(data, backend, storage)
    ec = EngineConfig(gather_free=gather_free, **ENGINE)
    e0 = FCVIEngine(idx, ec, device="cpu")
    e1 = FCVIEngine(idx, EngineConfig(gather_free=gather_free, **ENGINE),
                    device="cpu", mesh=_mesh(), placement=placement)
    assert e1._sharded.n_shards == 8
    _same(e0.search(q, fq), e1.search(q, fq))
    assert e1.stats.escalations == e0.stats.escalations > 0
    # 30 pending rows: the step takes them all; 120: each shard scans its
    # block of the delta tier
    for lo, hi in ((0, 30), (30, 120)):
        for e in (e0, e1):
            e.insert(new_v[lo:hi], new_f[lo:hi])
        s, i = e1.search(q, fq)
        _same(e0.search(q, fq), (s, i))
        assert (i >= SPEC["n"]).any()
    e0.compact()
    e1.compact()
    assert e1.index.size == SPEC["n"] + 120 and e1._sharded.n_shards == 8
    _same(e0.search(q[:20] + 0.01, fq[:20]), e1.search(q[:20] + 0.01,
                                                       fq[:20]))


def test_shards_hold_their_own_blocks(data):
    """Each shard's block is its own tensors (no view of the index), the
    blocks partition the corpus, and n_local = ceil(n / ns)."""
    idx = _index(data, "flat")
    e = FCVIEngine(idx, EngineConfig(), device="cpu", mesh=_mesh(),
                   placement="cluster")
    slab = e._sharded.slab
    assert slab.n_local == 500
    ids = np.concatenate([sh.row_ids.numpy() for sh in slab.shards])
    np.testing.assert_array_equal(np.sort(ids), np.arange(SPEC["n"]))
    np.testing.assert_array_equal(ids, slab.perm)
    for sh in slab.shards:
        assert sh.vectors.untyped_storage().data_ptr() != \
            idx.backend.vectors.untyped_storage().data_ptr()
        assert torch.equal(sh.vectors, idx.backend.vectors[sh.row_ids.long()])
    ivf = FCVIEngine(_index(data, "ivf"), EngineConfig(), device="cpu",
                     mesh=_mesh(), placement="balanced")._sharded.slab
    lists = sorted(g for sh in ivf.shards for g in sh.list_ids.tolist())
    assert lists == list(range(16))
    for i, sh in enumerate(ivf.shards):
        assert (ivf.list_to_shard[sh.list_ids] == i).all()


@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_two_axis_mesh_and_one_shard_mesh(data, backend):
    _, q, fq, _, _ = data
    idx = _index(data, backend)
    want = FCVIEngine(idx, EngineConfig(**ENGINE), device="cpu").search(q, fq)
    mesh42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    rules = AxisRules(mesh42, {"corpus": ("data", "model"),
                               "ivf_lists": ("data", "model")})
    e = FCVIEngine(idx, EngineConfig(**ENGINE), device="cpu", mesh=mesh42,
                   rules=rules, placement="cluster")
    assert e._sharded.n_shards == 8 and len(e._sharded.axes) == 2
    _same(want, e.search(q, fq))
    e = FCVIEngine(idx, EngineConfig(**ENGINE), device="cpu", mesh=mesh42,
                   placement="cluster")
    assert e._sharded.n_shards == 4          # default rules: "data" only
    _same(want, e.search(q, fq))
    e1 = FCVIEngine(idx, EngineConfig(**ENGINE), device="cpu",
                    mesh=_mesh(1), placement="cluster")
    _same(want, e1.search(q, fq))


def test_elastic_restore_8_to_2_and_meshless(data, tmp_path):
    _, q, fq, new_v, new_f = data
    idx = _index(data, "flat")
    e8 = FCVIEngine(idx, EngineConfig(**ENGINE), device="cpu", mesh=_mesh(),
                    placement="cluster", routing="routed")
    e8.insert(new_v[:20], new_f[:20])
    want = e8.search(q, fq)
    e8.save(str(tmp_path), step=1)
    e2 = FCVIEngine.restore(str(tmp_path), device="cpu", mesh=_mesh(2))
    assert e2._routing == "routed" and e2._placement == "cluster"
    assert e2._sharded.n_shards == 2 and e2.delta_size() == 20
    assert torch.equal(e2._sharded.slab.router_centers,
                       e8._sharded.slab.router_centers)
    _same(want, e2.search(q, fq))
    e0 = FCVIEngine.restore(str(tmp_path), device="cpu")
    assert e0._sharded is None and e0._routing == "dense"
    _same(want, e0.search(q, fq))


# ---------------------------------------------------------------------------
# Against the JAX package's sharded engines (8 forced host devices)
# ---------------------------------------------------------------------------

JAX_CASES = {   # name: (backend, storage, placement)
    "flat-contiguous": ("flat", "float32", "contiguous"),
    "flat-cluster-int8": ("flat", "int8", "cluster"),
    "ivf-balanced": ("ivf", "float32", "balanced"),
    "ivf-affinity-int8": ("ivf", "int8", "cluster"),
    "pq": ("pq", "float32", "contiguous"),
}
JAX_ENGINE = dict(batch_size=32, escalate_margin=0.0)

_SUBPROCESS = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import fcvi
from repro.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro.launch.mesh import make_mesh
from repro.serve.engine import EngineConfig, FCVIEngine

out, port_ckpt, jax_ckpt = sys.argv[1:4]
assert len(jax.devices()) == 8
corpus = make_corpus(CorpusSpec(**{spec!r}))
q, fq = sample_queries(corpus, {nq}, seed=3)
q, fq = np.asarray(q), np.asarray(fq)
mesh = make_mesh((8, 1), ("data", "model"))
res = {{"q": q}}

def flat(prefix, tree):
    for key, v in tree.items():
        if isinstance(v, dict):
            flat(prefix + key + "|", v)
        else:
            res[prefix + key] = np.asarray(v)

for name, (backend, storage, placement) in {cases!r}.items():
    cfg = fcvi.FCVIConfig(storage_dtype=storage, use_pallas=False,
                          **{backends!r}[backend])
    idx = fcvi.build(jnp.asarray(corpus.vectors),
                     jnp.asarray(corpus.filters), cfg)
    eng = FCVIEngine(idx, EngineConfig(**{engine!r}), mesh=mesh,
                     placement=placement)
    res[name + "|scores"], res[name + "|ids"] = eng.search(q, fq)
    flat(name + "|state|", fcvi.index_state(idx))
    if name == "flat-contiguous":
        ceng = FCVIEngine(idx, EngineConfig(**{engine!r}), mesh=mesh,
                          placement="cluster")
        ceng.save(jax_ckpt, step=1)
        res["jax_ckpt|scores"], res["jax_ckpt|ids"] = ceng.search(q, fq)
        res["jax_ckpt|centers"] = np.asarray(
            ceng._sharded.slab.router_centers)
pe = FCVIEngine.restore(port_ckpt, mesh=mesh)
res["port_ckpt|scores"], res["port_ckpt|ids"] = pe.search(q, fq)
res["port_ckpt|centers"] = np.asarray(pe._sharded.slab.router_centers)
res["port_ckpt|placement"] = np.asarray(pe._placement)
np.savez(out, **res)
"""


def _unflat(res, prefix):
    tree = {}
    for key in res.files:
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("|")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = res[key]
    return tree


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The port writes a cluster-placed flat checkpoint; the subprocess
    serves the JAX sharded engines, restores that checkpoint and writes its
    own. Returns (npz, the port engine that saved, the JAX ckpt dir)."""
    _, q, fq, _, _ = data
    tmp = tmp_path_factory.mktemp("jax_sharded")
    port = FCVIEngine(_index(data, "flat"), EngineConfig(**JAX_ENGINE),
                      device="cpu", mesh=_mesh(), placement="cluster")
    port.save(str(tmp / "port"), step=1)
    code = _SUBPROCESS.format(spec=SPEC, nq=NQ, cases=JAX_CASES,
                              backends=BACKEND, engine=JAX_ENGINE)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          str(tmp / "res.npz"), str(tmp / "port"),
                          str(tmp / "jax")], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    res = np.load(tmp / "res.npz")
    np.testing.assert_array_equal(res["q"], q)
    return res, port, str(tmp / "jax")


def _left_out(index, q, fq, kp):
    qn, fqn = index.transform.normalize(tensor(q), tensor(fq))
    q_t = index.transform.apply_normalized(qn, fqn)
    if index.config.backend == "ivf":
        return probe_ties(index.backend.centroids.numpy(), q_t.numpy(),
                          index.config.nprobe)
    if index.config.backend == "pq":
        return candidate_ties(pq.search(index.backend, q_t, kp + 1)[0], kp)
    return np.zeros(len(q), bool)


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_matches_jax_sharded_engine(data, jax_run, name):
    _, q, fq, _, _ = data
    res = jax_run[0]
    backend, storage, placement = JAX_CASES[name]
    cfg = fcvi.FCVIConfig(storage_dtype=storage, **BACKEND[backend])
    idx = fcvi.index_from_state(cfg, _unflat(res, name + "|state|"),
                                device="cpu")
    eng = FCVIEngine(idx, EngineConfig(**JAX_ENGINE), device="cpu",
                     mesh=_mesh(), placement=placement)
    s, i = eng.search(q, fq)
    keep = ~_left_out(idx, q, fq, 80)
    assert keep.sum() >= NQ // 2      # PQ's 32 codewords tie often
    assert_topk_match(res[name + "|scores"][keep], res[name + "|ids"][keep],
                      s[keep], i[keep], rtol=0.0, atol=1e-5)


def test_checkpoints_cross_both_ways_with_router_centers(data, jax_run):
    _, q, fq, _, _ = data
    res, port, jax_dir = jax_run
    # the JAX engine restored the port's checkpoint: same router, answers
    assert str(res["port_ckpt|placement"]) == "cluster"
    np.testing.assert_array_equal(res["port_ckpt|centers"],
                                  port._sharded.slab.router_centers.numpy())
    s, i = port.search(q, fq)
    assert_topk_match(res["port_ckpt|scores"], res["port_ckpt|ids"], s, i,
                      rtol=0.0, atol=1e-5)
    # the port restores the JAX one, onto 8 shards and onto 2
    for n in (8, 2):
        mine = FCVIEngine.restore(jax_dir, device="cpu", mesh=_mesh(n))
        assert mine._placement == "cluster"
        np.testing.assert_array_equal(
            mine._sharded.slab.router_centers.numpy(),
            res["jax_ckpt|centers"])
        s, i = mine.search(q, fq)
        assert_topk_match(res["jax_ckpt|scores"], res["jax_ckpt|ids"], s, i,
                          rtol=0.0, atol=1e-5)
