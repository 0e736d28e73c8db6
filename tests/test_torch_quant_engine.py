"""The storage ladder end to end: flat and IVF indexes at bf16 and int8,
through ``fcvi.query`` and ``FCVIEngine``, against the JAX package.

Both packages serve the same state: the JAX package builds the index at
``storage_dtype="bfloat16"`` or ``"int8"``, ``fcvi.index_state`` exports the
stored rows (bf16 as ``ml_dtypes.bfloat16`` numpy, int8 codes with their
scales), and the port loads them with ``index_from_state``. Combined
scores: atol 1e-5; ids equal outside near-ties. The JAX package runs with
``use_pallas`` True (its Pallas kernels in interpret mode) and False; the
IVF fixture's seeds put no query at a probe near-tie (asserted).

The port's own builds are held to the reference's contract: the int8
engine's final top-k (ids and scores) equals the fp32 engine's, the exact
refine and the re-rank running on fp32 rows (the mirror of
``tests/test_quantization.py::test_int8_final_topk_matches_fp32``), also
with IVF lists left empty. The delta tier stores its rows at the index's
dtype, compaction re-quantizes, ``ivf.add`` quantizes the new rows with
their own scales, and the bytes model counts scales, as in the JAX
package.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.index import ivf as jivf
from repro.serve import engine as jengine
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.index import ivf
from repro_torch.serve import engine
from test_torch_support import (assert_topk_match, probe_ties, tensor,
                                to_numpy_tree)

TOL = dict(rtol=0.0, atol=1e-5)
DTYPES = ["bfloat16", "int8"]
TORCH_DTYPE = {"bfloat16": torch.bfloat16, "int8": torch.int8}
BACKENDS = {"flat": dict(), "ivf": dict(backend="ivf", nlist=16, nprobe=4)}


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(n=3000, d=32, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 40, seed=3)
    rng = np.random.default_rng(4)
    new_v = (corpus.vectors[rng.integers(0, 3000, 300)]
             + 0.1 * rng.normal(size=(300, 32))).astype(np.float32)
    new_f = corpus.filters[rng.integers(0, 3000, 300)]
    return corpus, q, fq, new_v, new_f


def _jax_index(corpus, use_pallas=False, **cfg):
    return jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters),
                       jfcvi.FCVIConfig(use_pallas=use_pallas, **cfg))


def _port(jidx, **cfg):
    return fcvi.index_from_state(fcvi.FCVIConfig(**cfg),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")


def _no_probe_ties(index, q, fq):
    if index.config.backend != "ivf":
        return
    qn, fqn = index.transform.normalize(tensor(q), tensor(fq))
    q_t = index.transform.apply_normalized(qn, fqn)
    assert not probe_ties(index.backend.centroids.numpy(), q_t.numpy(),
                          index.config.nprobe).any()


def _same_search(engines, q, fq):
    (js, ji), (s, i) = (e.search(q, fq) for e in engines)
    assert s.dtype == np.float32 and i.dtype == np.int64
    assert_topk_match(js, ji, s, i, **TOL)
    return s, i


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_query_on_jax_state_matches_jax(data, backend, dtype, use_pallas):
    corpus, q, fq, _, _ = data
    cfg = dict(BACKENDS[backend], storage_dtype=dtype)
    jidx = _jax_index(corpus, use_pallas, **cfg)
    idx = _port(jidx, **cfg)
    b = idx.backend
    assert b.vectors.dtype == TORCH_DTYPE[dtype]
    assert (b.scales is not None) == (dtype == "int8")
    if backend == "ivf":
        assert b.grouped.dtype == TORCH_DTYPE[dtype]
        assert (b.grouped_scales is not None) == (dtype == "int8")
    np.testing.assert_allclose(b.sq_norms.numpy(),
                               np.asarray(jidx.backend.sq_norms), rtol=1e-6)
    _no_probe_ties(idx, q, fq)
    vals, ids = fcvi.query(idx, tensor(q), tensor(fq), 10)
    jv, ji = jfcvi.query(jidx, jnp.asarray(q), jnp.asarray(fq), 10)
    assert_topk_match(jv, ji, vals, ids, **TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_engine_on_jax_state_matches_jax(data, backend, dtype):
    """Both step variants (rows carried out of the scan, or gathered by
    id), escalation, partial batches and cache hits; the bytes model."""
    corpus, q, fq, _, _ = data
    cfg = dict(BACKENDS[backend], storage_dtype=dtype)
    jidx = _jax_index(corpus, **cfg)
    idx = _port(jidx, **cfg)
    _no_probe_ties(idx, q, fq)
    for gather_free in (True, False):
        ecfg = dict(batch_size=16, escalate_margin=0.05,
                    gather_free=gather_free)
        engines = (jengine.FCVIEngine(jidx, jengine.EngineConfig(**ecfg)),
                   engine.FCVIEngine(idx, engine.EngineConfig(**ecfg),
                                     device="cpu"))
        s, i = _same_search(engines, q, fq)     # 40 queries: 16 + 16 + 8
        jeng, mine = engines
        assert mine.stats.escalations == jeng.stats.escalations
        assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned > 0
        s2, i2 = _same_search(engines, q, fq)   # all cache hits
        assert mine.stats.cache_hits == jeng.stats.cache_hits == 40
        np.testing.assert_array_equal(i2, i)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_int8_final_topk_matches_fp32(data, backend):
    """The port's own builds: quantization perturbs only the candidates,
    and the over-retrieval absorbs it, so the engines' final ids and
    scores are the same."""
    corpus, q, fq, _, _ = data
    out = {}
    for st in ("float32", "int8"):
        cfg = fcvi.FCVIConfig(alpha=1.0, lam=0.6, c=8.0, storage_dtype=st,
                              **dict(BACKENDS[backend], nprobe=8))
        idx = fcvi.build(corpus.vectors, corpus.filters, cfg, device="cpu",
                         rng=0)
        eng = engine.FCVIEngine(idx, engine.EngineConfig(k=5, batch_size=16),
                                device="cpu")
        out[st] = eng.search(q, fq)
    np.testing.assert_array_equal(out["float32"][1], out["int8"][1])
    np.testing.assert_array_equal(out["float32"][0], out["int8"][0])


def test_empty_ivf_lists_with_int8(data):
    """Three distinct rows repeated leave most of 16 lists empty; their pad
    slots quantize to scale 1.0 and the int8 results equal fp32's."""
    corpus = data[0]
    vecs = np.tile(corpus.vectors[:3], (20, 1)).astype(np.float32)
    filt = np.tile(corpus.filters[:3], (20, 1)).astype(np.float32)
    q, fq = sample_queries(corpus, 8, seed=3)
    out = {}
    for st in ("float32", "int8"):
        cfg = fcvi.FCVIConfig(alpha=1.0, lam=0.6, c=8.0, backend="ivf",
                              nlist=16, nprobe=16, storage_dtype=st)
        idx = fcvi.build(vecs, filt, cfg, device="cpu", rng=0)
        assert int(idx.backend.list_sizes.min()) == 0
        out[st] = fcvi.query(idx, tensor(q), tensor(fq), 5)
    gs = idx.backend.grouped_scales
    assert (gs[idx.backend.valid < 0.5] == 1.0).all()
    (s0, i0), (s1, i1) = out["float32"], out["int8"]
    assert torch.isfinite(s0).all()
    assert torch.equal(i0, i1) and torch.equal(s0, s1)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_int8_delta_tier_and_compaction_match_jax(data, backend):
    """20 pending rows (all scored), then 300 (the delta scan at int8),
    then a compaction that re-quantizes the grown corpus."""
    corpus, q, fq, new_v, new_f = data
    cfg = dict(BACKENDS[backend], storage_dtype="int8")
    jidx = _jax_index(corpus, **cfg)
    ecfg = dict(batch_size=16, escalate_margin=0.0, compact_threshold=400)
    engines = (jengine.FCVIEngine(jidx, jengine.EngineConfig(**ecfg)),
               engine.FCVIEngine(_port(jidx, **cfg),
                                 engine.EngineConfig(**ecfg), device="cpu"))
    jeng, mine = engines
    for lo, hi in [(0, 20), (20, 300)]:
        for e in engines:
            e.insert(new_v[lo:hi], new_f[lo:hi])
        _, i = _same_search(engines, q, fq)
        assert (i >= 3000).any()                # delta rows do surface
        delta = mine._delta.flat
        assert delta.vectors.dtype == torch.int8
        np.testing.assert_array_equal(delta.scales.numpy(),
                                      np.asarray(jeng._delta.flat.scales))
        assert mine._batch_scan_bytes(16) == jeng._batch_scan_bytes(16)
    assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned
    for e in engines:
        e.compact()
    assert mine.index.size == jeng.index.size == 3300
    b = mine.index.backend
    assert b.vectors.dtype == torch.int8 and b.scales.shape == (3300,)
    if backend == "flat":
        # the same corpus re-quantized: equal up to the transforms' 1e-5
        _same_search(engines, q, fq)
    else:
        # IVF re-trains its k-means (different generators): the port is
        # held against a fresh seed-0 build of the same rows
        tfm = mine.index.transform
        fresh = fcvi.build_backend(
            tfm.apply_normalized(mine.index.vectors_n, mine.index.filters_n),
            mine.index.config)
        for name in ("vectors", "scales", "lists", "grouped",
                     "grouped_scales"):
            assert torch.equal(getattr(fresh, name), getattr(b, name)), name
        s, i = mine.search(q, fq)
        assert np.isfinite(s).all() and ((i >= 0) & (i < 3300)).all()


def test_int8_ivf_add_matches_jax_with_empty_lists(data):
    """``ivf.add`` on the JAX package's int8 IVF state, 16 lists of which
    most are empty: the new rows join their nearest lists with their own
    scales; codes, scales, lists and grouped scales equal the reference's,
    bit for bit."""
    corpus, _, _, new_v, _ = data
    vecs = np.tile(corpus.vectors[:3], (20, 1)).astype(np.float32)
    filt = np.tile(corpus.filters[:3], (20, 1)).astype(np.float32)
    cfg = dict(backend="ivf", nlist=16, nprobe=16, storage_dtype="int8")
    jidx = jfcvi.build(jnp.asarray(vecs), jnp.asarray(filt),
                       jfcvi.FCVIConfig(**cfg))
    assert int(np.asarray(jidx.backend.list_sizes).min()) == 0
    idx = _port(jidx, **cfg)
    rows = new_v[:40] * np.float32(0.05)
    mine = ivf.add(idx.backend, tensor(rows))
    theirs = jivf.add(jidx.backend, jnp.asarray(rows))
    assert mine.vectors.dtype == torch.int8
    for name in ("vectors", "scales", "lists", "list_sizes",
                 "grouped_scales", "valid"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(mine.grouped.numpy(),
                                  np.asarray(theirs.grouped))
    np.testing.assert_allclose(mine.sq_norms.numpy(),
                               np.asarray(theirs.sq_norms), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", *DTYPES])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_batch_scan_bytes_match_jax(data, backend, dtype):
    """The bytes model per padded batch, each rung, with a pending delta
    stored at the index's dtype: the reference's numbers."""
    corpus, q, fq, new_v, new_f = data
    cfg = dict(BACKENDS[backend], storage_dtype=dtype)
    jidx = _jax_index(corpus, **cfg)
    engines = (jengine.FCVIEngine(jidx, jengine.EngineConfig()),
               engine.FCVIEngine(_port(jidx, **cfg), engine.EngineConfig(),
                                 device="cpu"))
    jeng, mine = engines
    for b in (1, 2, 64):
        assert mine._batch_scan_bytes(b) == jeng._batch_scan_bytes(b)
    for e in engines:
        e.insert(new_v[:50], new_f[:50])
        e.search(q[:4], fq[:4])
    for b in (1, 2, 64):
        assert mine._batch_scan_bytes(b) == jeng._batch_scan_bytes(b)
    assert mine.stats.bytes_scanned == jeng.stats.bytes_scanned
