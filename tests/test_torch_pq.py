"""The port's residual-PQ backend (``index/pq.py``) against the JAX package's.

A JAX-built ``PQIndex`` is handed across as its four source arrays (the
``index_state`` keys), and the port derives the rest. The LUTs, the ADC
search and the reconstruction are then held against the JAX functions on
the same queries, with the Pallas kernels in interpret mode
(``use_pallas=True``) and with the jnp path (``False``). Tolerances: the
L2 tolerance of the scans (rtol 1e-5, atol 1e-4; LUT entries reach about
60 here), ids equal outside near-ties; reconstruction exactly (a gather
and one add). k-means draws from a ``torch.Generator`` in the port, so a
port-trained index is held to its shapes and dtypes and to a reconstruction
error within 10% of the JAX package's own build on the same data.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.index import pq as jpq
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.index import pq
from test_torch_support import (assert_topk_match, candidate_ties, tensor,
                                to_numpy_tree)

L2 = dict(rtol=1e-5, atol=1e-4)
SHAPE = dict(m_subspaces=8, ksub=32, ncoarse=8)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(n=3000, d=32, n_categories=5,
                                    n_numeric=3, seed=2))
    q, _ = sample_queries(corpus, 40, seed=3)
    return corpus.vectors, q, jpq.build(jnp.asarray(corpus.vectors),
                                        **SHAPE)


def handed(jidx) -> pq.PQIndex:
    """The port's PQIndex on the JAX index's source arrays."""
    return pq.from_arrays(*(torch.as_tensor(np.array(a)) for a in (
        jidx.codebooks, jidx.codes, jidx.coarse_centers, jidx.coarse_ids)))


def test_derived_arrays_match_jax(data):
    _, _, jidx = data
    idx = handed(jidx)
    assert idx.codes.dtype == torch.uint8
    assert (idx.size, idx.n_subspaces, idx.ksub, idx.ncoarse) == (3000, 8,
                                                                  32, 8)
    np.testing.assert_allclose(idx.cb_sq.numpy(), np.asarray(jidx.cb_sq),
                               **L2)
    np.testing.assert_allclose(idx.coarse_dot.numpy(),
                               np.asarray(jidx.coarse_dot), **L2)
    want = (np.asarray(jidx.coarse_ids)[:, None] * 32
            + np.asarray(jidx.codes).astype(np.int32))
    assert idx.ccodes.dtype == torch.int32
    np.testing.assert_array_equal(idx.ccodes.numpy(), want)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_compute_luts_matches_jax(data, use_pallas):
    _, q, jidx = data
    got = pq.compute_luts(handed(jidx), tensor(q))
    want = jpq.compute_luts(jidx, jnp.asarray(q), use_pallas=use_pallas)
    assert got.shape == (40, 8, 8, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **L2)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("k", [10, 80])
def test_search_matches_jax(data, use_pallas, k):
    _, q, jidx = data
    vals, ids = pq.search(handed(jidx), tensor(q), k)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    jv, ji = jpq.search(jidx, jnp.asarray(q), k, use_pallas=use_pallas)
    nxt = np.asarray(jpq.search(jidx, jnp.asarray(q), k + 1,
                                use_pallas=use_pallas)[0])[:, -1]
    assert_topk_match(jv, ji, vals, ids, **L2, next_vals=nxt)


def test_search_ties_keep_the_smaller_row_id(data):
    """Duplicated rows have equal codes, so equal ADC distances exactly:
    the smaller row id must come first, as ``lax.top_k`` orders them."""
    _, q, jidx = data
    idx = handed(jidx)
    dup = pq.from_arrays(idx.codebooks, torch.cat([idx.codes, idx.codes]),
                         idx.coarse_centers,
                         torch.cat([idx.coarse_ids, idx.coarse_ids]))
    vals, ids = pq.search(dup, tensor(q), 20)
    jdup = jpq.PQIndex(jidx.codebooks,
                       jnp.concatenate([jidx.codes, jidx.codes]),
                       jidx.coarse_centers,
                       jnp.concatenate([jidx.coarse_ids, jidx.coarse_ids]),
                       jidx.cb_sq, jidx.coarse_dot)
    jv, ji = jpq.search(jdup, jnp.asarray(q), 20, use_pallas=True)
    assert (vals[:, 0] == vals[:, 1]).all()          # every winner is twice
    assert (ids[:, 0] < ids[:, 1]).all()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


def test_reconstruct_equals_jax(data):
    _, _, jidx = data
    rows = np.array([[0, 5, 2999], [17, 17, 1]])
    got = pq.reconstruct(handed(jidx), tensor(rows))
    want = jpq.reconstruct(jidx, jnp.asarray(rows))
    assert got.shape == (2, 3, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_n_equal_ksub_with_uint8_codes(data):
    """n == ksub: the (n,) uint8 code columns have the codebooks' row count,
    so an unwidened uint8 index would be a boolean mask of the right
    shape and index silently; the port widens every code first."""
    x, q, _ = data
    small = x[:32]
    jidx = jpq.build(jnp.asarray(small), **SHAPE)
    assert jidx.codes.dtype == jnp.uint8 and jidx.codes.shape == (32, 8)
    idx = handed(jidx)
    all_ids = np.arange(32)
    np.testing.assert_array_equal(
        pq.reconstruct(idx, tensor(all_ids)).numpy(),
        np.asarray(jpq.reconstruct(jidx, jnp.asarray(all_ids))))
    vals, ids = pq.search(idx, tensor(q), 32)       # k = n: every row
    jv, ji = jpq.search(jidx, jnp.asarray(q), 32, use_pallas=True)
    assert_topk_match(jv, ji, vals, ids, **L2)
    mine = pq.build(tensor(small), generator=0, **SHAPE)
    assert mine.codes.dtype == torch.uint8 and mine.ksub == 32
    assert pq.reconstruct(mine, tensor(all_ids)).shape == (32, 32)


def test_port_build_shapes_and_reconstruction_error(data):
    x, q, jidx = data
    mine = pq.build(tensor(x), generator=0, **SHAPE)
    assert mine.codes.dtype == torch.uint8 and mine.codes.shape == (3000, 8)
    assert mine.codebooks.shape == (8, 32, 4)
    assert mine.coarse_ids.dtype == torch.int32
    assert mine.coarse_centers.shape == (8, 32)
    all_ids = np.arange(3000)
    err = float(((x - pq.reconstruct(mine, tensor(all_ids)).numpy()) ** 2)
                .sum(1).mean())
    jerr = float(((x - np.asarray(jpq.reconstruct(
        jidx, jnp.asarray(all_ids)))) ** 2).sum(1).mean())
    assert err <= 1.1 * jerr, (err, jerr)
    # the same generator seed trains the same index
    again = pq.build(tensor(x), generator=0, **SHAPE)
    assert torch.equal(again.codes, mine.codes)
    assert torch.equal(again.codebooks, mine.codebooks)
    # ksub > 256 stores int32 codes; ksub and ncoarse clamp to n
    wide = pq.build(tensor(x[:400]), m_subspaces=4, ksub=300, ncoarse=2,
                    generator=1, iters=3)
    assert wide.codes.dtype == torch.int32 and int(wide.codes.max()) < 300
    tiny = pq.build(tensor(x[:5]), generator=0, **SHAPE)
    assert (tiny.ksub, tiny.ncoarse) == (5, 5)
    with pytest.raises(ValueError, match="divisible"):
        pq.build(tensor(x[:, :30]), m_subspaces=8)


def test_candidate_ties_helper():
    vals = np.array([[-1.0, -2.0, -2.00001, -3.0], [-1.0, -2.0, -3.0, -4.0]],
                    np.float32)
    assert candidate_ties(vals, 2, **L2).tolist() == [True, False]


CFG = dict(backend="pq", pq_m=8, pq_ksub=32, pq_coarse=8)


def test_index_state_round_trips_both_ways(data):
    x, q, _ = data
    corpus = make_corpus(CorpusSpec(n=1500, d=32, n_categories=5,
                                    n_numeric=3, seed=4))
    qv, fq = sample_queries(corpus, 12, seed=5)
    # JAX -> port -> state: the source arrays come back as they went in
    jidx = jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters), jfcvi.FCVIConfig(**CFG))
    jstate = to_numpy_tree(jfcvi.index_state(jidx))
    assert "vectors" not in jstate["backend"]
    idx = fcvi.index_from_state(fcvi.FCVIConfig(**CFG), jstate, device="cpu")
    back = fcvi.index_state(idx)["backend"]
    assert set(back) == set(jstate["backend"])
    for key, arr in jstate["backend"].items():
        assert back[key].numpy().dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key].numpy(), arr)
    # port -> JAX: a port-trained index served by the JAX package
    mine = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(**CFG),
                      device="cpu")
    pstate = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.numpy())
              for k, v in fcvi.index_state(mine).items()}
    assert pstate["backend"]["codes"].dtype == np.uint8
    jmine = jfcvi.index_from_state(
        jfcvi.FCVIConfig(use_pallas=True, **CFG),
        {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else jnp.asarray(v))
         for k, v in pstate.items()})
    vals, ids = fcvi.query(mine, tensor(qv), tensor(fq), 10)
    jv, ji = jfcvi.query(jmine, jnp.asarray(qv), jnp.asarray(fq), 10)
    assert_topk_match(jv, ji, vals, ids, rtol=0.0, atol=1e-5)
