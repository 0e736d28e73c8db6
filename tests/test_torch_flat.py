"""The port's flat backend against the JAX package's.

``repro_torch.index.flat`` and ``repro.index.flat`` get the same numpy
corpus and queries. The returned scores are the exact refine's negative
squared distances: rtol 1e-5, atol 1e-4 (fp32 sums in another order); ids
equal outside near-ties. ``search_rows`` must carry exactly the stored rows
of the ids it returns, and ``merge_topk`` keeps the first occurrence on ties
and pads with (-inf, id 0) past the pool, as the JAX package does.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.index import flat as jflat
from repro_torch.index import flat
from repro_torch.index.backend import SearchBackend
from test_torch_support import assert_topk_match, normal, tensor

RTOL, ATOL = 1e-5, 1e-4


def _data(n, b, d=32, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    return normal(rng, n, d), normal(rng, b, d)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,b,k", [(1000, 5, 10), (1000, 5, 80),
                                   (256, 3, 300)])
def test_search_matches_jax(use_pallas, n, b, k):
    """Includes a corpus that is no multiple of 128 rows and k > n (the
    width clamps to the corpus)."""
    x, q = _data(n, b)
    vals, ids = flat.build(tensor(x)).search(tensor(q), k)
    jidx = jflat.build(jnp.asarray(x))
    jv, ji = jidx.search(jnp.asarray(q), k, use_pallas=use_pallas)
    assert vals.shape == (b, min(k, n)) and ids.dtype == torch.int32
    nxt = None
    if k < n:
        nxt = np.asarray(jidx.search(jnp.asarray(q), k + 1)[0])[:, -1]
    assert_topk_match(jv, ji, vals, ids, rtol=RTOL, atol=ATOL, next_vals=nxt)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_search_rows_carries_the_rows_of_its_ids(use_pallas):
    x, q = _data(1000, 5)
    rng = np.random.default_rng(9)
    pv, pf = normal(rng, 1000, 48), normal(rng, 1000, 8)
    index = flat.build(tensor(x))
    vals, ids, rv, rf = index.search_rows(tensor(q), 20, tensor(pv),
                                          tensor(pf))
    sv, si = index.search(tensor(q), 20)
    assert torch.equal(vals, sv) and torch.equal(ids, si)
    np.testing.assert_array_equal(rv.numpy(), pv[ids.numpy()])
    np.testing.assert_array_equal(rf.numpy(), pf[ids.numpy()])
    jv, ji, _, _ = jflat.search_rows(jflat.build(jnp.asarray(x)),
                                     jnp.asarray(q), 20, jnp.asarray(pv),
                                     jnp.asarray(pf), use_pallas=use_pallas)
    assert_topk_match(jv, ji, vals, ids, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [3, 6, 9])
def test_merge_topk_matches_jax_including_k_beyond_pool(k):
    """Two pools of 2 and 3 with a cross-pool tie, a duplicate id and a
    -inf entry; k=6 and k=9 exceed the pool of 5 and pad."""
    va = np.array([[3.0, 1.0], [2.0, -np.inf]], np.float32)
    ia = np.array([[4, 7], [1, 0]], np.int32)
    vb = np.array([[3.0, 2.0, 0.5], [5.0, 2.0, 2.0]], np.float32)
    ib = np.array([[9, 4, 2], [3, 8, 6]], np.int32)
    vals, ids = flat.merge_topk(*map(tensor, (va, ia, vb, ib)), k)
    jv, ji = jflat.merge_topk(*map(jnp.asarray, (va, ia, vb, ib)), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    if k > 5:
        assert np.isneginf(vals.numpy()[:, 5:]).all()
        assert (ids.numpy()[:, 5:] == 0).all()


def test_exact_refine_matches_jax():
    x, q = _data(500, 4)
    cand = np.random.default_rng(2).permutation(500)[:60]
    cand = np.tile(cand.astype(np.int32), (4, 1))
    vals, ids = flat._exact_refine(tensor(x), tensor(q), tensor(cand), 12)
    jv, ji = jflat._exact_refine(jnp.asarray(x), jnp.asarray(q),
                                 jnp.asarray(cand), 12)
    assert_topk_match(jv, ji, vals, ids, rtol=RTOL, atol=ATOL)


def test_build_norms_and_storage_refusal():
    x, _ = _data(100, 1)
    index = flat.build(tensor(x))
    np.testing.assert_allclose(index.sq_norms.numpy(),
                               np.asarray(jflat.build(jnp.asarray(x)).sq_norms),
                               rtol=1e-6)
    assert (index.size, index.dim) == (100, 32)
    assert isinstance(index, SearchBackend)
    # a bf16 build stores the cast rows and upcasts them for the norms, as
    # the JAX package's bf16 build does
    half = flat.build(tensor(x), storage_dtype=torch.bfloat16)
    jhalf = jflat.build(jnp.asarray(x), storage_dtype=jnp.bfloat16)
    assert half.vectors.dtype == torch.bfloat16 and half.scales is None
    np.testing.assert_array_equal(half.vectors.float().numpy(),
                                  np.asarray(jhalf.vectors, np.float32))
    np.testing.assert_allclose(half.sq_norms.numpy(),
                               np.asarray(jhalf.sq_norms), rtol=1e-6)
