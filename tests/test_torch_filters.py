"""The port's filter algebra (``repro_torch.core.filters``) against the JAX
package's (``repro.core.filters``).

Compilation is pure numpy in both packages, so the compiled arrays must be
equal exactly, the empty-intersection and error cases included. Evaluation
is pure elementwise comparison, so the port's ``eval_mask`` (torch) must
equal its own ``eval_np``, the reference's ``eval_np`` and the reference's
traced ``eval_mask`` row for row, NaN rows (never eligible) included. The
fold helpers (``Transform.fold_query``, ``fcvi.filters_raw``,
``fcvi.fold_queries``) are held against the reference on handed-over state
within the transform's tolerance (rtol = atol = 1e-5).
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import FCVIConfig as JConfig
from repro.core import build as jbuild
from repro.core import fcvi as jfcvi
from repro.core import filters as jfilters
from repro_torch.core import fcvi
from repro_torch.core import filters
from test_torch_support import tensor, to_numpy_tree

NAMES = ("price", "stock", "cat", "region")


def _trees(mod):
    """The same predicate trees built with either package's ``F``."""
    F = mod.F
    return [
        F.range("price", 10.0, 50.0),
        F.range("price", lo=3.0),
        F.range("stock", hi=-1.5),
        F.eq("cat", 2.0),
        F.isin("region", [5.0, 1.0, 3.0, 1.0]),
        F.range("price", 0.0, 10.0) & F.range("price", 5.0, 20.0),
        F.isin("cat", [1.0, 2.0, 3.0]) & F.isin("cat", [2.0, 3.0, 4.0]),
        F.isin("cat", [1.0]) & F.isin("cat", [2.0]),          # empty
        F.range("price", 5.0, 1.0),                           # empty range
        F.eq("cat", 2.0) & F.range("cat", 0.0, 1.0),
        (F.range("price", -1.0, 1.0) & F.isin("region", [0.0, 2.0]))
        & (F.eq("stock", 0.25) & F.range("region", None, 1.5)),
        F.isin("region", [float(v) for v in range(16)]),      # MAX_ISIN
        F.range("price", 0.1, 0.3) & F.range("stock", 0.3, 0.7),
    ]


@pytest.mark.parametrize("case", range(len(_trees(filters))))
def test_compile_predicate_matches_reference(case):
    mine = filters.compile_predicate(_trees(filters)[case], NAMES)
    theirs = jfilters.compile_predicate(_trees(jfilters)[case], NAMES)
    for name in ("lo", "hi", "isin_vals", "isin_count"):
        a, b = getattr(mine, name), getattr(theirs, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert mine.constrained == theirs.constrained
    assert mine.n_attrs == theirs.n_attrs == len(NAMES)
    col_means = np.float32([1.5, -0.5, 2.0, 0.75])
    np.testing.assert_array_equal(mine.fold_target_raw(col_means),
                                  theirs.fold_target_raw(col_means))


def test_empty_intersection_compiles_to_always_false():
    F = filters.F
    cp = filters.compile_predicate(F.isin("cat", [1.0]) & F.isin("cat", [2.0]),
                                   NAMES)
    assert cp.lo[2] == np.inf and cp.hi[2] == -np.inf
    assert cp.isin_count[2] == 0
    attrs = np.float32([[0, 0, 1, 0], [0, 0, 2, 0]])
    assert not cp.eval_np(attrs).any()


def test_compile_errors_match_reference():
    for mod in (filters, jfilters):
        F = mod.F
        with pytest.raises(ValueError, match="unknown attribute"):
            mod.compile_predicate(F.range("colour", 0.0, 1.0), NAMES)
        with pytest.raises(ValueError, match="at least one"):
            F.isin("cat", [])
        with pytest.raises(ValueError, match="at most 16"):
            F.isin("cat", [float(v) for v in range(17)])
        with pytest.raises(TypeError, match="not a predicate"):
            mod.compile_predicate(mod.And((F.eq("cat", 1.0), "x")), NAMES)
    # a compiled predicate passes through unchanged
    cp = filters.compile_predicate(filters.F.eq("cat", 1.0), NAMES)
    assert filters.compile_predicate(cp, NAMES) is cp
    # & flattens conjunctions and refuses what is not a predicate
    F = filters.F
    tree = F.eq("cat", 1.0) & (F.range("price", 0, 1) & F.eq("stock", 2.0))
    assert isinstance(tree, filters.And) and len(tree.children) == 3
    with pytest.raises(TypeError):
        F.eq("cat", 1.0) & 3


def _attr_table(n=500, seed=0):
    """Continuous and categorical columns, with NaN entries in a few rows
    (never eligible, on any bound)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 4)).astype(np.float32) * 10.0 + 20.0
    a[:, 2] = rng.integers(0, 6, n).astype(np.float32)
    a[:, 3] = rng.integers(0, 16, n).astype(np.float32)
    a[rng.choice(n, 12, replace=False), rng.integers(0, 4, 12)] = np.nan
    return a


@pytest.mark.parametrize("case", range(len(_trees(filters))))
def test_eval_mask_matches_eval_np_and_reference(case):
    a = _attr_table(seed=case)
    mine = filters.compile_predicate(_trees(filters)[case], NAMES)
    theirs = jfilters.compile_predicate(_trees(jfilters)[case], NAMES)
    got = filters.eval_mask(tensor(a), *mine.as_arrays()).numpy()
    assert got.dtype == np.bool_ and got.shape == (a.shape[0],)
    np.testing.assert_array_equal(got, mine.eval_np(a))
    np.testing.assert_array_equal(got, theirs.eval_np(a))
    np.testing.assert_array_equal(
        got, np.asarray(jfilters.eval_mask(jnp.asarray(a),
                                           *theirs.as_arrays())))
    nan_rows = np.isnan(a).any(axis=1)
    assert not got[nan_rows].any()
    # the IN table cut to the slots in use, as the engine passes it
    lo, hi, vals, count = mine.as_arrays()
    width = int(mine.isin_count.max())
    np.testing.assert_array_equal(
        filters.eval_mask(tensor(a), lo, hi, vals[:, :width], count).numpy(),
        got)
    # the grouped (nlist, max_list, m) layout gives the same rows
    grouped = filters.eval_mask(tensor(a.reshape(25, 20, 4)),
                                *mine.as_arrays())
    np.testing.assert_array_equal(grouped.numpy().reshape(-1), got)


def test_as_arrays_types_and_device():
    cp = filters.compile_predicate(filters.F.isin("cat", [1.0, 4.0]), NAMES)
    lo, hi, vals, count = cp.as_arrays(torch.device("cpu"))
    assert lo.dtype == hi.dtype == vals.dtype == torch.float32
    assert count.dtype == torch.int32
    assert tuple(vals.shape) == (4, filters.MAX_ISIN)
    assert count.tolist() == [0, 0, 2, 0]


def _jax_state(mode="partition"):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(200, 16)).astype(np.float32)
    a = rng.normal(size=(200, 4)).astype(np.float32)
    cfg = JConfig(alpha=1.5, lam=0.6, mode=mode)
    jidx = jbuild(jnp.asarray(v), jnp.asarray(a), cfg)
    return jidx, rng.normal(size=(6, 16)).astype(np.float32)


@pytest.mark.parametrize("mode", ["partition", "embedding"])
def test_fold_queries_and_filters_raw_match_reference(mode):
    jidx, q = _jax_state(mode)
    index = fcvi.index_from_state(
        fcvi.FCVIConfig(alpha=1.5, lam=0.6, mode=mode),
        to_numpy_tree(jfcvi.index_state(jidx)), device="cpu")
    np.testing.assert_allclose(fcvi.filters_raw(index).numpy(),
                               np.asarray(jfcvi.filters_raw(jidx)),
                               rtol=1e-5, atol=1e-5)
    fold = np.float32([0.5, -1.0, 0.0, 2.0])
    got = fcvi.fold_queries(index, tensor(q), fold)
    want = jfcvi.fold_queries(jidx, jnp.asarray(q), fold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the transform method, with the target as a tensor: the same bits
    again = index.transform.fold_query(tensor(q), tensor(fold))
    assert torch.equal(again, got)
    assert tuple(got.shape) == q.shape
