"""Shared helpers of the port's parity tests, and tests of the helpers.

The port (``repro_torch``) is held against the JAX package (``repro``) on
the same numpy inputs: scores within a stated fp32 tolerance, and ids equal
outside near-ties. The near-tie rule follows ``brute_force_oracle`` in
``tests/test_filter_oracle.py``: an id may differ only at a slot whose
reference score lies within the tolerance of a neighbouring reference score,
where the two frameworks' fp32 rounding may order the tie either way.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref


def near_tie_mask(ref_vals, *, rtol: float, atol: float, next_vals=None):
    """(b, k) bool: slots whose reference score is within ``atol + rtol *
    |score|`` of the score before or after it. ``next_vals`` (b,) is the
    reference's (k+1)-th score; without it the last slot's successor is
    unknown, so the last slot counts as a near-tie."""
    ref = np.asarray(ref_vals, np.float64)
    b = ref.shape[0]
    tail = (np.full((b, 1), np.nan) if next_vals is None
            else np.asarray(next_vals, np.float64).reshape(b, 1))
    prev = np.concatenate([np.full((b, 1), np.inf), ref[:, :-1]], axis=1)
    nxt = np.concatenate([ref[:, 1:], tail], axis=1)
    tol = atol + rtol * np.abs(ref)
    with np.errstate(invalid="ignore"):
        amb = (np.abs(ref - prev) <= tol) | (np.abs(nxt - ref) <= tol)
    amb[:, -1] |= np.isnan(tail[:, 0])
    return amb


def assert_topk_match(ref_vals, ref_ids, vals, ids, *, rtol: float,
                      atol: float, next_vals=None):
    """Scores allclose everywhere; ids equal at every slot that is not a
    near-tie of the reference (see ``near_tie_mask``)."""
    ref_vals = np.asarray(ref_vals, np.float32)
    vals = np.asarray(vals, np.float32)
    np.testing.assert_allclose(vals, ref_vals, rtol=rtol, atol=atol)
    amb = near_tie_mask(ref_vals, rtol=rtol, atol=atol, next_vals=next_vals)
    same = np.asarray(ids, np.int64) == np.asarray(ref_ids, np.int64)
    bad = ~same & ~amb
    assert not bad.any(), (
        f"{int(bad.sum())} id(s) differ outside near-ties at "
        f"{np.argwhere(bad)[:5].tolist()}")


def to_numpy_tree(tree):
    """A nested dict of JAX arrays -> the same dict of numpy arrays, for
    handing an index state across."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# -- inputs made from a seed with numpy --------------------------------------

def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def tensor(x, device="cpu"):
    return torch.tensor(np.asarray(x), device=device)


def transform_inputs(n, d, m, embedding, seed=0):
    rng = np.random.default_rng(seed)
    v, f = normal(rng, n, d), normal(rng, n, m)
    proj = (normal(rng, m, d) if embedding
            else ref.partition_matrix(d, m).numpy())
    norms = (normal(rng, d), 0.5 + rng.random(d).astype(np.float32),
             normal(rng, m), 0.5 + rng.random(m).astype(np.float32))
    return v, f, proj, norms


def scan_inputs(n, b, d=64, m=8, seed=0):
    rng = np.random.default_rng(seed)
    x = normal(rng, n, d)
    return (x, (x * x).sum(-1), normal(rng, b, d), normal(rng, n, d),
            normal(rng, n, m))


def tie_inputs(n=600, b=4, d=16):
    """Small-integer rows with every row duplicated: all dot products and
    norms are exact in fp32, so equal scores are exactly equal in both
    frameworks and the first-occurrence rule alone decides the ids."""
    rng = np.random.default_rng(5)
    half = rng.integers(-2, 3, size=(n // 2, d)).astype(np.float32)
    x = np.concatenate([half, half[::-1]])
    q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    return x, (x * x).sum(-1), q


@pytest.fixture
def cuda():
    """The card for ``gpu``-marked tests; skips where there is none (the
    CUDA kernels have no CPU mode). Decided here, at run time, so every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_near_tie_mask_flags_neighbours_within_tolerance():
    ref = np.array([[5.0, 4.0, 3.99999, 1.0]], np.float32)
    amb = near_tie_mask(ref, rtol=0.0, atol=1e-4, next_vals=[0.0])
    assert amb.tolist() == [[False, True, True, False]]
    amb = near_tie_mask(ref, rtol=0.0, atol=1e-4)
    assert amb[0, -1]


def test_assert_topk_match_accepts_tie_swap_rejects_real_mismatch():
    ref_v = np.array([[5.0, 4.0, 4.0, 1.0]], np.float32)
    ref_i = np.array([[7, 3, 9, 2]])
    assert_topk_match(ref_v, ref_i, ref_v, [[7, 9, 3, 2]], rtol=0, atol=1e-6,
                      next_vals=[0.0])
    with pytest.raises(AssertionError):
        assert_topk_match(ref_v, ref_i, ref_v, [[8, 3, 9, 2]], rtol=0,
                          atol=1e-6, next_vals=[0.0])
