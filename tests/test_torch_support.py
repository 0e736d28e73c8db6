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


def ivf_inputs(nlist, max_list, b, nprobe, d=64, m=8, seed=0, ints=False):
    """Grouped slabs (nlist, max_list, d), their squared norms, a ``valid``
    mask that is no prefix and leaves list 0 empty, (b, nprobe) probes
    (distinct per row, in no list order), queries (b, d), and grouped
    payloads (nlist, max_list, d) / (nlist, max_list, m). ``ints`` draws
    small integers, so every score is exact in fp32 and only the tie rule
    orders equal scores."""
    rng = np.random.default_rng(seed)
    if ints:
        grouped = rng.integers(-2, 3, (nlist, max_list, d)).astype(np.float32)
        q = rng.integers(-2, 3, (b, d)).astype(np.float32)
    else:
        grouped, q = normal(rng, nlist, max_list, d), normal(rng, b, d)
    valid = (rng.random((nlist, max_list)) > 0.2).astype(np.float32)
    valid[0] = 0.0
    probes = np.stack([rng.permutation(nlist)[:nprobe]
                       for _ in range(b)]).astype(np.int32)
    return (grouped, (grouped * grouped).sum(-1), valid, probes, q,
            normal(rng, nlist, max_list, d), normal(rng, nlist, max_list, m))


def probe_ties(centroids, queries, nprobe, *, rtol=1e-5, atol=1e-4):
    """(b,) bool: queries whose nprobe-th and (nprobe+1)-th coarse scores
    (-||q - c||^2, in float64) lie within the L2 tolerance, so fp32 rounding
    may give the two packages different probe sets."""
    c = np.asarray(centroids, np.float64)
    q = np.asarray(queries, np.float64)
    if nprobe >= c.shape[0]:
        return np.zeros(q.shape[0], bool)
    d2 = np.sort(((q[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
    a, b = d2[:, nprobe - 1], d2[:, nprobe]
    return (b - a) <= atol + rtol * b


def candidate_ties(vals, k, *, rtol=1e-5, atol=1e-4):
    """(b,) bool: queries whose k-th and (k+1)-th candidate scores (``vals``
    (b, > k), descending) lie within the L2 tolerance, so fp32 rounding may
    give two implementations candidate sets that differ by one row."""
    v = np.asarray(vals, np.float64)
    return np.abs(v[:, k - 1] - v[:, k]) <= atol + rtol * np.abs(v[:, k])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while a module that imports this runs: its tests
    make many small tensor ops, and the suite's workers share the cores, so
    several threads a worker spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card for ``gpu``-marked tests; skips where there is none (the
    CUDA kernels have no CPU mode). Decided here, at run time, so every
    test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def fp32_hop_step(cfg, adamw, n_micro=1, grad_shardings=None):
    """The sharded train step (``train.loop``'s ``_sharded_step``) with an
    fp32 pod hop, as the reference's step sums: the three calls the step
    makes, the sync's ``int8`` off. Called under ``use_rules`` of the
    params' mesh."""
    from repro_torch.distributed.sharding import (CollectiveStats,
                                                  current_rules)
    from repro_torch.models import model as M
    from repro_torch.train import loop

    structure = M.Model(cfg, torch.device("meta"))

    def step(params, state, batch):
        rules, stats = current_rules(), CollectiveStats()
        grads, metrics = loop.sharded_grads(cfg, structure, params, batch,
                                            rules, n_micro, stats)
        synced = loop.sync_grads(grads, params, rules, grad_shardings, None,
                                 False, stats)
        new, new_state, m = loop.sharded_update(adamw, synced, state,
                                                params, stats)
        return new, new_state, {**metrics, **m,
                                "collectives": stats.by_kind}

    return step


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
