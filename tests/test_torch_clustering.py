"""The port's k-means (``repro_torch.core.clustering``) and the cluster-mode
transform it fits.

The port draws from a ``torch.Generator`` and the JAX package from its PRNG,
so trained centers are never compared across the packages. The port's
k-means is held to its properties (determinism for a generator, labels that
are the nearest centers, centers that are their members' means, distinct
k-means++ seeds, the running ``dmin`` equal to the full recomputation), and
to the JAX package on handed-over centers: distances, assignment and the
quantization error, and the cluster-mode Transform. Tolerances: distances
and errors rtol 1e-5, atol 1e-4 (the expansion ||x||^2 - 2 x.c + ||c||^2
rounds differently across frameworks); labels equal for rows whose two
nearest centers are farther apart than that; transforms atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import clustering as jcl
from repro.core import transform as jtf
from repro_torch.core import clustering as cl
from repro_torch.core import transform as tf
from test_torch_support import normal, tensor

L2 = dict(rtol=1e-5, atol=1e-4)


def _blobs(n=900, d=8, k=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = 4.0 * normal(rng, k, d)
    return (centers[rng.integers(0, k, n)] + normal(rng, n, d)).astype(
        np.float32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_kmeans_is_deterministic_for_a_generator():
    x = tensor(_blobs())
    c1, l1 = cl.kmeans(x, 12, iters=5, generator=_gen(3))
    c2, l2 = cl.kmeans(x, 12, iters=5, generator=_gen(3))
    assert torch.equal(c1, c2) and torch.equal(l1, l2)
    c3, _ = cl.kmeans(x, 12, iters=5, generator=_gen(4))
    assert not torch.equal(c1, c3)


def test_kmeans_labels_are_nearest_centers_and_centers_member_means():
    x = tensor(_blobs())
    centers, labels = cl.kmeans(x, 10, iters=4, generator=_gen(1))
    assert labels.dtype == torch.int64
    assert torch.equal(labels, cl.assign(x, centers))
    # one Lloyd step from centers with one far outlier that draws no rows
    start = torch.cat([centers[:9], torch.full((1, 8), 1e3)])
    new = cl.lloyd_step(x, start)
    near = cl.assign(x, start)
    assert not (near == 9).any()
    assert torch.equal(new[9], start[9])            # empty: keeps its center
    for j in range(9):
        members = x[near == j]
        assert len(members)
        torch.testing.assert_close(new[j], members.mean(0), rtol=1e-5,
                                   atol=1e-5)


def test_kmeans_plus_plus_picks_distinct_corpus_rows():
    x = tensor(_blobs(n=300))
    centers = cl.kmeans_plus_plus_init(x, 40, generator=_gen(2))
    match = (centers[:, None, :] == x[None, :, :]).all(-1)      # (k, n)
    assert (match.sum(1) == 1).all()                  # each a row of x
    rows = match.float().argmax(1)
    assert len(set(rows.tolist())) == 40              # and all distinct


def test_running_dmin_equals_full_recomputation():
    x = tensor(_blobs(n=500))
    centers, dmin = cl._plus_plus(x, 25, _gen(5))
    # bit for bit against a min over every center, each column computed as
    # the running update computes it
    cols = torch.stack([cl._pairwise_sq_dists(x, centers[j:j + 1])[:, 0]
                        for j in range(25)], dim=1)
    assert torch.equal(dmin, cols.min(dim=-1).values)
    # and against the (n, k) matmul of the JAX formulation, which rounds
    # its dot products apart from the one-column products
    full = cl._pairwise_sq_dists(x, centers).min(dim=-1).values
    torch.testing.assert_close(dmin, full, **L2)
    # the chunked nearest-center pass agrees with the one-block pass
    labels, near = cl._nearest(x, centers)
    old = cl.CHUNK_ELEMS
    try:
        cl.CHUNK_ELEMS = 7 * 25       # chunks of 7 rows
        l7, n7 = cl._nearest(x, centers)
    finally:
        cl.CHUNK_ELEMS = old
    assert torch.equal(labels, l7) and torch.equal(near, n7)


def test_distances_assignment_and_error_match_jax_on_handed_centers():
    x = _blobs(n=700, d=16, k=8, seed=4)
    c = _blobs(n=20, d=16, k=8, seed=5)
    d2 = cl._pairwise_sq_dists(tensor(x), tensor(c)).numpy()
    jd2 = np.asarray(jcl._pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(d2, jd2, **L2)
    exact = ((x[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    two = np.sort(exact, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 2 * (L2["atol"] + L2["rtol"] * two[:, 1])
    assert clear.mean() > 0.95
    labels = cl.assign(tensor(x), tensor(c)).numpy()
    jlabels = np.asarray(jcl.assign(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_array_equal(labels[clear], jlabels[clear])
    np.testing.assert_allclose(
        float(cl.quantization_error(tensor(x), tensor(c))),
        float(jcl.quantization_error(jnp.asarray(x), jnp.asarray(c))),
        rtol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cluster_fit_transform_matches_jax_on_handed_centers(use_pallas):
    rng = np.random.default_rng(6)
    v = normal(rng, 400, 32)
    f = _blobs(n=400, d=8, k=5, seed=7)
    mine = tf.fit_transform(tensor(v), tensor(f), 1.5, "cluster",
                            n_clusters=5, generator=_gen(0))
    theirs = jtf.fit_transform(jnp.asarray(v), jnp.asarray(f), 1.5,
                               "cluster", n_clusters=5)
    assert mine.centers.shape == (5, 8)
    # the port's own centers: each the mean of the normalized filters
    # nearest to it after the last Lloyd step, so inside their hull
    fn = mine.filt_norm.apply(tensor(f))
    assert (mine.centers.min(0).values >= fn.min(0).values - 1e-5).all()
    handed = dataclasses.replace(mine,
                                 centers=tensor(np.asarray(theirs.centers)))
    for a, b in [(handed.vec_norm.mean, theirs.vec_norm.mean),
                 (handed.filt_norm.std, theirs.filt_norm.std)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    got = handed.apply(tensor(v), tensor(f)).numpy()
    want = np.asarray(theirs.apply(jnp.asarray(v), jnp.asarray(f),
                                   use_pallas=use_pallas))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
