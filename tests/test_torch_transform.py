"""The port's transform (psi) and theory against the JAX package.

Same numpy inputs through ``repro.core.transform`` and
``repro_torch.core.transform``. Tolerance rtol = atol = 1e-5: a few fp32
roundings per element, taken in another order by each framework. The
normalizer uses the POPULATION std (``jnp.std`` is ddof=0, ``torch.std``
defaults to ddof=1: at n=1000 that is a 5e-4 relative difference, which the
1e-5 tolerance would catch).
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import theory as jtheory
from repro.core import transform as jtf
from repro_torch.core import theory, transform as tf
from test_torch_support import normal, tensor

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(mine, theirs):
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **TOL)


def _inputs(n=1000, d=64, m=8, seed=0):
    rng = np.random.default_rng(seed)
    return (normal(rng, n, d) * 3 + 1, normal(rng, n, m) * 0.5 - 2,
            normal(rng, d, m))


def _port_of(jt):
    """The port's Transform with the JAX Transform's fitted state."""
    def norm(nz):
        return tf.Normalizer(mean=tensor(nz.mean), std=tensor(nz.std))

    return tf.Transform(
        mode=jt.mode, alpha=float(jt.alpha), vec_norm=norm(jt.vec_norm),
        filt_norm=norm(jt.filt_norm),
        centers=None if jt.centers is None else tensor(jt.centers),
        proj=None if jt.proj is None else tensor(jt.proj))


def test_normalizer_fit_uses_population_std():
    v, _, _ = _inputs()
    mine = tf.Normalizer.fit(tensor(v))
    theirs = jtf.Normalizer.fit(jnp.asarray(v))
    _close(mine.mean, theirs.mean)
    np.testing.assert_allclose(mine.std.numpy(), np.asarray(theirs.std),
                               rtol=1e-5, atol=0)
    sample_std = torch.tensor(v).std(dim=0) + 1e-6   # ddof=1: must differ
    assert not np.allclose(sample_std.numpy(), np.asarray(theirs.std),
                           rtol=1e-5, atol=0)
    x = tensor(v[:7])
    _close(mine.apply(x), theirs.apply(jnp.asarray(v[:7])))
    torch.testing.assert_close(mine.inverse(mine.apply(x)), x, rtol=1e-5,
                               atol=1e-4)
    ident = tf.Normalizer.identity(64)
    assert torch.equal(ident.apply(x), x)


def test_psi_variants_match_jax():
    v, f, w = _inputs(n=50)
    rng = np.random.default_rng(1)
    centers = normal(rng, 6, 8)
    _close(tf.psi_partition(tensor(v), tensor(f), 1.5),
           jtf.psi_partition(jnp.asarray(v), jnp.asarray(f), 1.5))
    _close(tf.psi_embedding(tensor(v), tensor(f), 1.5, tensor(w)),
           jtf.psi_embedding(jnp.asarray(v), jnp.asarray(f), 1.5,
                             jnp.asarray(w)))
    _close(tf.nearest_center(tensor(f), tensor(centers)),
           jtf.nearest_center(jnp.asarray(f), jnp.asarray(centers)))
    _close(tf.psi_cluster(tensor(v), tensor(f), 1.5, tensor(centers)),
           jtf.psi_cluster(jnp.asarray(v), jnp.asarray(f), 1.5,
                           jnp.asarray(centers)))
    with pytest.raises(ValueError):
        tf.psi_partition(tensor(v), tensor(f[:, :5]), 1.0)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["partition", "embedding", "cluster"])
def test_transform_apply_matches_jax(mode, use_pallas):
    """Partition and embedding fitted by each package; cluster served from
    the JAX package's fitted centers handed across."""
    v, f, w = _inputs(n=300)
    kw = {"cluster": dict(n_clusters=4), "embedding": dict(proj=w)}.get(
        mode, {})
    jt = jtf.fit_transform(jnp.asarray(v), jnp.asarray(f), 1.5, mode, **kw)
    if mode == "cluster":
        mine = _port_of(jt)
    else:
        mine = tf.fit_transform(tensor(v), tensor(f), 1.5, mode,
                                proj=tensor(w) if mode == "embedding" else None)
        _close(mine.vec_norm.std, jt.vec_norm.std)
        _close(mine.filt_norm.mean, jt.filt_norm.mean)
    _close(mine.projection(), jt.projection())
    _close(mine.apply(tensor(v), tensor(f)),
           jt.apply(jnp.asarray(v), jnp.asarray(f), use_pallas=use_pallas))
    vn, fn = mine.normalize(tensor(v), tensor(f))
    jvn, jfn = jt.normalize(jnp.asarray(v), jnp.asarray(f))
    _close(vn, jvn)
    _close(fn, jfn)
    _close(mine.apply_normalized(vn, fn),
           jt.apply_normalized(jvn, jfn, use_pallas=use_pallas))


def test_fit_transform_defaults_and_refusals():
    v, f, _ = _inputs(n=100)
    emb = tf.fit_transform(tensor(v), tensor(f), 1.0, "embedding")
    jemb = jtf.fit_transform(jnp.asarray(v), jnp.asarray(f), 1.0, "embedding")
    _close(emb.proj, jemb.proj)   # the tiled identity
    raw = tf.fit_transform(tensor(v), tensor(f), 1.0, normalize=False)
    assert torch.equal(raw.vec_norm.std, torch.ones(64))
    with pytest.raises(NotImplementedError, match="A8"):
        tf.fit_transform(tensor(v), tensor(f), 1.0, "cluster")
    with pytest.raises(ValueError):
        tf.fit_transform(tensor(v), tensor(f[:, :5]), 1.0, "partition")
    with pytest.raises(ValueError):
        tf.fit_transform(tensor(v), tensor(f), 1.0, "nope")


@pytest.mark.parametrize("lam", [0.05, 0.3, 0.5, 0.6, 1.0])
def test_theory_matches_jax(lam):
    assert theory.optimal_alpha(lam) == jtheory.optimal_alpha(lam)
    for k, alpha, n, c in [(10, 1.0, 10**6, 4.0), (10, 2.0, 500, 16.0),
                           (7, 1.3, 50, 8.0), (10, 1.0, 3, 4.0)]:
        assert (theory.k_prime(k, lam, alpha, n, c)
                == jtheory.k_prime(k, lam, alpha, n, c))
