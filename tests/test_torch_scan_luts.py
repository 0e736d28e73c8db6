"""The PQ scan LUT (``ops.pq_scan_luts``) against the JAX package's LUTs.

On the CPU the op runs its plain version, ``ref.ref_pq_scan_luts``: every
dsub sum in column order of rounded products, then the three element-wise
steps, each one rounded fp32 op. It is held against ``jpq.compute_luts``
(``use_pallas`` False and True, the Pallas cross term in interpret mode,
reshaped to the port's (q, M, ncoarse * ksub) layout) and against the chain
of torch ops it replaced (B8's einsum, ``torch.sum`` of the squared
residuals, the broadcast sums), each within the L2 tolerance (rtol 1e-5,
atol 1e-4: the sums run in other orders), on handed-over state and numpy
inputs from a seed; and bit for bit against a numpy emulation of its stated
order. Shapes: the JAX tests' (d=32, M=8, ksub=32, ncoarse=8, 40 queries)
and a codebook past a block's shared memory (ksub=1024, dsub=64: 256 KB a
subspace). The kernel is held to the plain version bit for bit on the card
(``tests/test_torch_gpu.py``).
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.index import pq as jpq
from repro_torch.index import pq
from repro_torch.kernels import _build, ops, pq_lut, ref
from test_torch_support import normal, tensor

L2 = dict(rtol=1e-5, atol=1e-4)
# (queries, M, ncoarse, ksub, dsub)
SHAPES = {"jax_tests": (40, 8, 8, 32, 4), "wide_codebook": (3, 2, 4, 1024, 64)}


def state(shape, seed=0):
    """(queries (q, d), codebooks, coarse centres, coarse ids, codes) as
    numpy float32 / int32, from a seed."""
    nq, m, ncoarse, ksub, dsub = shape
    rng = np.random.default_rng(seed)
    d = m * dsub
    n = 50
    return (normal(rng, nq, d), normal(rng, m, ksub, dsub),
            normal(rng, ncoarse, d) * 2.0,
            rng.integers(0, ncoarse, n).astype(np.int32),
            rng.integers(0, ksub, (n, m)).astype(np.int32))


def handed(shape, seed=0):
    """(the port's PQIndex, the JAX PQIndex on the same arrays, queries)."""
    q, cb, cen, cid, codes = state(shape, seed)
    idx = pq.from_arrays(*(tensor(a) for a in (cb, codes, cen, cid)))
    jidx = jpq.PQIndex(jnp.asarray(cb), jnp.asarray(codes), jnp.asarray(cen),
                       jnp.asarray(cid), jnp.asarray(idx.cb_sq.numpy()),
                       jnp.asarray(idx.coarse_dot.numpy()))
    return idx, jidx, q


def chain(idx, q):
    """The LUTs as the torch ops around B8 built them before the op."""
    b = q.shape[0]
    m, ksub, dsub = idx.codebooks.shape
    q_dot = ref.ref_pq_lut_qdot(q.reshape(b, m, dsub), idx.codebooks)
    qres = q[:, None, :] - idx.coarse_centers[None]
    qres_sq = torch.sum(qres.reshape(b, idx.ncoarse, m, dsub) ** 2,
                        dim=-1).transpose(1, 2)
    cdot = idx.coarse_dot.transpose(0, 1)[None]
    luts = (qres_sq[..., None] - 2.0 * (q_dot[:, :, None, :] - cdot)
            + idx.cb_sq[None, :, None, :])
    return luts.reshape(b, m, -1)


def terms(idx):
    return idx.codebooks, idx.coarse_centers, idx.coarse_dot, idx.cb_sq


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_scan_luts_match_jax_and_the_chain(shape, use_pallas):
    idx, jidx, q = handed(SHAPES[shape])
    nq, m, ncoarse, ksub, _ = SHAPES[shape]
    _build.reset_launch_counts()
    got = ops.pq_scan_luts(tensor(q), *terms(idx))
    assert _build.launch_counts() == {}            # the CPU makes no launch
    assert got.shape == (nq, m, ncoarse * ksub) and got.dtype == torch.float32
    torch.testing.assert_close(got, chain(idx, tensor(q)), **L2)
    want = np.asarray(jpq.compute_luts(jidx, jnp.asarray(q),
                                       use_pallas=use_pallas))
    want = want.transpose(0, 2, 1, 3).reshape(nq, m, ncoarse * ksub)
    np.testing.assert_allclose(got.numpy(), want, **L2)
    # scan_luts and compute_luts go through the op
    assert torch.equal(pq.scan_luts(idx, tensor(q)), got)
    assert torch.equal(pq.compute_luts(idx, tensor(q)),
                       got.reshape(nq, m, ncoarse, ksub).transpose(1, 2))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_scan_luts_follow_their_stated_order(shape):
    """The plain version's bits are a numpy float32 emulation of its order
    (the first product, each next one added; then (qres_sq - 2 (q_dot -
    coarse_dot)) + cb_sq): the order the kernel follows op for op. -0.0
    entries in the queries and codebooks keep their signs' arithmetic."""
    idx, _, q = handed(SHAPES[shape], seed=1)
    q[:, ::3] = -0.0
    cb = idx.codebooks.numpy().copy()
    cb[:, :, ::2] = -0.0
    idx = pq.from_arrays(tensor(cb), idx.codes, idx.coarse_centers,
                         idx.coarse_ids)
    nq, m, ncoarse, ksub, dsub = SHAPES[shape]
    qs = q.reshape(nq, m, 1, dsub)
    q_dot = qs[..., 0] * cb[None, :, :, 0]
    for t in range(1, dsub):
        q_dot = q_dot + qs[..., t] * cb[None, :, :, t]
    res = q.reshape(nq, 1, m, dsub) - idx.coarse_centers.numpy().reshape(
        1, ncoarse, m, dsub)
    sq = res * res
    qres = sq[..., 0]
    for t in range(1, dsub):
        qres = qres + sq[..., t]
    cdot = idx.coarse_dot.numpy().transpose(1, 0, 2)[None]
    want = ((qres.transpose(0, 2, 1)[..., None]
             - np.float32(2.0) * (q_dot[:, :, None, :] - cdot))
            + idx.cb_sq.numpy()[None, :, None, :])
    assert want.dtype == np.float32
    got = ops.pq_scan_luts(tensor(q), *terms(idx)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.reshape(nq, m, -1).view(np.int32))


@pytest.mark.parametrize("b,m,ksub,dsub,ncoarse", [
    (64, 8, 256, 16, 32), (16, 8, 256, 16, 32), (1, 8, 256, 16, 32),
    (64, 8, 256, 16, 1024), (16, 4, 4096, 64, 32), (1, 2, 4096, 120, 1),
    (5, 3, 13, 5, 7), (130, 1, 16, 960, 3), (64, 8, 256, 16, 0)])
def test_luts_plan_takes_every_shape(b, m, ksub, dsub, ncoarse):
    """The kernel's launch shape at the serving batch and the escalation's,
    b=1, a thousand coarse ids, codebooks past shared memory, a ksub that
    is no multiple of 4 (scalar stores), a dsub of 960 and the cross term
    alone (ncoarse = 0): shared memory within the target, the grid over
    every (query, codeword, coarse id) once, covering the SMs where the
    table has the blocks for it."""
    p = pq_lut.luts_plan(b, m, ksub, dsub, ncoarse, 132)
    assert p.smem == pq_lut.luts_smem(p.qt, p.kc, p.cr, dsub)
    assert p.smem <= pq_lut.LUT_SMEM_TARGET
    assert p.vec == (ksub % 4 == 0) and (not p.vec or p.kc % 4 == 0)
    assert 1 <= p.qt <= min(b, pq_lut.LUT_QT) and 1 <= p.kc <= ksub
    csplits = -(-ncoarse // p.cr) if ncoarse else 1
    assert p.blocks == -(-b // p.qt) * -(-ksub // p.kc) * csplits
    if ncoarse:
        assert 1 <= p.cr <= ncoarse
        assert p.blocks * m >= min(132, -(-b // p.qt) * -(-ksub // p.kc)
                                   * ncoarse * m)
    else:
        assert p.cr == 0
    with pytest.raises(ValueError):
        pq_lut.luts_plan(0, m, ksub, dsub, ncoarse, 132)
