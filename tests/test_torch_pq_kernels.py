"""The port's PQ kernel modules (B8, B9, B10) against the JAX package's.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions; they
are held against ``repro.kernels.ops`` with the Pallas kernels in interpret
mode (``use_pallas=True``) and with the jnp references (``False``), on the
same numpy operands, at the JAX tests' PQ shapes (d=32, M=8, ksub=32,
ncoarse=8, so a combined LUT is 8 x 256 wide) and at b = 1 and a ragged n.
Tolerances: rtol = atol = 1e-5 (B8's dot products and the jnp reference's
sum round differently); the ADC sums are left-to-right fp32 sums in both the
port and the Pallas kernel, which adds one LUT value per subspace, so B9 and
B10 match the kernel path to that tolerance and the port's own in-order sum
exactly. uint8 and int32 codes give the same sums bit for bit. Each CUDA
kernel is held against its plain version in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from jax import lax
from repro.kernels import ops as jops
from repro_torch.kernels import _build, ops, pq_lut, ref
from test_torch_support import normal, tensor

TOL = dict(rtol=1e-5, atol=1e-5)


def adc_inputs(n, m, k, b, seed=0):
    """codes (n, m) int32 in [0, k) and luts (b, m, k) float32."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    luts = rng.random((b, m, k)).astype(np.float32)
    return codes, luts


def in_order_sum(codes, lut):
    """The left-to-right fp32 sum over m of lut[m, codes[:, m]] (numpy)."""
    total = np.zeros(codes.shape[0], np.float32)
    for m in range(codes.shape[1]):
        total = total + lut[m][codes[:, m]]
    return total


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("b,m,dsub,ksub", [(64, 8, 4, 32), (1, 8, 4, 32),
                                           (5, 4, 16, 32), (130, 2, 8, 16)])
def test_pq_lut_qdot_matches_jax(use_pallas, b, m, dsub, ksub):
    rng = np.random.default_rng(b + ksub)
    qs, cb = normal(rng, b, m, dsub), normal(rng, m, ksub, dsub)
    got = ops.pq_lut_qdot(tensor(qs), tensor(cb))
    want = jops.pq_lut_qdot(jnp.asarray(qs), jnp.asarray(cb),
                            use_pallas=use_pallas)
    assert got.shape == (b, m, ksub) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,m,k,b", [(2500, 8, 256, 5), (4099, 8, 256, 1),
                                     (500, 4, 32, 3)])
def test_pq_score_batch_matches_jax(use_pallas, n, m, k, b):
    """Combined-code widths (K = ncoarse * ksub = 256), b = 1 and rows that
    are no multiple of the Pallas row block."""
    codes, luts = adc_inputs(n, m, k, b, seed=n + b)
    got = ops.pq_score_batch(tensor(codes), tensor(luts))
    want = jops.pq_score_batch(jnp.asarray(codes), jnp.asarray(luts),
                               use_pallas=use_pallas)
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(b):
        np.testing.assert_array_equal(got[i].numpy(),
                                      in_order_sum(codes, luts[i]))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,m,k", [(1024, 8, 32), (512, 4, 256)])
def test_pq_score_matches_jax(use_pallas, n, m, k):
    """n divides the Pallas kernel's 512-row block (it raises otherwise)."""
    codes, luts = adc_inputs(n, m, k, 1, seed=m)
    got = ops.pq_score(tensor(codes), tensor(luts[0]))
    want = jops.pq_score(jnp.asarray(codes), jnp.asarray(luts[0]),
                         use_pallas=use_pallas)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_pq_score_ragged_n_matches_in_order_sum(n):
    """Row counts the JAX kernel refuses: the port takes any n."""
    codes, luts = adc_inputs(n, 8, 256, 1, seed=n)
    got = ops.pq_score(tensor(codes), tensor(luts[0]))
    np.testing.assert_array_equal(got.numpy(), in_order_sum(codes, luts[0]))
    batch = ops.pq_score_batch(tensor(codes), tensor(luts))
    assert torch.equal(batch[0], got)


def test_uint8_and_int32_codes_give_the_same_sums():
    """uint8 codes are widened before every gather: a uint8 index tensor
    would be taken as a boolean mask. n == K makes the shapes line up, the
    case where a mask would index without an error."""
    codes, luts = adc_inputs(256, 8, 256, 3, seed=7)
    c8, c32 = tensor(codes.astype(np.uint8)), tensor(codes)
    assert torch.equal(ops.pq_score_batch(c8, tensor(luts)),
                       ops.pq_score_batch(c32, tensor(luts)))
    assert torch.equal(ops.pq_score(c8, tensor(luts[1])),
                       ops.pq_score(c32, tensor(luts[1])))
    np.testing.assert_array_equal(ops.pq_score(c8, tensor(luts[1])).numpy(),
                                  in_order_sum(codes, luts[1]))


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 80), (5000, 320),
                                 (64, 64)])
def test_topk_first_packed_equals_stable_sort(n, k):
    """The ADC top-k keeps the first occurrence like ``lax.top_k``: small
    integers tie often. Row 0 holds -0.0 and +0.0, which ``lax.top_k``
    orders by sign and ``topk_first`` counts equal; elsewhere the two
    agree."""
    rng = np.random.default_rng(n + k)
    x = tensor(rng.integers(-6, 6, (5, n)).astype(np.float32) * 0.25)
    x[0, :3] = tensor([0.0, -0.0, 0.0])
    x[1] = tensor(normal(rng, n) * 1e30)
    vals, pos = ref.topk_first_packed(x, k)
    want_v, want_p = ref.topk_first(x[1:], k)
    assert torch.equal(vals[1:], want_v) and torch.equal(pos[1:], want_p)
    jv, jp = lax.top_k(jnp.asarray(x.numpy()), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))


def test_pq_wrapper_shape_checks_and_cpu_dispatch():
    codes, luts = adc_inputs(300, 8, 64, 2)
    _build.reset_launch_counts()
    ops.pq_score_batch(tensor(codes), tensor(luts))
    ops.pq_score(tensor(codes), tensor(luts[0]))
    ops.pq_lut_qdot(tensor(luts[:, :, :4]).contiguous(),
                    tensor(normal(np.random.default_rng(0), 8, 16, 4)))
    assert _build.launch_counts() == {}
    assert pq_lut.qdot_smem(256, 16) == 4 * (256 * 17 + 8 * 16)
    with pytest.raises(ValueError, match="uint8 or int32"):
        pq_lut.pq_score_batch(tensor(codes).long(), tensor(luts))
    with pytest.raises(ValueError, match="3-D"):
        pq_lut.pq_lut_qdot(tensor(luts[0]), tensor(luts))
    with pytest.raises(ValueError, match="shared memory"):
        pq_lut.pq_lut_qdot(torch.zeros(2, 1, 64), torch.zeros(1, 4096, 64))
