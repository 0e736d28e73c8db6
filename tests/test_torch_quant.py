"""The port's int8 quantization and bf16 handoff against the JAX package.

``repro_torch.index.quant`` is a copy of ``repro.index.quant`` in PyTorch:
on the same fp32 numpy rows the codes, scales and dequantized rows are bit
for bit the reference's (``torch.round`` and ``jnp.round`` both round half
to even), including all-zero and constant rows, saturating outliers and an
empty (0, d) input. The squared norms of the dequantized rows agree to rtol
1e-6: the two frameworks sum the d squares in different orders.

The bf16 rung is a plain cast, round to nearest even in both frameworks,
and the JAX package's bf16 leaves reach the port as numpy arrays of
``ml_dtypes.bfloat16``, which ``fcvi._tensor`` takes by bit pattern.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.index import quant as jquant
from repro_torch.core import fcvi
from repro_torch.index import quant
from test_torch_support import normal, tensor


def _rows(kind, d=32):
    rng = np.random.default_rng(7)
    if kind == "random":
        return (normal(rng, 300, d)
                * rng.uniform(1e-3, 1e3, (300, 1)).astype(np.float32))
    if kind == "degenerate":   # all-zero, constant and one-hot rows
        x = np.zeros((6, d), np.float32)
        x[1], x[2], x[3] = 3.5, -0.25, 1e-20
        x[4, 5], x[5, 0] = -7.0, 127.0
        return x
    if kind == "outliers":     # saturating outliers: never clip, never wrap
        x = normal(rng, 8, d)
        x[:, 0] = [1e30, -1e30, 1e8, 127.0, 1e-30, 5e37, -5e37, 0.0]
        return x
    return np.zeros((0, d), np.float32)


@pytest.mark.parametrize("kind", ["random", "degenerate", "outliers",
                                  "empty"])
def test_quantize_dequantize_match_jax_bit_for_bit(kind):
    x = _rows(kind)
    codes, scales = quant.quantize_rows(tensor(x))
    jcodes, jscales = jquant.quantize_rows(jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert codes.shape == x.shape and scales.shape == x.shape[:1]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    deq = quant.dequantize_rows(codes, scales)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jquant.dequantize_rows(jcodes, jscales)))
    assert np.abs(codes.numpy().astype(np.int32)).max(initial=0) <= 127
    assert torch.isfinite(scales).all() and torch.isfinite(deq).all()
    with np.errstate(over="ignore"):
        want = np.asarray(jquant.sq_norms_of(jcodes, jscales))
    # atol: XLA on the CPU flushes subnormal results (the 1e-20 row's
    # squares) to zero, PyTorch keeps them
    np.testing.assert_allclose(quant.sq_norms_of(codes, scales).numpy(), want,
                               rtol=1e-6, atol=1e-37)


def test_zero_range_rows_get_unit_scale_and_zero_codes():
    codes, scales = quant.quantize_rows(tensor(_rows("degenerate")))
    assert scales[0] == 1.0 and (codes[0] == 0).all()
    # constant rows round-trip exactly: every element is the row max
    deq = quant.dequantize_rows(codes, scales)
    assert (deq[1] == 3.5).all() and (deq[2] == -0.25).all()


def test_round_half_to_even_like_jax():
    """Scale 1.0 (the row max is 127): x / scale lands on halves, which
    both frameworks round to the even neighbour."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]], np.float32)
    codes, scales = quant.quantize_rows(tensor(x))
    assert scales.item() == 1.0
    assert codes.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jquant.quantize_rows(jnp.asarray(x))[0]))


def test_is_quantized():
    assert quant.is_quantized(torch.int8) and quant.is_quantized("int8")
    for dtype in (None, torch.bfloat16, torch.float32, "bfloat16"):
        assert not quant.is_quantized(dtype)


def test_bf16_cast_matches_jax_bit_for_bit():
    """fp32 -> bf16 rounds to nearest even in both frameworks, ties
    included (the second row sits exactly halfway between bf16 values)."""
    rng = np.random.default_rng(3)
    x = normal(rng, 200, 32) * rng.uniform(1e-3, 1e3, (200, 1)).astype(
        np.float32)
    # 1 + j/256: odd j are exact ties
    x[1] = 1.0 + np.arange(1, 33, dtype=np.float32) / np.float32(256.0)
    mine = tensor(x).to(torch.bfloat16)
    theirs = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(mine.view(torch.int16).numpy(),
                                  theirs.view(np.int16))


def test_bf16_numpy_handoff_keeps_the_bit_pattern():
    """The JAX package's bf16 arrays become numpy arrays of
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses; the port
    takes their 16-bit words as torch bfloat16, copied, on either side of a
    requested cast."""
    rng = np.random.default_rng(4)
    x = normal(rng, 50, 16)
    a = np.array(jnp.asarray(x).astype(jnp.bfloat16))  # writable copy
    assert a.dtype.name == "bfloat16"
    with pytest.raises(TypeError):
        torch.from_numpy(a)
    t = fcvi._tensor(a, torch.device("cpu"), None)
    assert t.dtype == torch.bfloat16 and t.shape == a.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    up = fcvi._tensor(a, torch.device("cpu"))        # the default fp32
    assert up.dtype == torch.float32 and torch.equal(up, t.float())
    a.view(np.int16)[0, 0] ^= 1                      # the tensor is a copy
    assert t.view(torch.int16)[0, 0].item() != int(a.view(np.int16)[0, 0])
