"""The port's token stream (``repro_torch.data.tokens``) and int8 gradient
compression (``repro_torch.distributed.compression``) against the
reference's.

* ``MarkovTokens`` and ``global_batch_iterator`` are numpy in both
  packages: the same spec gives the same batches bit for bit.
* Compression: the same blocks, the scales bit for bit, ``compress_ratio``
  equal; the rounding noise comes from each package's own generator, so a
  code lies within one step of the reference's. The reference's own
  checks (``tests/test_compression.py``) hold on the port: the error bound
  under hypothesis, unbiasedness, the ratio, zeros and extremes.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from repro.data import tokens as jtokens  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.distributed.compression import (BLOCK,  # noqa: E402
                                                 compress_ratio,
                                                 dequantize_int8,
                                                 quantize_int8)

SPECS = [dict(vocab_size=256, batch=8, seq_len=64, seed=0, branching=4),
         dict(vocab_size=1000, batch=3, seq_len=17, seed=5),
         dict(vocab_size=64, batch=4, seq_len=32, seed=2, host_id=1,
              n_hosts=2)]


@pytest.mark.parametrize("kw", SPECS)
def test_markov_tokens_equal_the_reference_bit_for_bit(kw):
    mine = tokens.MarkovTokens(tokens.TokenSpec(**kw))
    ref = jtokens.MarkovTokens(jtokens.TokenSpec(**kw))
    np.testing.assert_array_equal(mine.succ, ref.succ)
    np.testing.assert_array_equal(mine.cum, ref.cum)
    for _, a, b in zip(range(3), mine, ref):
        assert a["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("extras", [None, {"frames": (16, 8)},
                                    {"patches": (4, 8), "frames": (2, 8)}])
def test_global_batch_iterator_equals_the_reference(extras):
    kw = SPECS[1]
    mine = tokens.global_batch_iterator(tokens.TokenSpec(**kw), extras)
    ref = jtokens.global_batch_iterator(jtokens.TokenSpec(**kw), extras)
    for _, a, b in zip(range(3), mine, ref):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4096])
def test_scales_equal_codes_within_one_step(n):
    r = np.random.default_rng(n)
    x = (3.0 * r.normal(size=(n,))).astype(np.float32)
    codes, scales, pad = quantize_int8(torch.tensor(x),
                                       torch.Generator().manual_seed(0))
    jc, js, jpad = jcomp.quantize_int8(jnp.asarray(x), jax.random.PRNGKey(0))
    assert pad == jpad and codes.dtype == torch.int8
    assert codes.shape == jc.shape and scales.dtype == torch.float32
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    assert np.abs(codes.numpy().astype(int)
                  - np.asarray(jc).astype(int)).max() <= 1
    y = dequantize_int8(codes, scales, pad, (n,), torch.float32)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jcomp.dequantize_int8(
            jnp.asarray(codes.numpy()), js, pad, (n,), jnp.float32)))


@pytest.mark.parametrize("shape", [(1024, 1024), (3, 100), (256,)])
def test_compress_ratio_equals_the_reference(shape):
    assert compress_ratio(torch.zeros(shape)) == \
        jcomp.compress_ratio(jnp.zeros(shape))


# -- the reference's own checks (tests/test_compression.py) on the port ------

@settings(max_examples=20, deadline=None)
@given(st.integers(1, 4000), st.integers(0, 2**31 - 1),
       st.floats(1e-3, 1e3))
def test_roundtrip_error_bounded(n, seed, scale):
    r = np.random.default_rng(seed)
    x = torch.tensor((scale * r.normal(size=(n,))).astype(np.float32))
    codes, scales, pad = quantize_int8(x, torch.Generator().manual_seed(seed))
    y = dequantize_int8(codes, scales, pad, x.shape, x.dtype)
    # per-element error bounded by its block scale (one quantization step)
    err = np.abs((y - x).numpy())
    limit = np.repeat(scales.numpy(), BLOCK)[:n] + 1e-12
    assert (err <= limit * 1.0001).all()


def test_stochastic_rounding_unbiased():
    x = torch.full((BLOCK,), 0.3)  # sits between quantization steps
    gen = torch.Generator().manual_seed(0)
    outs = []
    for _ in range(400):
        codes, scales, pad = quantize_int8(x, gen)
        outs.append(dequantize_int8(codes, scales, pad, x.shape,
                                    x.dtype).numpy())
    mean = np.mean(outs)
    assert abs(mean - 0.3) < 2e-3, f"biased: {mean}"


def test_compress_ratio():
    assert compress_ratio(torch.zeros((1024, 1024))) < 0.27


def test_zero_and_extreme_values():
    x = torch.zeros((BLOCK,))
    codes, scales, pad = quantize_int8(x, torch.Generator().manual_seed(0))
    y = dequantize_int8(codes, scales, pad, x.shape, x.dtype)
    np.testing.assert_allclose(y.numpy(), 0.0)
    x2 = torch.tensor([1e30, -1e30] * (BLOCK // 2))
    codes, scales, pad = quantize_int8(x2, torch.Generator().manual_seed(0))
    y2 = dequantize_int8(codes, scales, pad, x2.shape, x2.dtype)
    assert torch.isfinite(y2).all()
