"""The LM layers of the port (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the same numpy inputs from a seed.

Tolerances: the fp32 functions (norms on fp32 input, RoPE angles,
sinusoidal positions, softcap, the unembedding's fp32 product) rtol 1e-6 /
atol 1e-5; bf16 outputs are compared in fp32 at rtol = atol = 1e-2 and, where
both packages round the same ops in the same order (the norms, RoPE, the
activations, a bf16 scalar product), bit for bit. ``jax.nn.gelu`` is the
tanh approximation and XLA rounds each of its bf16 steps: the port's
``gelu`` and ``silu`` follow that order and equal them bit for bit, where
an fp32 activation rounded once differs in about 40% of the elements.
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

RTOL = ATOL = 1e-2


def _np(x):
    """A JAX or torch array as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.tensor(_np(j)).to(getattr(torch, dtype))


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_layer_norm(dtype):
    r = _rng()
    x = (3 * r.normal(size=(2, 7, 64)) + 0.5).astype(np.float32)
    jx, tx = _both(x, dtype)
    scale = r.normal(size=64).astype(np.float32)
    bias = r.normal(size=64).astype(np.float32)
    got = L.rms_norm(tx, torch.tensor(scale))
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, jx)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-5)
    got = L.layer_norm(tx, torch.tensor(scale), torch.tensor(bias))
    want = JL.layer_norm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jx)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-5)
    # the modules start where the reference's inits do: rms 0, ln 1 / 0
    rms, ln = L.RMSNorm(64), L.LayerNorm(64)
    rms.reset_parameters()
    ln.reset_parameters()
    np.testing.assert_array_equal(_np(rms.scale),
                                  _np(JL.init_rmsnorm(64)["scale"]))
    init = JL.init_layernorm(64)
    np.testing.assert_array_equal(_np(ln.scale), _np(init["scale"]))
    np.testing.assert_array_equal(_np(ln.bias), _np(init["bias"]))
    with torch.no_grad():
        np.testing.assert_allclose(_np(rms(tx)), _np(
            JL.rms_norm(JL.init_rmsnorm(64), jx)), rtol=1e-6, atol=1e-5)


def test_rms_norm_scales_by_one_plus_scale():
    """Gemma's convention, not ``nn.RMSNorm``'s: a zero scale is the
    identity scaling."""
    x = torch.tensor(_rng(1).normal(size=(3, 16)).astype(np.float32))
    want = x / torch.sqrt(torch.mean(x * x, -1, keepdim=True) + 1e-6)
    torch.testing.assert_close(L.rms_norm(x, torch.zeros(16)), want,
                               rtol=1e-6, atol=1e-6)


def test_embed_and_unembed_tied_and_untied():
    r = _rng(2)
    table = r.normal(size=(256, 64)).astype(np.float32) / 8
    head = r.normal(size=(64, 256)).astype(np.float32) / 8
    tokens = r.integers(0, 256, (2, 9)).astype(np.int32)
    want = JL.embed({"embedding": jnp.asarray(table)}, jnp.asarray(tokens))
    for tok in (torch.tensor(tokens), torch.tensor(tokens).long()):
        got = L.embed(torch.tensor(table), tok)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))
    x = r.normal(size=(2, 9, 64)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    want = JL.unembed({}, jx, tied_embedding=jnp.asarray(table))
    got = L.unembed(tx, torch.tensor(table).T)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-5)
    want = JL.unembed({"lm_head": jnp.asarray(head)}, jx)
    np.testing.assert_allclose(_np(L.unembed(tx, torch.tensor(head))),
                               _np(want), rtol=1e-6, atol=1e-5)


def test_dot_f32_keeps_every_bf16_product():
    """bf16 operands, fp32 product: the widened operands multiply exactly,
    so the result is the reference's up to the order of the fp32 sum."""
    r = _rng(3)
    a = r.normal(size=(33, 300)).astype(np.float32)
    b = r.normal(size=(300, 17)).astype(np.float32)
    ja, ta = _both(a, "float32")
    jb, tb = _both(b, "float32")
    want = jnp.dot(ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    np.testing.assert_allclose(_np(L.dot_f32(ta, tb)), _np(want),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_split_halves(theta, dtype):
    r = _rng(4)
    x = r.normal(size=(2, 11, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(11), 1000 + 7 * np.arange(11)]).astype(np.int32)
    jx, tx = _both(x, dtype)
    np.testing.assert_array_equal(_np(L.rope_freqs(16, theta)),
                                  _np(JL.rope_freqs(16, theta)))
    got = L.apply_rope(tx, torch.tensor(pos), theta)
    want = JL.apply_rope(jx, jnp.asarray(pos), theta)
    assert got.dtype == tx.dtype
    if dtype == "bfloat16":
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    # split halves: dims i and i + dh/2 rotate together, position 0 is the
    # identity
    t0 = torch.tensor(x[:1, :1])
    torch.testing.assert_close(L.apply_rope(t0, torch.zeros(1, 1,
                                                            dtype=torch.int32),
                                            theta), t0)


def test_sinusoidal_positions():
    np.testing.assert_allclose(_np(L.sinusoidal_positions(50, 64)),
                               _np(JL.sinusoidal_positions(50, 64)),
                               rtol=1e-6, atol=1e-5)


def test_gelu_is_the_tanh_form_rounded_as_the_reference():
    x = (3 * _rng(5).normal(size=(20000,))).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    want = _np(jax.nn.gelu(jx))
    np.testing.assert_array_equal(_np(L.gelu(tx)), want)
    np.testing.assert_array_equal(_np(L.silu(tx)), _np(jax.nn.silu(jx)))
    # torch's own gelu: exact erf unless asked; tanh in fp32 rounded once
    # differs from the reference's bf16 steps in many elements
    exact = _np(torch.nn.functional.gelu(tx.float()))
    assert np.abs(exact - _np(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4
    fused = _np(torch.nn.functional.gelu(tx.float(), approximate="tanh")
                .bfloat16())
    assert (fused != want).mean() > 0.2
    # in fp32 the port's gelu is the tanh form
    jf, tf = _both(x, "float32")
    np.testing.assert_allclose(_np(L.gelu(tf)), _np(jax.nn.gelu(jf)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    r = _rng(6)
    params = JL.init_mlp(jax.random.PRNGKey(1), 64, 128, kind)
    mlp = L.MLP(64, 128, kind)
    mlp.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in params.items()})
    x = r.normal(size=(2, 13, 64)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    with torch.no_grad():
        got = mlp(tx)
    want = JL.apply_mlp(params, jx, kind)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    # the port's draws: the reference's shapes and stds
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    for name, leaf in params.items():
        p = getattr(mlp, name)
        assert tuple(p.shape) == leaf.shape
        assert float(p.detach().std()) == pytest.approx(float(jnp.std(leaf)), rel=0.05)


def test_mlp_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown mlp kind"):
        L.MLP(8, 16, "relu")


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap(cap):
    x = (40 * _rng(7).normal(size=(4, 100))).astype(np.float32)
    jx, tx = _both(x, "float32")
    np.testing.assert_allclose(_np(L.softcap(tx, cap)),
                               _np(JL.softcap(jx, cap)), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("d", [64, 1152, 2560, 4608])
def test_bf16_times_python_float_rounds_the_factor_as_jax(d):
    """``embed_scale``: JAX rounds sqrt(d) to bf16 before the product (a
    weak type); torch's ``x * float`` would not."""
    x = _rng(8).normal(size=(500,)).astype(np.float32)
    jx, tx = _both(x, "bfloat16")
    want = _np(jx * math.sqrt(d))
    np.testing.assert_array_equal(_np(tx * L.weak_scalar(tx, math.sqrt(d))),
                                  want)
    if d == 1152:
        assert (_np(tx * math.sqrt(d)) != want).any()
