"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``, meshless: one dispatch group) on the same numpy
inputs and the same weights.

Tolerances, and why:

* routing: the experts each token picks, each pair's slot, the capacity
  and the kept (token, expert) set equal the reference's exactly, at
  capacity 8.0 (nothing dropped), the default 1.25 and 0.5 (which must
  drop pairs: the same ones);
* the output: bit for bit given the reference's gates: bf16 products
  with fp32 accumulation over one expert's slots, the op-by-op bf16
  ``silu(g) * h``, and the combine's bf16 adds in the order k = 0, 1, ...
  With the port's own gates, at most one bf16 ulp of the row's largest
  magnitude apart (2^-7 of it; the k terms' sum may cancel) in fewer
  than 1 element in 1,000: the router's fp32 sums run
  in another order than XLA's, which moves no pick here but may move a
  gate by an ulp;
* the gates and the router's probabilities (fp32 sums of 4
  to 40 terms in another order, up to two ulps): rtol 2e-6; the aux
  loss: rtol 1e-6.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as JMoE  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# (d, d_ff, experts, top_k): reduced granite/dbrx, then each one's routing
# (40 experts top-8, 16 top-4) at a narrow width
SHAPES = {"reduced": (64, 64, 4, 2), "granite": (64, 32, 40, 8),
          "dbrx": (64, 32, 16, 4)}
CAPACITIES = (8.0, 1.25, 0.5)
B, S = 2, 40


@functools.lru_cache(maxsize=None)
def _case(shape):
    d, f, e, k = SHAPES[shape]
    params = JMoE.init_moe(jax.random.PRNGKey(3), d, f, e)
    mod = moe.MoE(d, f, e)
    mod.load_state_dict({n: torch.tensor(np.asarray(v))
                         for n, v in params.items()})
    x = np.random.default_rng(1).normal(size=(B, S, d)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    return params, mod.requires_grad_(False), xb, k


def _torch_bf16(xb):
    return torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()


@functools.lru_cache(maxsize=None)
def _reference(shape, cf):
    """The reference's output and aux, and its routing recomputed with its
    own expressions: (probs, gates, experts, pos, keep, capacity)."""
    params, _, xb, k = _case(shape)
    y, aux = JMoE.apply_moe(params, xb, top_k=k, capacity_factor=cf,
                            return_aux=True)
    e = params["w_router"].shape[-1]
    t = B * S
    xt = xb.reshape(t, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt.astype(jnp.float32),
                                      params["w_router"]), axis=-1)
    gates, experts = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(jnp.sum(gates, axis=-1, keepdims=True), 1e-9)
    cap = max(8, min(int(cf * t * k / e), t))
    flat = experts.reshape(-1)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return (np.asarray(y.astype(jnp.float32)), float(aux),
            tuple(np.asarray(a) for a in (probs, gates, experts, pos,
                                          pos < cap)), cap)


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_routing_capacity_and_kept_set_equal_the_reference(shape, cf):
    params, mod, xb, k = _case(shape)
    _, _, (probs, gates, experts, pos, keep), cap = _reference(shape, cf)
    e = SHAPES[shape][2]
    assert moe.capacity(cf, B * S, k, e) == cap
    got = moe.route(mod, _torch_bf16(xb).reshape(B * S, -1), k, cap)
    np.testing.assert_allclose(got[0].numpy(), probs, rtol=2e-6, atol=0)
    np.testing.assert_allclose(got[1].numpy(), gates, rtol=2e-6, atol=0)
    np.testing.assert_array_equal(got[2].numpy(), experts)
    np.testing.assert_array_equal(got[3].numpy(), pos)
    np.testing.assert_array_equal(got[4].numpy(), keep)
    dropped = int((~keep).sum())
    if cf == 8.0:
        assert dropped == 0
    if cf == 0.5:
        assert dropped > 0, "capacity 0.5 must drop pairs"


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_apply_moe_bit_equal_to_the_reference(shape, cf, monkeypatch):
    """Bit for bit given the reference's gates (the dispatch, the expert
    products and the combine's order); with the port's own gates, which
    may differ from XLA's in the last fp32 bit, an element may round to
    the next bf16 value."""
    params, mod, xb, k = _case(shape)
    want, want_aux, (_, gates, _, _, keep), _ = _reference(shape, cf)
    y, aux = moe.apply_moe(mod, _torch_bf16(xb), top_k=k,
                           capacity_factor=cf, return_aux=True)
    assert y.dtype == torch.bfloat16 and y.shape == (B, S, xb.shape[-1])
    got = y.float().numpy()
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 2.0 ** -7 * row).all()
    assert (got != want).mean() < 1e-3
    assert float(aux) == pytest.approx(want_aux, rel=1e-6)
    assert torch.equal(moe.apply_moe(mod, _torch_bf16(xb), top_k=k,
                                     capacity_factor=cf), y)
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: (
        lambda r: (r[0], torch.tensor(gates), *r[2:]))(route(*a)))
    same = moe.apply_moe(mod, _torch_bf16(xb), top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(same.float().numpy(), want)
    # a token whose every pair was dropped passes through as zeros
    gone = ~keep.reshape(B * S, k).any(axis=1)
    assert (want.reshape(B * S, -1)[gone] == 0).all()


def test_router_ties_keep_the_first_expert():
    """Two identical router columns tie in every token's probabilities:
    both packages pick the lower expert first (``lax.top_k``'s order)."""
    params, mod, xb, k = _case("dbrx")
    params = dict(params, w_router=params["w_router"].at[:, 5].set(
        params["w_router"][:, 2]))
    tied = moe.MoE(*mod.we_in.shape[1:], mod.we_in.shape[0])
    tied.load_state_dict({n: torch.tensor(np.asarray(v))
                          for n, v in params.items()})
    want = jax.lax.top_k(jax.nn.softmax(jnp.einsum(
        "td,de->te", xb.reshape(B * S, -1).astype(jnp.float32),
        params["w_router"]), axis=-1), k)[1]
    got = moe.route(tied, _torch_bf16(xb).reshape(B * S, -1), k, 8)[2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    both = np.isin(np.asarray(want), [2, 5]).sum(axis=1) == 2
    assert both.any()
    first = np.asarray(want)[both]
    assert (np.argmax(first == 2, axis=1) < np.argmax(first == 5, axis=1)
            ).all()
    y = moe.apply_moe(tied, _torch_bf16(xb), top_k=k, capacity_factor=1.25)
    np.testing.assert_array_equal(
        y.detach().float().numpy(),
        np.asarray(JMoE.apply_moe(params, xb, top_k=k, capacity_factor=1.25)
                   .astype(jnp.float32)))


def test_capacity_is_the_reference_arithmetic():
    for cf in (0.5, 1.0, 1.25, 2.0, 8.0):
        for t in (1, 7, 8, 80, 1000, 8192):
            for k, e in ((2, 4), (8, 40), (4, 16)):
                assert moe.capacity(cf, t, k, e) == max(
                    8, min(int(cf * t * k / e), t))
    assert moe.capacity(1.25, 8192, 8, 40) == 2048
    assert moe.capacity(8.0, 8, 8, 40) == 8       # a decode step: none dropped
