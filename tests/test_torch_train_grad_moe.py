"""Training through the MoE decoders (granite-moe-3b-a800m, dbrx-132b) at
``reduced()`` and the training capacity (1.25): the port's ``lm_loss``
and its gradient against the reference's ``lm_loss`` and ``jax.grad`` on
the same weights and batch, and remat on against off. The rules are in
``lm_train_support``.

Routing is discontinuous: a router near-tie may pick other experts in the
two packages, and then the gradients differ by more than rounding. So the
routes come first: every MoE layer's experts and kept pairs in the port's
loss forward equal those the reference's router picks on the reference's
own input to that layer (its blocks run one by one). They do on these
batches, so no layer needs its experts replayed. The top-k indices carry
no gradient; the gates do, through the renormalisation with its 1e-9
floor."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from lm_train_support import (case, check_gradients,  # noqa: E402
                              check_loss_and_metrics, check_remat_bit_equal,
                              jbatch, port_model, tbatch)
from repro.models import model as JM  # noqa: E402
from repro.models.moe import apply_moe as j_apply_moe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]


def _reference_routes(arch):
    """(experts, keep) of each MoE layer, the reference's router on the
    reference's input to that layer."""
    jcfg, params, _, batch = case(arch)
    inputs = []

    def record(p, x, **kw):
        inputs.append((p, x))
        return j_apply_moe(p, x, **kw)

    jb = jbatch(batch)
    x = JM._embed_in(params, jcfg, jb["tokens"])
    dec = params["decoder"]
    saved, JM.apply_moe = JM.apply_moe, record
    try:
        for i, kind in enumerate(jcfg.layer_kinds()):
            p, j = divmod(i, jcfg.period)
            bp = (jax.tree.map(lambda a: a[p], dec["scan"][j])
                  if p < jcfg.n_periods
                  else dec["rest"][i - jcfg.n_periods * jcfg.period])
            x, _ = JM.apply_block(bp, jax.tree.map(jnp.asarray, x), jcfg,
                                  kind, "train")
    finally:
        JM.apply_moe = saved
    out = []
    for p, xj in inputs:
        t = xj.shape[0] * xj.shape[1]
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", xj.reshape(t, -1).astype(jnp.float32),
            p["w_router"]), axis=-1)
        experts = np.asarray(jax.lax.top_k(probs, jcfg.moe_top_k)[1])
        cap = moe.capacity(jcfg.moe_capacity_factor, t, jcfg.moe_top_k,
                           jcfg.moe_experts)
        flat = experts.reshape(-1)
        onehot = np.eye(jcfg.moe_experts, dtype=np.int64)[flat]
        pos = ((np.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
        out.append((experts, pos < cap))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_forward_routes_equal_the_reference(arch):
    model = port_model(arch)
    routes, route = [], moe.route

    def record(*a):
        r = route(*a)
        routes.append((r[2].numpy(), r[4].numpy()))
        return r

    moe.route = record
    try:
        M.lm_loss(model, tbatch(case(arch)[3]))
    finally:
        moe.route = route
    want = _reference_routes(arch)
    assert len(routes) == len(want) == case(arch)[2].n_layers
    for (e, keep), (we, wkeep) in zip(routes, want):
        np.testing.assert_array_equal(e, we)
        np.testing.assert_array_equal(keep, wkeep)
        assert not keep.all()          # capacity 1.25 drops pairs here


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_metrics_match_the_reference(arch):
    check_loss_and_metrics(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_within_the_unrounded_rule(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_remat_off_bit_for_bit(arch):
    check_remat_bit_equal(arch)


def test_gates_carry_the_gradient_and_indices_none():
    """The router's weights get a gradient only through the gates (the
    renormalised top-k probabilities); the expert indices are integers."""
    model = port_model(ARCHS[0])
    xt = torch.randn(64, model.cfg.d_model, generator=torch.Generator()
                     .manual_seed(0)).bfloat16()
    layer = model.layers[0].moe
    with torch.enable_grad():
        probs, gates, experts, _, _ = moe.route(layer, xt, 2, 8)
        (g,) = torch.autograd.grad(gates[:, 0].sum(), [layer.w_router])
    assert experts.dtype == torch.int64 and not experts.requires_grad
    assert torch.isfinite(g).all() and g.abs().sum() > 0
