"""The port's train step (``repro_torch.train.loop``) against the
reference's jitted ``make_train_step`` on the same weights and batch, its
microbatching, and the reference's own training tests on the port (loss
falls on Markov data, microbatching equals one big batch).

One step is held by the gradients' rule (``lm_train_support``) on the new
params: no further from the reference's than 1.5 times the reference's
distance from the port's step without bf16 rounding, over all leaves and
leaf by leaf. Adam's first step moves each weight by about lr times the
sign of its gradient, so where a gradient lies within rounding of zero the
two packages move that weight 2 lr apart: a leaf's bound is raised by one
such flip (``2 * LR``). The port's step without bf16 rounding is anchored
to the reference's step without it (``lm_train_support``)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from lm_train_support import (STEP_ANCHOR_RTOL, case,  # noqa: E402
                              jbatch, port_model, reference_in_fp32, tbatch,
                              within_unrounded)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.tokens import MarkovTokens, TokenSpec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

LR = 1e-2
MICRO_ATOL = 5e-3            # the reference's microbatching bound


def _params(model) -> dict:
    return {k: v.detach().double().numpy()
            for k, v in model.named_parameters()}


@pytest.mark.parametrize("arch", ["gemma3-1b", "starcoder2-7b",
                                  "granite-moe-3b-a800m"])
def test_one_step_matches_the_reference(arch):
    jcfg, params, cfg, batch = case(arch)
    kw = dict(lr=LR, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**kw)))
    jp, js, jm = jstep(jax.tree.map(jnp.asarray, params), jopt.init(params),
                       jbatch(batch))
    with reference_in_fp32():
        jstep32 = jax.jit(jloop.make_train_step(jcfg,
                                                jopt.AdamWConfig(**kw)))
        jp32, _, _ = jstep32(jax.tree.map(jnp.asarray, params),
                             jopt.init(params), jbatch(batch))

    def named(p):
        return {k: np.asarray(v, np.float64) for k, v in M.from_jax_tree(
            jax.tree.map(np.asarray, p), cfg).items()}

    want, want32, base = named(jp), named(jp32), named(params)
    step = loop.make_train_step(cfg, opt.AdamWConfig(**kw))
    model = port_model(arch)
    model, state, m = step(model, opt.init(dict(model.named_parameters())),
                           tbatch(batch))
    exact = port_model(arch).double()
    keep = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float64
    try:
        exact, _, _ = step(exact, opt.init(dict(exact.named_parameters())),
                           tbatch(batch))
    finally:
        L.COMPUTE_DTYPE = keep
    within_unrounded(_params(model), want, _params(exact), want32,
                     STEP_ANCHOR_RTOL, base=base, leaf_atol=2 * LR)
    assert int(state.step) == int(js.step) == 1
    assert sorted(m) == ["grad_norm", "logz_mean", "loss", "lr", "ppl_log",
                         "tokens"]
    assert float(m["lr"]) == float(jm["lr"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        <= 0.01 * float(jm["grad_norm"])
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _micro_case():
    """The reference's ``test_microbatch_accumulation_matches`` setup:
    2-layer reduced starcoder2-7b, PRNGKey(1) weights, a (4, 32) batch."""
    jcfg = dataclasses.replace(jreduced(jget_config("starcoder2-7b")),
                               n_layers=2)
    cfg = dataclasses.replace(reduced(get_config("starcoder2-7b")),
                              n_layers=2)
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (4, 32), 0,
                                           jcfg.vocab_size))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    return jcfg, params, cfg, {"tokens": tokens}, kw


def test_microbatch_accumulation_matches():
    jcfg, params, cfg, batch, kw = _micro_case()
    npp = jax.tree.map(np.asarray, params)
    out = {}
    for n in (1, 2):
        model = M.params_from_jax(npp, cfg, device="cpu")
        step = loop.make_train_step(cfg, opt.AdamWConfig(**kw), n_micro=n)
        model, state, m = step(model, opt.init(dict(
            model.named_parameters())), tbatch(batch))
        out[n] = (_params(model), m)
    d = max(np.abs(out[1][0][k] - out[2][0][k]).max() for k in out[1][0])
    assert d < MICRO_ATOL, f"micro-accum drift {d}"
    assert sorted(out[2][1]) == ["grad_norm", "loss", "lr"]
    assert abs(float(out[2][1]["loss"]) - float(out[1][1]["loss"])) < 1e-2
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**kw),
                                          n_micro=2))
    jp, _, jm = jstep(params, jopt.init(params), jbatch(batch))
    want = M.from_jax_tree(jax.tree.map(np.asarray, jp), cfg)
    d = max(np.abs(out[2][0][k] - want[k]).max() for k in want)
    assert d < MICRO_ATOL, f"port vs reference n_micro=2: {d}"


def test_loss_decreases_on_markov_data():
    """The reference's test on the port: 2-layer reduced gemma3-1b
    (local, attn), 40 steps of Markov tokens, weights drawn by the port."""
    cfg = reduced(get_config("gemma3-1b"))
    cfg = dataclasses.replace(cfg, n_layers=2, pattern=("local", "attn"))
    adamw = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                            weight_decay=0.0)
    step = loop.make_train_step(cfg, adamw)
    model = M.init_params(0, cfg, device="cpu")
    state = opt.init(dict(model.named_parameters()))
    stream = MarkovTokens(TokenSpec(vocab_size=cfg.vocab_size, batch=8,
                                    seq_len=64, seed=0, branching=4))
    losses = []
    for _, batch in zip(range(40), stream):
        model, state, m = step(model, state, {"tokens": batch["tokens"]})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, f"{losses[0]:.3f} -> {losses[-1]:.3f}"


def test_eval_step_returns_the_loss_metrics_without_a_graph():
    _, _, cfg, batch = case("gemma3-1b")
    model = port_model("gemma3-1b")
    m = loop.make_eval_step(cfg)(model, tbatch(batch))
    with torch.no_grad():
        _, want = M.lm_loss(model, tbatch(batch))
    assert {k: float(v) for k, v in m.items()} == \
        {k: float(v) for k, v in want.items()}
    assert all(v.grad_fn is None for v in m.values())
