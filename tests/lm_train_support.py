"""Shared helpers of the training tests (``tests/test_torch_train_*.py``):
the same reduced model in both packages, the reference's jitted loss and
gradient, the port's gradient with and without bf16 rounding, and the rule
that holds one against the other.

The rule (the CPU tests' rule for the LM since the serving slice): the
port and the reference both round to bf16 op by op, but each bf16 matmul
sums its fp32 products in its own order and the random-weight stacks
amplify such ulps. So the port's gradient is held to the reference's as
closely as the reference's lies to the same gradient computed without bf16
rounding (the port's, with ``layers.COMPUTE_DTYPE`` float64 on a
``.double()`` model; fp32 where the reference computes fp32): no further
than ``FACTOR`` times that distance, over all leaves together and leaf by
leaf. A leaf's bound never drops below ``LEAF_FLOOR`` times the leaf's
unrounded norm (no leaf of the ten archs comes near it: the reference's
own distance is 6e-3 of the norm or more).

That unrounded gradient is the port's own, so a fault in the port's
backward (a stray ``detach``, a stopped leaf) would move it and the
rounded one alike. The rule therefore has an anchor outside the port: the
reference computed without bf16 rounding (its modules' ``COMPUTE_DTYPE``
set to fp32 while its function traces, ``reference_in_fp32``). Leaf by
leaf, the port's unrounded gradient lies within ``GRAD_ANCHOR_RTOL`` of
its norm from that one (measured: 1.9e-6 or less on every leaf of the ten
archs); a step's new params lie within ``STEP_ANCHOR_RTOL`` of the step's
own size (measured: 1.4e-3 or less; Adam's first step divides each
gradient by its own magnitude, so elements near zero amplify rounding).
"""
import contextlib
import copy
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import recurrent as JR
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers as L
from repro_torch.models import model as M

FACTOR = 1.5
LEAF_FLOOR = 1e-3
GRAD_ANCHOR_RTOL = 1e-5
STEP_ANCHOR_RTOL = 1e-2
BATCH, SEQ, FRAMES = 2, 32, 16


def make_batch(cfg, b: int = BATCH, s: int = SEQ, seed: int = 0) -> dict:
    """Numpy tokens (and the stub frontends' inputs) from ``seed``."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.enc_dec:
        batch["frames"] = r.normal(size=(b, FRAMES, cfg.d_model)) \
            .astype(np.float32)
    if cfg.frontend == "vision_stub":
        batch["patches"] = r.normal(size=(b, cfg.n_prefix, cfg.d_model)) \
            .astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def case(arch: str, **changes):
    """(the reference's cfg, its params from PRNGKey(0) with numpy leaves,
    the port's cfg, a numpy batch). ``changes`` replace config fields in
    both."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **changes)
    cfg = dataclasses.replace(reduced(get_config(arch)), **changes)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, params, cfg, make_batch(cfg)


def port_model(arch: str, **changes):
    """A fresh port model holding ``case(arch)``'s reference weights."""
    _, params, cfg, _ = case(arch, **changes)
    return M.params_from_jax(params, cfg, device="cpu")


def tbatch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@contextlib.contextmanager
def reference_in_fp32():
    """Inside the block the reference computes without bf16 rounding: each
    of its model modules' ``COMPUTE_DTYPE`` (read when a function traces)
    is fp32. Trace a fresh ``jax.jit`` inside it."""
    mods = (JL, JA, JM, JMoE, JR)
    keep = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = jnp.float32
    try:
        yield
    finally:
        for m, dtype in zip(mods, keep):
            m.COMPUTE_DTYPE = dtype


@functools.lru_cache(maxsize=None)
def _jitted_value_and_grad(jcfg, fp32: bool = False):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JM.lm_loss(p, jcfg, b), has_aux=True))
    if not fp32:
        return fn

    def traced_in_fp32(p, b):
        with reference_in_fp32():
            return fn(p, b)
    return traced_in_fp32


def reference_loss_and_grads(arch: str, fp32: bool = False, **changes):
    """The reference's (loss, metrics as floats, gradients keyed by the
    port's parameter names as float64 numpy); ``fp32``: computed without
    bf16 rounding (``reference_in_fp32``)."""
    jcfg, params, cfg, batch = case(arch, **changes)
    (loss, metrics), grads = _jitted_value_and_grad(jcfg, fp32)(
        params, jbatch(batch))
    named = M.from_jax_tree(jax.tree.map(np.asarray, grads), cfg)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {k: np.asarray(v, np.float64) for k, v in named.items()})


def port_loss_and_grads(model, batch: dict, unrounded: bool = False):
    """The port's (loss, metrics as floats, gradients as float64 numpy by
    parameter name); ``unrounded``: on a float64 copy of the model with the
    compute dtype float64."""
    if unrounded:
        model = copy.deepcopy(model).double()
    keep = L.COMPUTE_DTYPE
    if unrounded:
        L.COMPUTE_DTYPE = torch.float64
    try:
        named = dict(model.named_parameters())
        with torch.enable_grad():     # some test modules switch grad off
            loss, metrics = M.lm_loss(model, tbatch(batch))
            grads = torch.autograd.grad(loss, list(named.values()))
    finally:
        L.COMPUTE_DTYPE = keep
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {k: g.double().numpy() for k, g in zip(named, grads)})


def within_unrounded(port: dict, ref: dict, exact: dict, ref32: dict,
                     anchor_rtol: float, base=None,
                     leaf_atol: float = 0.0) -> tuple:
    """Hold ``port`` to ``ref`` by the rule (module docstring) over all
    leaves and leaf by leaf, a leaf's bound raised by ``leaf_atol``, after
    holding ``exact`` to its anchor ``ref32`` (``anchored``); returns (the
    global ratio |port - ref| / |ref - exact|, the worst leaf's |port -
    ref| over its bound and its name) for the record."""
    keys = sorted(exact)
    assert sorted(port) == sorted(ref) == keys
    anchored(exact, ref32, anchor_rtol, base, leaf_atol)

    def cat(g):
        return np.concatenate([g[k].ravel() for k in keys])

    p, r, e = cat(port), cat(ref), cat(exact)
    d_pr, d_re = np.linalg.norm(p - r), np.linalg.norm(r - e)
    assert d_pr <= FACTOR * d_re, (d_pr, d_re)
    worst = (0.0, None)
    for k in keys:
        d_pr_k = np.linalg.norm(port[k] - ref[k])
        bound = max(FACTOR * np.linalg.norm(ref[k] - exact[k]),
                    LEAF_FLOOR * np.linalg.norm(exact[k])) + leaf_atol
        assert d_pr_k <= bound, (k, d_pr_k, bound)
        worst = max(worst, (d_pr_k / bound, k))
    return d_pr / d_re, worst


def anchored(exact: dict, ref32: dict, rtol: float, base=None,
             atol: float = 0.0) -> tuple:
    """The port's unrounded result against the reference's computed
    without bf16 rounding, leaf by leaf: |exact - ref32| <= rtol x the
    leaf's size (|exact| for gradients; |exact - base| for the params after
    a step from ``base``) + ``atol``. Returns the worst leaf's |exact -
    ref32| over that size, and its name."""
    assert sorted(ref32) == sorted(exact)
    worst = (0.0, None)
    for k in sorted(exact):
        size = np.linalg.norm(exact[k] - (0.0 if base is None else base[k]))
        d = np.linalg.norm(exact[k] - ref32[k])
        assert size > 0 and d <= rtol * size + atol, (k, d, size)
        worst = max(worst, (d / size, k))
    return worst


def grads_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k])
                                          for k in a)


# -- the checks each family's file runs on its archs -------------------------

LOSS_ATOL = 0.02


@functools.lru_cache(maxsize=None)
def computed(arch: str):
    """(reference, port, port unrounded, reference without bf16 rounding)
    (loss, metrics, grads) on ``case(arch)``, once a process."""
    model = port_model(arch)
    batch = case(arch)[3]
    return (reference_loss_and_grads(arch), port_loss_and_grads(model, batch),
            port_loss_and_grads(model, batch, unrounded=True),
            reference_loss_and_grads(arch, fp32=True))


def check_loss_and_metrics(arch: str) -> None:
    """Loss and all four metrics against the reference's ``lm_loss``:
    ``tokens`` equal, ``ppl_log`` the loss itself, the loss and
    ``logz_mean`` within ``LOSS_ATOL`` (single logits of the two packages
    lie up to 0.15 apart end to end, the reference's own decode drift
    bound; averaged over a batch's tokens the reference's own loss lies at
    most 0.0073 from the unrounded one on these batches)."""
    (rl, rm, _), (pl, pm, _), _, _ = computed(arch)
    assert sorted(pm) == sorted(rm) == ["logz_mean", "loss", "ppl_log",
                                        "tokens"]
    assert pm["tokens"] == rm["tokens"]
    assert pm["ppl_log"] == pm["loss"] == pl
    assert np.isfinite(pl) and abs(pl - rl) <= LOSS_ATOL
    assert abs(pm["logz_mean"] - rm["logz_mean"]) <= LOSS_ATOL


def check_gradients(arch: str) -> tuple:
    """The port's gradient against ``jax.grad`` of the reference by the
    rule, its unrounded gradient against the reference's without bf16
    rounding (and the unrounded loss within 1e-5); returns the ratios."""
    (_, _, rg), (_, _, pg), (el, _, eg), (fl, _, fg) = computed(arch)
    assert all(np.isfinite(g).all() for g in pg.values())
    assert abs(el - fl) <= 1e-5 * abs(fl), (el, fl)
    return within_unrounded(pg, rg, eg, fg, GRAD_ANCHOR_RTOL)


def check_remat_bit_equal(arch: str) -> None:
    """``cfg.remat`` on (each decoder block under torch.utils.checkpoint)
    against off: the same gradients and loss, bit for bit."""
    batch = case(arch)[3]
    off = port_loss_and_grads(port_model(arch, remat=False), batch)
    on = port_loss_and_grads(port_model(arch, remat=True), batch)
    assert on[0] == off[0] and on[1] == off[1]
    assert grads_equal(on[2], off[2])
