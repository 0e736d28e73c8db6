"""The sharded train step (``repro_torch.train.loop`` under a mesh) held to
the port's unsharded step, on a (2, 2, 2) ("pod", "data", "model") CPU
mesh under each arch's ``ARCH_RULES`` (and the train extras).

The rule is the gradients' rule of ``lm_train_support``
(``within_unrounded``): the sharded step's new params lie no further from
the unsharded step's than 1.5 times the unsharded step's distance from
the same step without bf16 rounding, over all leaves and leaf by leaf,
with the lr-flip allowance (``2 * LR``). Its anchor is the sharded step
without bf16 rounding, which must lie within ``STEP_ANCHOR_RTOL`` of the
step's size from the unsharded one (measured: 1e-6 to 6e-6): the sharded
arithmetic itself, free of rounding, is the unsharded one. The compared
step starts from the state after one unsharded step: at step 0 Adam moves
every weight by lr times the sign of its gradient, so a gradient within
rounding of zero flips a weight by 2 lr, and a 64-element norm scale may
flip twice where its unrounded twin flips none (measured: gemma2-27b's
``norm1_post``); from a state with moments the update is smooth in the
gradient. Step 0's int8 pod hop is held apart: the synced gradient
within 0.02 of its max from the fp32 hop's (the reference's own
cross-pod bound) and the params within 2 lr of that step's.

The unsharded step runs under the same rules: the MoE dispatch then
groups tokens by the data-parallel degree in both (``_dp_groups``) and
the attention core splits its queries over the model axis, as in the
sharded step, so the two compute the same function. The pod hop is fp32
in the held comparison (``fp32_hop_step``: the step's three calls with the
sync's int8 off), int8 where it is measured.
"""
import copy
import functools

import pytest
import torch

jax = pytest.importorskip("jax")  # lm_train_support imports the reference

from test_torch_support import fp32_hop_step  # noqa: E402
from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from lm_train_support import (STEP_ANCHOR_RTOL, make_batch,  # noqa: E402
                              tbatch, within_unrounded)
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.distributed.sharding import (CollectiveStats,  # noqa: E402
                                              join, use_rules)
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import TRAIN_EXTRA_RULES, arch_rules  # noqa
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

LR = 1e-2
ADAMW = opt.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
B = 8
INT8_BOUND = 0.02           # tests/test_compression.py's cross-pod bound


def _mesh():
    return make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")


def _rules(arch, mesh=None):
    return arch_rules(mesh or _mesh(), arch, TRAIN_EXTRA_RULES.get(arch))


def _copy(state):
    return opt.AdamWState(step=state.step.clone(), **{
        f: {k: v.clone() for k, v in getattr(state, f).items()}
        for f in ("mu", "nu", "master")})


def _named(model) -> dict:
    return {k: p.detach().double().numpy()
            for k, p in model.named_parameters()}


@functools.lru_cache(maxsize=None)
def _start(arch):
    """(cfg, the model and state after one unsharded step, the next
    batch)."""
    cfg = reduced(get_config(arch))
    model = M.init_params(0, cfg, device="cpu")
    model, state, _ = loop.make_train_step(cfg, ADAMW)(
        model, opt.init(dict(model.named_parameters())),
        tbatch(make_batch(cfg, b=B, seed=1)))
    return cfg, model, state, make_batch(cfg, b=B, seed=2)


class _Unrounded:
    """The compute dtype float64 inside the block (the model is a float64
    copy; fp32 where the reference computes fp32)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.keep = L.COMPUTE_DTYPE
        if self.on:
            L.COMPUTE_DTYPE = torch.float64

    def __exit__(self, *exc):
        L.COMPUTE_DTYPE = self.keep


def unsharded(cfg, model, state, batch, rules, unrounded=False, n_micro=1):
    m = copy.deepcopy(model)
    m = m.double() if unrounded else m
    with use_rules(rules), _Unrounded(unrounded):
        m, _, metrics = loop.make_train_step(cfg, ADAMW, n_micro)(
            m, _copy(state), tbatch(batch))
    return _named(m), metrics


def sharded(cfg, model, state, batch, rules, unrounded=False, n_micro=1):
    m = copy.deepcopy(model)
    m = m.double() if unrounded else m
    params, st, zspecs = loop.place_train_state(m, _copy(state), rules)
    step = fp32_hop_step(cfg, ADAMW, n_micro, zspecs)
    with use_rules(rules), _Unrounded(unrounded):
        new, new_state, metrics = step(params, st,
                                       loop.place_batch(batch, rules))
    return {k: join(v).double().numpy() for k, v in new.items()}, metrics, \
        new_state


def _scalar(s: float, u: float, x: float) -> None:
    """A metric by the rule: no further from the unsharded value than 1.5
    times its distance from the unrounded one, or 1e-3 of it."""
    assert abs(s - u) <= max(1.5 * abs(u - x), 1e-3 * abs(x)), (s, u, x)


def check_step(arch, n_micro=1):
    cfg, model, state, batch = _start(arch)
    rules = _rules(arch)
    u, um = unsharded(cfg, model, state, batch, rules, n_micro=n_micro)
    x, xm = unsharded(cfg, model, state, batch, rules, True, n_micro)
    s, sm, new_state = sharded(cfg, model, state, batch, rules,
                               n_micro=n_micro)
    sx, _, _ = sharded(cfg, model, state, batch, rules, True, n_micro)
    ratios = within_unrounded(s, u, x, sx, STEP_ANCHOR_RTOL,
                              base=_named(model), leaf_atol=2 * LR)
    for k in ("loss", "grad_norm"):
        _scalar(float(sm[k]), float(um[k]), float(xm[k]))
    assert float(sm["lr"]) == float(um["lr"])
    assert int(new_state.step) == 2
    assert sorted(sm) == sorted(list(um) + ["collectives"])
    return ratios, sm


@pytest.mark.parametrize("arch", list_archs())
def test_sharded_step_holds_to_the_unsharded_step(arch):
    (global_ratio, _), metrics = check_step(arch)
    assert global_ratio < 1.0
    colls = metrics["collectives"]
    # every step all-reduces within the model axis and hops the pods
    assert colls["all-reduce"]["by_axis"]["model"] > 0
    assert colls["all-reduce"]["by_axis"]["pod"] > 0


def test_microbatches_under_a_mesh():
    """n_micro = 2: microbatch i is the global rows [4 i, 4 i + 4), split
    over the four batch groups; held like one step."""
    check_step("gemma3-1b", n_micro=2)
    check_step("granite-moe-3b-a800m", n_micro=2)


def test_int8_pod_hop_within_the_reference_bound():
    """Step 0 from the seed-0 state: the int8 pod hop's synced gradient
    within 0.02 of each leaf's max from the fp32 hop's, and the params
    within 2 lr of that step's (Adam's first update is lr times the
    gradient's sign: the hop may flip one)."""
    arch = "gemma3-1b"
    cfg = reduced(get_config(arch))
    model = M.init_params(0, cfg, device="cpu")
    state = opt.init(dict(model.named_parameters()))
    batch = make_batch(cfg, b=B, seed=1)
    rules = _rules(arch)
    params, st, zspecs = loop.place_train_state(model, state, rules)
    structure = M.Model(cfg, torch.device("meta"))
    stats = CollectiveStats()
    with use_rules(rules):
        grads, _ = loop.sharded_grads(cfg, structure, params,
                                      loop.place_batch(batch, rules), rules,
                                      1, stats)
    synced = {}
    for int8 in (True, False):
        gen = torch.Generator().manual_seed(0)
        synced[int8] = loop.sync_grads(grads, params, rules, zspecs, gen,
                                       int8, stats)
    for k in synced[True]:
        a, b = join(synced[True][k]), join(synced[False][k])
        assert float((a - b).abs().max()) <= INT8_BOUND * float(
            b.abs().max()), k
    new = {int8: loop.sharded_update(ADAMW, synced[int8], st, params,
                                     stats)[0] for int8 in (True, False)}
    lr = float(opt.schedule(ADAMW, torch.tensor(1)))
    flips = 0
    for k in new[True]:
        d = (join(new[True][k]) - join(new[False][k])).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-5), k
        flips += int((d > lr).sum())
    assert 0 < flips < 1e-2 * sum(p.numel() for p in model.parameters())
    # the hop's wire format: int8 codes and fp32 scales, about 0.26 of fp32
    pod = stats.by_kind["all-reduce"]["by_axis"]["pod"]
    assert pod > 0


def test_zero1_layout_and_what_each_position_holds():
    """ZeRO-1 splits mu, nu and master (and the synced gradients) over
    the data axis within a pod; without it they follow the params. Both
    layouts give the same step."""
    cfg, model, state, batch = _start("gemma3-1b")
    rules = _rules("gemma3-1b")
    params, st, zspecs = loop.place_train_state(model, _copy(state), rules)
    _, st_plain, none = loop.place_train_state(model, _copy(state), rules,
                                               zero1=False)
    assert none is None
    full = sum(p.numel() * 4 for p in model.parameters())
    p_bytes = loop.per_position_bytes(params)
    z_bytes = loop.per_position_bytes(st.mu)
    plain = loop.per_position_bytes(st_plain.mu)
    assert plain == p_bytes < full
    assert z_bytes < p_bytes
    out = {}
    for z, (pp, ss, gs) in {True: (params, st, zspecs),
                            False: (params, st_plain, None)}.items():
        step = fp32_hop_step(cfg, ADAMW, grad_shardings=gs)
        with use_rules(rules):
            new, new_st, m = step(pp, ss, loop.place_batch(batch, rules))
        out[z] = ({k: join(v) for k, v in new.items()}, m)
        if z:
            assert loop.per_position_bytes(new_st.master) == z_bytes
            assert "data" in m["collectives"]["reduce-scatter"]["by_axis"]
            assert "data" in m["collectives"]["all-gather"]["by_axis"]
    for k, v in out[True][0].items():
        torch.testing.assert_close(v, out[False][0][k], rtol=1e-6,
                                   atol=1e-7)
    # the sequence-parallel core's all-to-alls over the model axis
    assert out[True][1]["collectives"]["all-to-all"]["by_axis"]["model"] > 0


def test_sharded_checkpoint_is_the_unsharded_layout(tmp_path):
    """A sharded run's state, joined, saves the files an unsharded run's
    does (keys, shapes, dtypes) and restores into a model bit for bit."""
    cfg, model, state, batch = _start("gemma3-1b")
    rules = _rules("gemma3-1b")
    params, st, zspecs = loop.place_train_state(model, _copy(state), rules)
    with use_rules(rules):
        params, st, _ = loop.make_train_step(
            cfg, ADAMW, grad_shardings=zspecs)(
                params, st, loop.place_batch(batch, rules))
    joined, jstate = loop.gather_train_state(params, st, cfg)
    a = train.save_train(str(tmp_path / "sharded"), 2, joined, jstate)
    b = train.save_train(str(tmp_path / "plain"), 1, model, state)
    (ma, _), (mb, _) = ckpt._read_step(a), ckpt._read_step(b)
    for field in ("keys", "shapes", "dtypes"):
        assert ma[field] == mb[field]
    fresh = M.init_params(1, cfg, device="cpu")
    restored, step, _ = train.restore_train(str(tmp_path / "sharded"), fresh,
                                            opt.init(dict(
                                                fresh.named_parameters())))
    assert step == 2 and int(restored.step) == 2
    for k, p in fresh.named_parameters():
        assert torch.equal(p.detach(), join(params[k]))
        assert torch.equal(restored.mu[k], join(st.mu[k]))


def test_the_step_refuses_what_it_cannot_run():
    cfg, model, state, batch = _start("gemma3-1b")
    rules = _rules("gemma3-1b")
    params, st, zspecs = loop.place_train_state(model, _copy(state), rules)
    with pytest.raises(ValueError, match="use_rules"):
        loop.make_train_step(cfg, ADAMW)(params, st,
                                         loop.place_batch(batch, rules))
    with pytest.raises(ValueError, match="grad_shardings"):
        loop.make_train_step(cfg, ADAMW, grad_shardings=zspecs)(
            copy.deepcopy(model), _copy(state), tbatch(batch))
    _, plain, _ = loop.place_train_state(model, _copy(state), rules,
                                         zero1=False)
    with use_rules(rules), pytest.raises(ValueError, match="placed by"):
        loop.make_train_step(cfg, ADAMW, grad_shardings=zspecs)(
            params, plain, loop.place_batch(batch, rules))
    with use_rules(rules), pytest.raises(ValueError, match="microbatches"):
        loop.make_train_step(cfg, ADAMW, n_micro=4)(
            params, st, loop.place_batch(batch, rules))
