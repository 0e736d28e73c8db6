"""The port's AdamW (``repro_torch.train.optimizer``) against the
reference's (``repro.train.optimizer``): the reference's own schedule and
clipping tests on the port, the schedule at every step, and three updates
from the same fp32 gradients.

Tolerances: the update's arithmetic is the reference's op by op, but the
global norm sums each leaf's squares in its own order (an ulp apart), which
scales every clipped gradient, and ``cos`` and ``pow`` are each library's
own; so states and params are held within 1e-6 of the reference's norm,
leaf by leaf, and the schedule within 1e-6 of its value (or of the peak lr,
where the cosine's 1 + cos cancels toward min_lr_ratio 0) at every step
(XLA's own jitted and eager schedules differ by up to 8 ulps, 5e-7)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

RTOL = 1e-6
SHAPES = {"embed.embedding": (64, 32), "final_norm.scale": (32,),
          "layers.0.mixer.wq": (32, 4, 8)}


def test_adamw_schedule():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    assert float(opt.schedule(cfg, torch.tensor(0))) == 0.0
    assert float(opt.schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(opt.schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)


def test_grad_clip():
    cfg = opt.AdamWConfig(grad_clip=1.0, lr=0.1, weight_decay=0.0)
    params = {"w": torch.zeros((4,))}
    grads = {"w": torch.full((4,), 100.0)}
    _, _, m = opt.update(cfg, grads, opt.init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


@pytest.mark.parametrize("kw", [
    {}, {"lr": 1.0, "warmup_steps": 10, "total_steps": 100},
    {"lr": 3e-3, "warmup_steps": 5, "total_steps": 60},
    {"warmup_steps": 0, "total_steps": 7}, {"min_lr_ratio": 0.0,
                                            "total_steps": 300}])
def test_schedule_matches_the_reference_at_every_step(kw):
    cfg, jcfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    steps = np.arange(cfg.total_steps + 1, dtype=np.int32)
    want = np.asarray(jopt.schedule(jcfg, jnp.asarray(steps)))
    got = opt.schedule(cfg, torch.tensor(steps))
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got[0] == want[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * cfg.lr)
    for s in (0, cfg.warmup_steps, cfg.total_steps):   # scalar steps too
        assert float(opt.schedule(cfg, torch.tensor(s, dtype=torch.int32))) \
            == float(got[s])


def _near(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= RTOL * np.linalg.norm(want)


def test_three_updates_match_the_reference():
    r = np.random.default_rng(0)
    p0 = {k: r.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    cfg, jcfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    state, jstate = opt.init(params), jopt.init(jparams)
    assert all(state.master[k] is not params[k] for k in params)
    for step, scale in enumerate((3.0, 0.01, 3.0)):   # clipped, not, clipped
        g = {k: (scale * r.normal(size=s)).astype(np.float32)
             for k, s in SHAPES.items()}
        params, state, m = opt.update(
            cfg, {k: torch.tensor(v) for k, v in g.items()}, state, params)
        jparams, jstate, jm = jopt.update(
            jcfg, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        assert int(state.step) == int(jstate.step) == step + 1
        assert state.step.dtype == torch.int32
        for name in ("master", "mu", "nu"):
            for k in SHAPES:
                _near(getattr(state, name)[k], getattr(jstate, name)[k])
        for k in SHAPES:
            assert params[k].dtype == torch.float32
            _near(params[k], jparams[k])
        for key in ("grad_norm", "lr"):
            _near(m[key], jm[key])


def test_weight_decay_on_every_leaf():
    """Zero gradients: every leaf, norms and embeddings included, decays
    by lr * weight_decay * master."""
    cfg = opt.AdamWConfig(lr=0.5, warmup_steps=1, total_steps=1,
                          weight_decay=0.1)
    params = {k: torch.ones(s) for k, s in SHAPES.items()}
    new, _, m = opt.update(cfg, {k: torch.zeros(s) for k, s in
                                 SHAPES.items()}, opt.init(params), params)
    assert float(m["grad_norm"]) == 0.0
    for k in SHAPES:
        assert torch.equal(new[k], torch.full(SHAPES[k], 1 - 0.5 * 0.1))
