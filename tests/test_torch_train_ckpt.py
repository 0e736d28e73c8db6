"""Training checkpoints crossing between the packages: ``(params,
AdamWState)`` in the reference's layout (``repro.checkpoint.ckpt``), the
port's written by ``repro_torch.launch.train.save_train`` and restored by
``restore_train``.

* A reference checkpoint written after two steps restores in the port bit
  for bit, and the next step agrees by the gradients' rule; and the other
  way round, with the reference's template (the port's step without bf16
  rounding anchored to the reference's, as ``lm_train_support`` says).
  The reference's ``restore``
  cannot take its own 0-d ``step``: npz stores a 0-d leaf as (1,) (the
  manifest keeps ()), and it compares the stored shape with the
  template's; so its template here holds a (1,) step. The port reads the
  manifest's shape.
* The launcher trains on the CPU, checkpoints and resumes where it left
  off: the resumed steps' losses equal an uninterrupted run's bit for bit.

The train state's tree and keys are in ``test_torch_train_tree.py``.
"""
import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from lm_train_support import (STEP_ANCHOR_RTOL, case,  # noqa: E402
                              jbatch, make_batch, port_model,
                              reference_in_fp32, tbatch, within_unrounded)
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "gemma3-1b"
CHANGES = {"n_layers": 8}     # one scanned period of 6 and a rest of 2
KW = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def _batches(cfg, n):
    return [make_batch(cfg, seed=10 + i) for i in range(n)]


def _state_leaves(tree) -> dict:
    """A train tree's leaves by checkpoint key, as numpy."""
    return {k: np.asarray(v) for k, v in ckpt._walk(tree)}


def _numpy_params(model) -> dict:
    return {k: v.detach().double().numpy()
            for k, v in model.named_parameters()}


def _port_next_step(model, state, batch):
    """(the params before, the port's next step's, and its unrounded
    step's), float64 numpy by name."""
    base = _numpy_params(model)
    step = loop.make_train_step(model.cfg, opt.AdamWConfig(**KW))
    exact = M.Model(model.cfg, device="cpu").double()
    exact.load_state_dict(model.state_dict())
    keep = L.COMPUTE_DTYPE
    L.COMPUTE_DTYPE = torch.float64
    try:
        exact, _, _ = step(exact, state, tbatch(batch))
    finally:
        L.COMPUTE_DTYPE = keep
    model, state, _ = step(model, state, tbatch(batch))
    return base, _numpy_params(model), _numpy_params(exact)


@functools.lru_cache(maxsize=None)
def _jstep(jcfg, fp32: bool = False):
    """The reference's jitted train step, compiled once a process;
    ``fp32``: traced and run without bf16 rounding."""
    fn = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**KW)))
    if not fp32:
        return fn

    def traced_in_fp32(*args):
        with reference_in_fp32():
            return fn(*args)
    return traced_in_fp32


def _reference_next(jcfg, cfg, jp, js, batch) -> tuple:
    """The reference's next step's new params, with and without bf16
    rounding, float64 numpy by the port's names."""
    def named(fp32):
        p, _, _ = _jstep(jcfg, fp32)(jp, js, jbatch(batch))
        return {k: np.asarray(v, np.float64) for k, v in M.from_jax_tree(
            jax.tree.map(np.asarray, p), cfg).items()}

    return named(False), named(True)


def _reference_run(params, jcfg, batches):
    jstep = _jstep(jcfg)
    p, s = jax.tree.map(jnp.asarray, params), jopt.init(params)
    for b in batches:
        p, s, _ = jstep(p, s, jbatch(b))
    return p, s


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, params, cfg, _ = case(ARCH, **CHANGES)
    batches = _batches(cfg, 3)
    jp, js = _reference_run(params, jcfg, batches[:2])
    jckpt.save(str(tmp_path), 2, (jp, js), metadata={"arch": cfg.name})
    model = M.init_params(5, cfg, device="cpu")       # other weights
    state, step, meta = train.restore_train(
        str(tmp_path), model, opt.init(dict(model.named_parameters())))
    assert step == 2 and meta == {"arch": cfg.name}
    assert state.step.dtype == torch.int32 and int(state.step) == 2
    got = _state_leaves(train.train_tree(model, state))
    want = {k: np.asarray(v) for k, v in jckpt._flatten((jp, js)).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k].reshape(got[k].shape))
    base, mine, exact = _port_next_step(model, state, batches[2])
    ref, ref32 = _reference_next(jcfg, cfg, jp, js, batches[2])
    within_unrounded(mine, ref, exact, ref32, STEP_ANCHOR_RTOL, base=base,
                     leaf_atol=2 * KW["lr"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, params, cfg, _ = case(ARCH, **CHANGES)
    batches = _batches(cfg, 3)
    model = port_model(ARCH, **CHANGES)
    step = loop.make_train_step(cfg, opt.AdamWConfig(**KW))
    state = opt.init(dict(model.named_parameters()))
    for b in batches[:2]:
        model, state, _ = step(model, state, tbatch(b))
    train.save_train(str(tmp_path), 2, model, state,
                     metadata={"arch": cfg.name})
    jtemplate = (params, jopt.init(params))
    jtemplate = (jtemplate[0], jtemplate[1]._replace(
        step=jnp.zeros((1,), jnp.int32)))
    (jp, js), s, meta = jckpt.restore(str(tmp_path), jtemplate)
    js = js._replace(step=js.step.reshape(()))
    assert s == 2 and meta == {"arch": cfg.name} and int(js.step) == 2
    got = {k: np.asarray(v) for k, v in jckpt._flatten((jp, js)).items()}
    want = _state_leaves(train.train_tree(model, state))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    ref, ref32 = _reference_next(jcfg, cfg, jp, js, batches[2])
    base, mine, exact = _port_next_step(model, state, batches[2])
    within_unrounded(mine, ref, exact, ref32, STEP_ANCHOR_RTOL, base=base,
                     leaf_atol=2 * KW["lr"])


def test_launcher_trains_checkpoints_and_resumes_on_the_cpu(tmp_path):
    d = str(tmp_path / "ckpt")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert ckpt.all_steps(d) == [2, 4] and "done" in out.stdout
    shutil.rmtree(os.path.join(d, "step_00000004"))
    whole = train.main(["--device", "cpu", "--steps", "4"])
    resumed = train.main(["--device", "cpu", "--steps", "4",
                          "--ckpt-dir", d, "--ckpt-every", "2", "--resume"])
    assert whole["start"] == 0 and resumed["start"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    assert all(np.isfinite(whole["losses"])) and len(whole["losses"]) == 4
    for k, p in whole["model"].named_parameters():
        assert torch.equal(p, dict(resumed["model"].named_parameters())[k])
    assert int(resumed["state"].step) == 4
    assert ckpt.all_steps(d) == [2, 4]


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-26b"])
def test_launcher_adds_the_stub_frontends(arch):
    out = train.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                      "--batch", "2", "--seq", "16"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
