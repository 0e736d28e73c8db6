"""The port's shardings against the reference's own sharded programs, run
once a module in a subprocess with 8 forced host devices (as
``tests/test_multidevice.py`` and ``tests/test_compression.py`` run them;
results come back as numpy):

* the sequence-parallel core under ``shard_map`` (``test_multidevice.py``'s
  (2, 4) case, causal with GQA 6/2, and windowed): the port's within the
  attention tests' rtol = atol = 1e-2 (the reference's own test allows
  2e-2), and bit for bit the port's unsharded core (each slice is one
  query chunk);
* ``cross_pod_grad_sync`` on (2, 2, 2): the reference's output is its
  pods' dequantized codes summed (one key for both pods); the port's,
  whose pods draw their own noise, lies within one quantization step a
  pod of it;
* the sharded train step of ``test_sharded_train_step_matches_single_
  device`` (reduced mistral-nemo-12b, 2 layers, 4 heads, 2 KV heads, 8 x
  32 tokens, a (4, 2) ("data", "model") mesh, the default Megatron rules:
  heads on the model axis): the port's sharded gradient held to the
  reference's sharded gradient by the gradients' rule
  (``within_unrounded``, anchored by the port's unrounded gradient against
  the reference's at fp32), the loss within ``LOSS_ATOL``, and the step's
  params within the reference test's own bound (5e-2).
"""
import functools
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from lm_train_support import (GRAD_ANCHOR_RTOL, LOSS_ATOL,  # noqa: E402
                              _jitted_value_and_grad, case, jbatch,
                              make_batch, port_loss_and_grads,
                              within_unrounded)
from repro.distributed import compression as JC  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    cross_pod_grad_sync)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCH = "mistral-nemo-12b"
CHANGES = dict(n_layers=2, n_heads=4, n_kv_heads=2)
KW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEP_ATOL = 5e-2            # test_multidevice.py's loss and param bounds
CORES = {"causal": dict(causal=True), "windowed": dict(causal=True,
                                                       window=12)}

REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.distributed.compression import cross_pod_grad_sync
    from repro.distributed.sharding import AxisRules, param_spec_tree, \\
        use_rules
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.models.attention import chunked_attention
    from repro.train import loop, optimizer as opt

    inp, out = dict(np.load(sys.argv[1])), {}
    mesh = make_mesh((2, 4), ("data", "model"))
    rules = AxisRules(mesh, {"attn_core_seq_shard": "model",
                             "heads": None, "head_dim": "model"})
    for name, window in (("causal", 0), ("windowed", 12)):
        with use_rules(rules):
            f = jax.jit(lambda q, k, v: chunked_attention(
                q, k, v, causal=True, window=window, q_chunk=16,
                kv_chunk=16))
            out["core_" + name] = np.asarray(
                f(inp["q"], inp["k"], inp["v"]).astype(jnp.float32))

    sync = cross_pod_grad_sync(make_mesh((2, 2, 2),
                                         ("pod", "data", "model")))
    out["sync"] = np.asarray(jax.jit(sync)(inp["g"], jax.random.PRNGKey(0)))

    cfg = dataclasses.replace(reduced(get_config("mistral-nemo-12b")),
                              n_layers=2, n_heads=4, n_kv_heads=2)
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    state = opt.init(params)
    mesh = make_mesh((4, 2), ("data", "model"))
    rules = AxisRules(mesh)
    with use_rules(rules):
        specs = param_spec_tree(params, rules)
        put = lambda t, s: jax.tree.map(
            lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), t, s,
            is_leaf=lambda x: hasattr(x, "shape"))
        ps = put(params, specs)
        ss = opt.AdamWState(step=state.step, mu=put(state.mu, specs),
                            nu=put(state.nu, specs),
                            master=put(state.master, specs))
        bs = {"tokens": jax.device_put(jnp.asarray(inp["tokens"]),
                                       NamedSharding(mesh, P("data", None)))}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: M.lm_loss(p, cfg, b), has_aux=True))(ps, bs)
        new, _, metrics = jax.jit(loop.make_train_step(cfg, adamw))(
            ps, ss, bs)
    out["loss"] = np.asarray(loss)
    out["step_loss"] = np.asarray(metrics["loss"])
    for i, g in enumerate(jax.tree.leaves(grads)):
        out[f"grad_{i}"] = np.asarray(g)
    for i, p in enumerate(jax.tree.leaves(new)):
        out[f"param_{i}"] = np.asarray(p)
    np.savez(sys.argv[2], **out)
""")


def _inputs():
    r = np.random.default_rng(0)
    _, _, cfg, _ = case(ARCH, **CHANGES)
    return {"q": r.normal(size=(2, 64, 6, 16)).astype(np.float32),
            "k": r.normal(size=(2, 64, 2, 16)).astype(np.float32),
            "v": r.normal(size=(2, 64, 2, 16)).astype(np.float32),
            "g": r.normal(size=(512,)).astype(np.float32),
            "tokens": make_batch(cfg, b=8, seed=0)["tokens"]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs and the reference's results (8 forced host devices)."""
    tmp = tmp_path_factory.mktemp("multidevice")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
                          str(tmp / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    return inp, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("name", sorted(CORES))
def test_sequence_parallel_core_matches_the_reference_shard_map(reference,
                                                                name):
    inp, out = reference
    q, k, v = (torch.tensor(inp[n]) for n in "qkv")
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    args = dict(q_chunk=16, kv_chunk=16, **CORES[name])
    rules = S.AxisRules(mesh, {"attn_core_seq_shard": "model",
                               "heads": None, "head_dim": "model"})
    with S.use_rules(rules):
        got = A.chunked_attention(q, k, v, **args)
    np.testing.assert_allclose(got.float().numpy(), out["core_" + name],
                               rtol=1e-2, atol=1e-2)
    assert torch.equal(got, A.chunked_attention(q, k, v, **args))


def test_cross_pod_sync_matches_the_reference(reference):
    inp, out = reference
    g = inp["g"]
    partial = g + g + g + g
    codes, scales, pad = JC.quantize_int8(jnp.asarray(partial),
                                          jax.random.PRNGKey(0))
    deq = np.asarray(JC.dequantize_int8(codes, scales, pad, partial.shape,
                                        jnp.float32))
    np.testing.assert_array_equal(out["sync"], deq + deq)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    blocks = np.empty(mesh.devices.shape, dtype=object)
    for pos, _ in S.positions(mesh):
        blocks[pos] = torch.tensor(g)
    got = cross_pod_grad_sync(mesh)(blocks, torch.Generator().manual_seed(
        0))[0, 0, 0].numpy()
    step = np.repeat(np.asarray(scales), 256)[:g.size]
    ulp = np.spacing(np.abs(out["sync"]).astype(np.float32))
    assert (np.abs(got - out["sync"]) <= 2 * step + 4 * ulp).all()
    assert np.abs(got - 8 * g).max() < 0.02 * np.abs(8 * g).max()


@functools.lru_cache(maxsize=None)
def _port():
    jcfg, params, cfg, _ = case(ARCH, **CHANGES)
    batch = {"tokens": make_batch(cfg, b=8, seed=0)["tokens"]}
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    rules = S.AxisRules(mesh)
    model = M.params_from_jax(params, cfg, device="cpu")
    placed, state, _ = loop.place_train_state(
        model, opt.init(dict(model.named_parameters())), rules, zero1=False)
    stats = S.CollectiveStats()
    with S.use_rules(rules):
        pb = loop.place_batch(batch, rules)
        grads, metrics = loop.sharded_grads(
            cfg, M.Model(cfg, torch.device("meta")), placed, pb, rules, 1,
            stats)
        synced = loop.sync_grads(grads, placed, rules, None, None, False,
                                 stats)
        new, _, step_metrics = loop.make_train_step(
            cfg, opt.AdamWConfig(**KW))(placed, state, pb)
    return (jcfg, params, cfg, batch, model, metrics,
            {k: S.join(v).double().numpy() for k, v in synced.items()},
            step_metrics, {k: S.join(v).double().numpy()
                           for k, v in new.items()}, stats)


def test_sharded_step_matches_the_reference_sharded_step(reference):
    inp, out = reference
    (jcfg, params, cfg, batch, model, metrics, grads, step_metrics, new,
     stats) = _port()
    assert np.array_equal(batch["tokens"], inp["tokens"])
    treedef = jax.tree.structure(params)

    def named(prefix):
        leaves = [out[f"{prefix}_{i}"] for i in range(treedef.num_leaves)]
        return {k: np.asarray(v, np.float64) for k, v in M.from_jax_tree(
            jax.tree.unflatten(treedef, leaves), cfg).items()}

    ref_grads, ref_new = named("grad"), named("param")
    _, _, exact = port_loss_and_grads(model, batch, unrounded=True)
    (_, _), ref32 = _jitted_value_and_grad(jcfg, True)(params,
                                                       jbatch(batch))
    ref32 = {k: np.asarray(v, np.float64) for k, v in M.from_jax_tree(
        jax.tree.map(np.asarray, ref32), cfg).items()}
    within_unrounded(grads, ref_grads, exact, ref32, GRAD_ANCHOR_RTOL)
    assert abs(float(metrics["loss"]) - float(out["loss"])) <= LOSS_ATOL
    assert abs(float(step_metrics["loss"]) - float(out["step_loss"])) \
        < STEP_ATOL
    drift = max(np.abs(new[k] - ref_new[k]).max() for k in ref_new)
    assert drift < STEP_ATOL, drift
    # heads on the model axis: no sequence-parallel all-to-all; the
    # gradients all-reduce over the data axis
    assert "all-to-all" not in stats.by_kind
    assert stats.by_kind["all-reduce"]["by_axis"]["data"] > 0
