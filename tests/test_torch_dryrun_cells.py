"""The port's dry-run cells (``repro_torch.launch.dryrun``) against the
reference's compiled cells, at ``reduced()`` widths on a (2, 2) ("data",
"model") mesh: gemma3-1b, granite-moe-3b-a800m and recurrentgemma-2b at
train 8 x 128, prefill 4 x 128 and decode 4 x 128 tokens (entries added
to each package's ``SHAPES`` at run time), and the FCVI ``base`` cell at
n = 4096.

The reference's cells are lowered and compiled in subprocesses with 4
forced host devices (one an arch, run while the port traces) and read by
``hlo_analysis.analyze``. Held:

* the port's per-position dot FLOPs within 10% of the reference's
  (``FLOPS_RTOL``); the collectives' totals by kind printed beside the
  reference's (XLA's kinds include ``collective-permute``, which the port
  never issues, so only the trace's own are held);
* the meta trace equal to the same cell run on real CPU tensors: dot
  FLOPs and collective bytes exactly, op-boundary bytes within 1e-6 (the
  CPU reads the step counter on the host for the pod hop's generator and
  fills a scalar with ``fill_`` where meta copies it); for FCVI the bytes
  exactly too (``score_topk`` records B2's own work in a trace on either
  device, and its plain version, which writes the (q, n) scores no
  kernel writes, runs uncounted on the CPU);
* the one-group shortcut equal to tracing every group, per position:
  FLOPs, bytes, live peaks and collective bytes;
* the sharded prefill and decode held to the unsharded port's logits by
  the repo's rule for two roundings of one function: no further from the
  unsharded logits than ``UNROUNDED`` times their distance from the same
  pass without bf16 rounding (a float64 copy, ``layers.COMPUTE_DTYPE``
  float64), over all logits (MoE at capacity 8.0, the serving tests', so
  no token drops). Elementwise the attention tests' rtol = atol = 1e-2
  does not hold end to end: the sharded out-projections sum fp32 partials
  and round once where the unsharded product rounds in bf16, a ulp apart
  in a few activations, 0.02 apart in a few logits after the layers.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the card's machine has no JAX

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from test_torch_support import one_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ("gemma3-1b", "granite-moe-3b-a800m", "recurrentgemma-2b")
SHAPES = {"t_train": dict(kind="train", seq=128, batch=8),
          "t_prefill": dict(kind="prefill", seq=128, batch=4),
          "t_decode": dict(kind="decode", seq=128, batch=4)}
FCVI = dict(n=4096, d=128, m=8, batch=64, k=10, kprime=40)
FLOPS_RTOL = 0.10
UNROUNDED = 1.5             # tests/lm_train_support.py's factor

REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config, reduced
    from repro.distributed.sharding import use_rules
    from repro.launch import hlo_analysis as H
    from repro.launch import specs as S
    from repro.launch.mesh import make_mesh

    arch, names = sys.argv[1], sys.argv[2].split(",")
    shapes, fcvi = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    S.SHAPES.update(shapes)
    S.FCVI_SHAPES["t_fcvi"] = fcvi
    mesh = make_mesh((2, 2), ("data", "model"))
    sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    cells = [(n, S.build_fcvi_cell(n, mesh) if n == "t_fcvi" else
              S.build_cell(reduced(get_config(arch)), arch, n, mesh))
             for n in names]
    out = {}
    for name, cell in cells:
        with use_rules(cell.rules):
            compiled = jax.jit(cell.step_fn, in_shardings=sh(cell.in_pspecs),
                               out_shardings=sh(cell.out_pspecs),
                               donate_argnums=cell.donate).lower(
                *cell.in_sds).compile()
        res = H.analyze(compiled.as_text())
        out[name] = {"flops": res["flops"], "collectives": {
            k: v["bytes"] for k, v in res["collectives"].items()}}
    print(json.dumps(out))
""")


# the reference's cells, a subprocess each group: each arch's train cell
# (the slowest to compile) alone, its serving cells (and FCVI) together
JOBS = [(a, names) for a in ARCHS for names in (
    ("t_train",), ("t_prefill", "t_decode")
    + (("t_fcvi",) if a == ARCHS[0] else ()))]


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's cells: per-device dot FLOPs and collective bytes by
    kind, ``get(arch, cell)`` (started with the module: the port traces
    meanwhile)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0",
               JAX_PLATFORMS="cpu")
    procs = [(a, subprocess.Popen(
        [sys.executable, "-c", REFERENCE, a, ",".join(names),
         json.dumps(SHAPES), json.dumps(FCVI)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)) for a, names in JOBS]
    cache: dict = {}
    done = set()

    def get(arch, cell):
        for i, ((a, names), (_, p)) in enumerate(zip(JOBS, procs)):
            if a == arch and cell in names and i not in done:
                out, err = p.communicate(timeout=600)
                assert p.returncode == 0, err[-3000:]
                cache.setdefault(a, {}).update(
                    json.loads(out.strip().splitlines()[-1]))
                done.add(i)
        return cache[arch][cell]

    yield get
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module", autouse=True)
def _shapes():
    SP.SHAPES.update(SHAPES)
    yield
    for k in SHAPES:
        SP.SHAPES.pop(k, None)


def _cfg(arch, capacity=None):
    """``reduced()``, as the reference's cells; ``capacity``: the MoE's
    capacity factor where given."""
    cfg = reduced(get_config(arch))
    if capacity is not None and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    return cfg


def _mesh(device):
    return make_mesh((2, 2), ("data", "model"), device=device)


def _counts(arch, shape, device, exact: bool) -> dict:
    """The cell's trace (every group, or the one-group shortcut) with its
    per-position arrays."""
    cfg = _cfg(arch)
    mesh = _mesh(device)

    return D.trace(lambda: SP.build_cell(cfg, arch, shape, mesh,
                                         device=device), mesh,
                   one_group=not exact)


def _coll(stats) -> dict:
    return {k: (v["bytes"], v["by_axis"]) for k, v in stats.by_kind.items()}


def test_fcvi_cell_finds_the_exact_pipeline_top_k():
    """The sharded FCVI cell (B2's plain version on each block, the tree
    merge, the gathered re-rank) returns the unsharded pipeline's ids: the
    exact L2 top-k' of the transformed queries, re-ranked."""
    from repro_torch.core.transform import psi_partition
    from repro_torch.kernels.ref import topk_first
    cell = SP.build_fcvi_cell(FCVI, _mesh("cpu"), device="cpu")
    vals, ids, _ = cell.run(S.CollectiveStats())
    x = {k: S.join(v) for k, v in cell.inputs.items()}
    q_t = psi_partition(x["q"], x["fq"], 1.0)
    d2 = (torch.sum(q_t * q_t, -1, keepdim=True) - 2.0 * q_t @
          x["corpus_t"].T + x["sq_norms"][None])
    _, cand = topk_first(-d2, FCVI["kprime"])

    def cos(c, q):
        return torch.sum(c * q[:, None], -1) / (
            torch.linalg.norm(c, dim=-1) * torch.linalg.norm(q, dim=-1)[
                :, None] + 1e-8)

    score = 0.5 * cos(x["vectors_n"][cand], x["q"]) + \
        0.5 * cos(x["filters_n"][cand], x["fq"])
    want, pos = topk_first(score, FCVI["k"])
    np.testing.assert_allclose(vals, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(ids.long(), torch.gather(cand, -1, pos))


@pytest.mark.parametrize("arch", ARCHS + ("whisper-large-v3",))
def test_sharded_prefill_decode_hold_to_unsharded(arch, one_thread):
    """``sharded_prefill`` and ``sharded_decode_step`` (caches along the
    sequence over the model axis, the RG-LRU's over rnn, the cross caches
    along the sequence) on (2, 2) against ``prefill`` and ``decode_step``
    with the same weights."""
    cfg = _cfg(arch, capacity=8.0)
    model = M.init_params(0, cfg, device="cpu")
    r = np.random.default_rng(0)
    b, s = 4, 64
    batch = {"tokens": torch.tensor(r.integers(0, cfg.vocab_size, (b, s)),
                                    dtype=torch.int32)}
    if cfg.enc_dec:
        batch["frames"] = torch.tensor(
            r.standard_normal((b, 48, cfg.d_model)), dtype=torch.float32)
    max_len = 128
    token = torch.tensor(r.integers(0, cfg.vocab_size, (b, 1)),
                         dtype=torch.int32)
    mesh = _mesh("cpu")
    structure = M.Model(cfg, torch.device("meta"))

    def joined(outs):
        return torch.cat([torch.cat(list(lg), -1) if isinstance(
            lg, S.Blocks) else lg for lg, _ in outs])

    hi = M.Model(cfg, torch.device("meta")).double().to_empty(device="cpu")
    hi.load_state_dict(model.state_dict())

    def unrounded(fn):
        keep = L.COMPUTE_DTYPE
        L.COMPUTE_DTYPE = torch.float64
        try:
            return fn()
        finally:
            L.COMPUTE_DTYPE = keep

    for kind in ("prefill", "decode"):
        rules = SP._cell_rules(arch, kind, b, mesh, None)
        specs = M.param_specs(cfg, rules)
        params = {k: S.place(p, specs[k], mesh)
                  for k, p in model.named_parameters()}
        with S.use_rules(rules):
            want, cache = M.prefill(model, batch, max_len)
            exact, exact_cache = unrounded(lambda: M.prefill(hi, batch,
                                                             max_len))
            if kind == "prefill":
                placed = {k: S.place(v, rules.spec("batch", *(
                    [None] * (v.ndim - 1))), mesh) for k, v in batch.items()}
                got = joined(M.sharded_prefill(structure, params, placed,
                                               max_len, rules))
            else:
                want, _ = M.decode_step(model, token, cache)
                exact, _ = unrounded(lambda: M.decode_step(hi, token,
                                                           exact_cache))
                placed = SP._place_tree(cache, SP.cache_pspecs(
                    cfg, rules, cfg.enc_dec), mesh)
                got = joined(M.sharded_decode_step(
                    structure, params, S.place(token, rules.spec(
                        "batch", None), mesh), placed, rules))
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        d_got = float(torch.linalg.norm(got.double() - want.double()))
        d_want = float(torch.linalg.norm(want.double() - exact))
        print(f"{arch} sharded {kind}: |sharded - unsharded| {d_got:.4g}, "
              f"|unsharded - unrounded| {d_want:.4g}")
        assert d_got <= UNROUNDED * d_want, (kind, d_got, d_want)


# the train cells last: their references take longest to compile
CELLS = [(a, s) for s in ("t_prefill", "t_decode", "t_train") for a in ARCHS]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_against_reference_and_cpu(arch, shape, reference, one_thread):
    short = _counts(arch, shape, "meta", exact=False)
    full = _counts(arch, shape, "meta", exact=True)
    cpu = _counts(arch, shape, "cpu", exact=True)
    ref = reference(arch, shape)
    flops = float(short["flops"].max())
    colls = {k: v["bytes"] / 4 for k, v in short["stats"].by_kind.items()}
    print(f"{arch} {shape}: dot FLOPs a position {flops:.4g} (reference "
          f"{ref['flops']:.4g}, {flops / ref['flops'] - 1:+.2%}); "
          f"collective bytes a position {colls} (reference "
          f"{ref['collectives']})")
    assert flops == pytest.approx(ref["flops"], rel=FLOPS_RTOL)
    # the meta trace equals the real CPU run
    for key in ("flops", "conv_flops"):
        assert np.array_equal(full[key], cpu[key]), key
    np.testing.assert_allclose(full["bytes"], cpu["bytes"], rtol=1e-6)
    assert _coll(full["stats"]) == _coll(cpu["stats"])
    assert full["exec"]["flops"] == cpu["exec"]["flops"]
    # one group stands for all, position by position
    for key in ("flops", "conv_flops", "bytes", "peak"):
        assert np.array_equal(short[key], full[key]), key
    assert _coll(short["stats"]) == _coll(full["stats"])


def test_fcvi_cell_against_reference_and_cpu(reference):
    mesh = _mesh("meta")
    meta = D.trace(lambda: SP.build_fcvi_cell(FCVI, mesh), mesh)
    cpu_mesh = _mesh("cpu")
    cpu = D.trace(lambda: SP.build_fcvi_cell(
        FCVI, cpu_mesh, device="cpu"), cpu_mesh)
    ref = reference("gemma3-1b", "t_fcvi")
    flops = float(meta["flops"].max())
    print(f"fcvi base n={FCVI['n']}: dot FLOPs a position {flops:.4g} "
          f"(reference {ref['flops']:.4g}); collective bytes a position "
          f"{ {k: v['bytes'] / 4 for k, v in meta['stats'].by_kind.items()} }"
          f" (reference {ref['collectives']})")
    assert flops == pytest.approx(ref["flops"], rel=FLOPS_RTOL)
    assert meta["kernels"]["score_topk"]["calls"] == 4
    assert np.array_equal(meta["flops"], cpu["flops"])
    assert np.array_equal(meta["bytes"], cpu["bytes"])
    assert _coll(meta["stats"]) == _coll(cpu["stats"])

