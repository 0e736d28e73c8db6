"""The sharded serving passes' layer-scoped FSDP gather
(``models.model.sharded_prefill`` / ``sharded_decode_step``,
``ShardGroup.layer``), on dbrx-132b's ``reduced()`` config (4
experts, ``moe_ff`` over the batch's ``data`` axis by
``SERVE_EXTRA_RULES``) on a (2, 2) ("data", "model") mesh, prefill and
decode of 4 x 128 tokens, traced on meta positions at 2 and 4 layers,
every group and layer.

Each position gathers its experts' ``moe_ff`` columns whole at the
layer's first use (an all-gather over ``data``) and drops them where the
layer ends. Held:

* the live peak's growth a layer, position by position, equals the
  layer's own parameter blocks and cache by hand count: no gathered
  weight is left behind;
* with the group-long gather (the train step's, reached here through
  the ``whole_group_gather`` fixture) the growth is that plus the
  position's own gathered experts, one member's and not the group's (the
  cost trace charges a gathered leaf to the positions holding it);
* the collective bytes equal the group-long gather's and the hand count
  of one gather a weight a layer;
* the sharded prefill's and decode's logits and caches bit-equal to the
  group-long gather's, on CPU positions;
* ``depth_plan``'s replayed peak equal to the trace at depth.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from test_torch_support import one_thread  # noqa: F401

ARCH = "dbrx-132b"
SHAPES = {"t_prefill": dict(kind="prefill", seq=128, batch=4),
          "t_decode": dict(kind="decode", seq=128, batch=4)}
GROUPS, MEMBERS = 2, 2       # batch groups (data), model positions a group


@pytest.fixture(scope="module", autouse=True)
def _shapes():
    SP.SHAPES.update(SHAPES)
    yield
    for k in SHAPES:
        SP.SHAPES.pop(k, None)


@pytest.fixture
def whole_group_gather(monkeypatch):
    """The group-long gather: a gathered leaf kept to the group's end."""
    monkeypatch.setattr(M.ShardGroup, "layer",
                        lambda self: contextlib.nullcontext())


def _cfg(layers: int, capacity=None):
    cfg = dataclasses.replace(reduced(get_config(ARCH)), n_layers=layers)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity)
    return cfg


def _mesh(device):
    return make_mesh((2, 2), ("data", "model"), device=device)


def _trace(shape: str, layers: int) -> dict:
    mesh = _mesh("meta")
    return D.trace(lambda: SP.build_cell(_cfg(layers), ARCH, shape, mesh),
                   mesh, one_group=False)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _expert_bytes(cfg) -> int:
    """One position's gathered experts a layer: its E / MEMBERS experts of
    ``we_in``, ``we_gate`` and ``we_out`` with ``moe_ff`` whole, bf16."""
    return 3 * (cfg.moe_experts // MEMBERS) * cfg.d_model * cfg.moe_d_ff * 2


def _layer_bytes(shape: str) -> np.ndarray:
    """By hand, for each position: the bytes of layer 1's parameter blocks
    it holds, and of the layer's cache: decode holds the input cache's
    blocks and writes a new cache of the same blocks; prefill writes the
    layer's cache as the step returns it (a member's ``Blocks`` entry, or
    a whole tensor every group position holds), measured on a CPU run,
    but for its 0-d ``pos``: a fill no op of the pass reads, which a cost
    trace charges to no position (``cost_analysis``: a fill is charged
    where it is first read, here the next decode step)."""
    cfg = _cfg(2)
    mesh = _mesh("meta")
    cell = SP.build_cell(cfg, ARCH, shape, mesh)
    out = np.zeros(mesh.size)
    flat = {pos: i for i, (pos, _) in enumerate(S.positions(mesh))}
    for name, p in cell.inputs["params"].items():
        if name.startswith("layers.1."):
            for pos, i in flat.items():
                out[i] += _nbytes(p.blocks[pos])
    if shape == "t_decode":
        for p in cell.inputs["cache"]["self"][1].values():
            for pos, i in flat.items():
                out[i] += 2 * _nbytes(p.blocks[pos])
        return out
    cpu = SP.build_cell(cfg, ARCH, shape, _mesh("cpu"), device="cpu")
    with S.use_rules(cpu.rules):
        res = cpu.run(S.CollectiveStats())
    for (_, cache), coords in zip(res, M.batch_groups(cpu.rules)):
        group = M.ShardGroup(cpu.mesh, cpu.rules, coords, {})
        for name, t in cache["self"][1].items():
            if name == "pos":
                continue
            if isinstance(t, S.Blocks):
                for held, blk in zip(t.group.positions, t):
                    out[list(held)] += _nbytes(blk)
            else:
                out[group.positions] += _nbytes(t)
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
def test_peak_grows_by_the_layer_alone(shape, one_thread):
    t2, t4 = _trace(shape, 2), _trace(shape, 4)
    grow = (t4["peak"] - t2["peak"]) / 2
    want = _layer_bytes(shape)
    print(f"dbrx reduced {shape}: peak a position at 2 / 4 layers "
          f"{t2['peak'].max():.0f} / {t4['peak'].max():.0f} bytes; a layer "
          f"adds {grow.tolist()}, its blocks and cache {want.tolist()}")
    assert np.array_equal(grow, want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_group_long_gather_keeps_one_members_experts(
        shape, whole_group_gather, one_thread):
    """The train step's group-long gather keeps each layer's gathered
    experts to the end: a layer then adds the position's own experts
    (its member's leaves), not every member's."""
    t2, t4 = _trace(shape, 2), _trace(shape, 4)
    grow = (t4["peak"] - t2["peak"]) / 2
    assert np.array_equal(grow, _layer_bytes(shape)
                          + _expert_bytes(_cfg(2)))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_collectives_unchanged_and_one_gather_a_weight_a_layer(
        shape, monkeypatch, one_thread):
    layers = 4
    scoped = _trace(shape, layers)["stats"].by_kind
    with monkeypatch.context() as mp:
        mp.setattr(M.ShardGroup, "layer",
                   lambda self: contextlib.nullcontext())
        whole = _trace(shape, layers)["stats"].by_kind
    assert scoped == whole
    # each layer, each group, each member: its experts' three weights
    # whole along moe_ff, the blocks of both data positions
    want = layers * GROUPS * MEMBERS * _expert_bytes(_cfg(layers))
    assert scoped["all-gather"]["by_axis"]["data"] == want


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_logits_and_caches_bit_equal_to_the_group_long_gather(
        kind, monkeypatch, one_thread):
    cfg = _cfg(3, capacity=8.0)
    model = M.init_params(0, cfg, device="cpu")
    r = np.random.default_rng(0)
    b, s, max_len = 4, 64, 128
    batch = {"tokens": torch.tensor(r.integers(0, cfg.vocab_size, (b, s)),
                                    dtype=torch.int32)}
    token = torch.tensor(r.integers(0, cfg.vocab_size, (b, 1)),
                         dtype=torch.int32)
    mesh = _mesh("cpu")
    rules = SP._cell_rules(ARCH, kind, b, mesh, None)
    specs = M.param_specs(cfg, rules)
    params = {k: S.place(p, specs[k], mesh)
              for k, p in model.named_parameters()}
    structure = M.Model(cfg, torch.device("meta"))

    def run():
        with S.use_rules(rules):
            if kind == "prefill":
                placed = {k: S.place(v, rules.spec("batch", None), mesh)
                          for k, v in batch.items()}
                return M.sharded_prefill(structure, params, placed, max_len,
                                         rules)
            _, cache = M.prefill(model, batch, max_len)
            placed = SP._place_tree(cache, SP.cache_pspecs(
                cfg, rules, cfg.enc_dec), mesh)
            return M.sharded_decode_step(
                structure, params, S.place(token, rules.spec("batch", None),
                                           mesh), placed, rules)

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            x = list(x.values())
        return [t for y in (x or []) for t in leaves(y)]

    got = leaves(run())
    with monkeypatch.context() as mp:
        mp.setattr(M.ShardGroup, "layer",
                   lambda self: contextlib.nullcontext())
        want = leaves(run())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_replayed_peak_equals_the_trace_at_depth(shape, one_thread):
    cfg = _cfg(5)
    mesh = _mesh("meta")

    def build(c):
        return SP.build_cell(c, ARCH, shape, mesh)

    short = D.traced_counts(cfg, build, mesh, one_group=True)
    full = D.traced_counts(cfg, build, mesh, one_group=False,
                           exact_depth=True)
    assert short["depth"] == "replayed"
    for key in ("flops", "bytes", "peak"):
        assert np.array_equal(short[key], full[key]), key
    assert short["collectives"] == full["collectives"]
