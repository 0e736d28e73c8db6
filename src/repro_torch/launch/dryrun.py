"""Dry-run every (arch x shape x mesh) cell of the port on the meta device.
The counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell ahead of time on 512
placeholder host devices and reads the compiled module. Here each cell's
inputs are placed on a production mesh of meta positions (nothing is
allocated) and the port's own sharded step runs over them under
``cost_analysis.CostMode``: per-position dot FLOPs, op-boundary bytes and
live bytes, the collectives the step records, the H100's roofline terms
and the useful-FLOPs share, written to
``artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fcvi --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --variant fcvi-opt --mesh both

Two shortcuts keep a production cell to minutes (``run_cell``'s
``one_group``/``exact_depth`` turn them off;
``tests/test_torch_dryrun_shortcuts.py`` holds both to the full trace,
position by position):

* one batch group stands for all: every group runs the same program on
  its own rows, so only the first group's forward and backward run
  (``sharded_grads``' ``groups``), its positions' counts and live bytes
  are copied to the other groups' positions, whose gradients are empties
  of the same shapes, and the collectives in its profiler range
  ``"batch group 0"`` are recorded once for each group. In training,
  microbatch 1 also stands for every later one (``micro=[0, 1]``, its
  range weighted ``n_micro - 1``; the later microbatches' rows, which
  other groups may hold, recorded one by one). The gradient sync and the
  update run over every position.
* in a serving pass (prefill, decode) a few layers stand for all: each
  layer's program depends on its kind alone, so every count is affine in
  the layers of each kind, and ``depth_plan``'s few shallow traces,
  weighted, give the counts at the published depth. The live peak is a
  maximum over time, not a sum: it comes from ``replay_peak``, which
  walks the deep pass segment by segment from the shallow traces' (each
  layer's rise and net change by kind, cut by the model's ``"layer i"``
  profiler ranges), and where the shallow traces break its rules the
  cell is traced at its depth after all (``depth`` says which). A
  training step (whose backward recomputes each layer) is traced at its
  depth.

Keys as the reference's ``run_cell`` writes them where the meaning is the
same: ``per_device_flops`` (dot FLOPs of the busiest position),
``per_device_collective_bytes``, ``collectives`` (by kind: bytes, count,
by axis, by group size; bytes summed over participants as the reference's
HLO counts them per device times the devices), ``roofline``,
``params_total``, ``params_active``, ``model_flops_global`` (the
reference's ``model_flops``), ``useful_flops_fraction`` (``USEFUL_NOTE``:
it can pass 100%), ``memory.peak_estimate_bytes`` (the busiest
position's live peak) and ``status`` (``ok``, ``skipped`` with
``cell_applicable``'s reason, or ``error``). ``per_device_bytes`` is
op-boundary bytes, eager PyTorch's traffic op by op (the reference's is
XLA's ``memory_analysis`` over fused ops); ``trace_s`` takes the place of
``lower_s`` and ``compile_s``; ``card`` names the card whose peaks the
roofline uses. ``gathered`` names what a position gathers
whole at a layer's start (``models.model.GATHERED``, FSDP dimensions):
the counts include those gathers as the step runs them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as S
from repro_torch.launch import cost_analysis as C
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

# per-(arch, shape) microbatching for train cells that need activation relief
N_MICRO = {
    ("dbrx-132b", "train_4k"): 16,
    ("internvl2-26b", "train_4k"): 8,
    ("gemma2-27b", "train_4k"): 8,
    ("mistral-nemo-12b", "train_4k"): 8,
    ("whisper-large-v3", "train_4k"): 8,
    ("starcoder2-7b", "train_4k"): 4,
    ("gemma3-1b", "train_4k"): 2,
    ("recurrentgemma-2b", "train_4k"): 2,
    ("granite-moe-3b-a800m", "train_4k"): 4,
}

# the reference's variants
VARIANTS = {
    # xlstm replicates its mixers over 'model': pure 256-way DP instead
    "xlstm-dp256": dict(arch="xlstm-125m", shape="train_4k",
                        extra_rules={"batch": ("data", "model"),
                                     "vocab": None}),
    # granite's experts replicated with their ff split: replicate the ff
    "granite-repl-ff": dict(arch="granite-moe-3b-a800m", shape="train_4k",
                            extra_rules={"moe_ff": None}),
    "granite-repl-ff-m4": dict(arch="granite-moe-3b-a800m", shape="train_4k",
                               extra_rules={"moe_ff": None}, n_micro=2),
    # the paper's serving step with a bf16 transformed corpus
    "fcvi-bf16": dict(arch="fcvi", shape="serve_268m", fcvi_variant="bf16"),
    # the IVF layout: each block probes 8 of its 64 lists (B7)
    "fcvi-ivf8": dict(arch="fcvi", shape="serve_268m", fcvi_variant="ivf8"),
    # ... with 64 candidates a block into the merge tree
    "fcvi-ivf8-trunc": dict(arch="fcvi", shape="serve_268m",
                            fcvi_variant="ivf8-trunc"),
    # ... and the re-rank computed where the rows are
    "fcvi-opt": dict(arch="fcvi", shape="serve_268m", fcvi_variant="opt"),
}


def active_params(cfg, named: dict) -> int:
    """Active (per-token) parameter count: experts counted top_k / E."""
    total = 0
    for name, p in named.items():
        n = int(np.prod(p.shape))
        leaf = name.split(".")[-1]
        if cfg.is_moe and leaf in ("we_in", "we_gate", "we_out"):
            n = int(n * cfg.moe_top_k / cfg.moe_experts)
        total += n
    return total


def tokens_of(cfg, shape: str, shapes: Optional[dict] = None) -> int:
    info = (shapes or SP.SHAPES)[shape]
    if info["kind"] == "train":
        seq = SP.WHISPER_DEC_LEN + info["seq"] if cfg.enc_dec else info["seq"]
        return info["batch"] * seq
    if info["kind"] == "prefill":
        return info["batch"] * info["seq"]
    return info["batch"]  # decode: 1 new token per sequence


def gathered_kinds(cfg, rules) -> list:
    """What a position gathers whole at a layer's start under ``rules``."""
    out = []
    if any(k in ("mlstm", "slstm") for k in cfg.pattern):
        out.append("mLSTM/sLSTM weights (models.model.GATHERED)")
    batch = set(S.axes_of(rules.rules.get("batch")))
    for name in ("moe_ff", "ff", "embed", "experts"):
        if set(S.axes_of(rules.rules.get(name))) & batch:
            out.append(f"{name} split over batch axes (FSDP)")
    return out


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

def placed_leaves(tree) -> list:
    """The ``Placed`` leaves of nested dicts, lists and tuples."""
    if isinstance(tree, S.Placed):
        return [tree]
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in placed_leaves(v)]
    if isinstance(tree, (list, tuple)):       # AdamWState too
        return [p for v in tree for p in placed_leaves(v)]
    return []


class WeightedStats(S.CollectiveStats):
    """Collectives recorded as many times as the runs they stand for: the
    mode's ``weight`` (a microbatch for the later ones) times ``times`` of
    each open profiler range (a batch group's forward and backward for
    every group's)."""

    def __init__(self, mode: C.CostMode, times: Optional[dict] = None):
        super().__init__()
        self.mode, self.times = mode, dict(times or {})

    def add(self, kind: str, axis: str, nbytes: int) -> None:
        w = self.mode.weight
        for r in self.mode.ranges:
            w *= self.times.get(r, 1)
        w = int(w)
        rec = self.by_kind.setdefault(kind, {"bytes": 0, "count": 0,
                                             "by_axis": {}})
        rec["bytes"] += w * int(nbytes)
        rec["count"] += w
        rec["by_axis"][axis] = rec["by_axis"].get(axis, 0) + w * int(nbytes)


def trace(build, mesh, one_group: bool = True,
          segments: bool = False) -> dict:
    """Build a cell (``build()``, on meta positions) and run its step once
    under a ``CostMode``. Returns the counts: per position arrays, executed
    totals, collectives (a ``CollectiveStats``), kernel calls and, with
    ``segments``, the live bytes' segments (``CostMode.end_segments``).

    ``one_group``: the first batch group stands for every group (each runs
    the same program on its own rows): only its forward and backward run,
    its positions' counts and live bytes are copied to the others', and
    their gradients are empties of its shapes held by their own positions;
    their collectives are recorded once for each group. In training,
    microbatch 1 also stands for every later one (``"microbatch 1"``
    weighted ``n_micro - 1``; the later ones' rows, which other groups may
    hold, still recorded one by one)."""
    cm = C.CostMode(mesh)
    cm.counting = False
    if segments:
        cm.segments = []
    copies = []
    t0 = time.perf_counter()
    with cm:
        cell = build()
        groups = M.batch_groups(cell.rules)
        params = cell.inputs.get("params", {})
        shards = [M.ShardGroup(mesh, cell.rules, c, params) for c in groups]
        cm.claim_inputs(placed_leaves(cell.inputs))
        cm.start()
        shortcut = one_group and len(groups) > 1 and cell.kind in (
            "train", "prefill", "decode")
        stats = WeightedStats(cm, {"batch group 0": len(groups)}
                              if shortcut else None)
        if not shortcut:
            out = cell.run(stats)
        elif cell.kind == "train":
            n = cell.n_micro
            micro = [0, 1] if n > 2 else None
            cm.weights = {"microbatch 1": n - 1} if n > 2 else {}

            def fill(grads):
                """The other groups' gradients and counts."""
                for g, dst in enumerate(shards[1:], 1):
                    cm.copy_positions(shards[0].positions, dst.positions)
                    copies.append((shards[0].positions, dst.positions))
                    grads[g] = {}
                    for name, ts in grads[0].items():
                        held = (dst.tp.positions if len(ts) > 1
                                else [frozenset(dst.positions)])
                        grads[g][name] = [cm.adopt(torch.empty(
                            t.shape, dtype=t.dtype, device=t.device), p)
                            for t, p in zip(ts, held)]
                if micro is not None:
                    _skipped_rows(cell, shards, range(2, n), stats)

            out = cell.run(stats, groups=[0], micro=micro, fill=fill)
        else:
            # a serving pass runs group by group: all of it for each
            own = WeightedStats(cm)
            out = cell.run(own, groups[:1])
            stats.merge(own, times=len(groups))
        if segments:
            cm.end_segments()
        if shortcut and cell.kind != "train":
            for dst in shards[1:]:
                cm.copy_positions(shards[0].positions, dst.positions)
                copies.append((shards[0].positions, dst.positions))
        del out
    return {"flops": cm.flops.copy(), "conv_flops": cm.conv_flops.copy(),
            "bytes": cm.bytes.copy(), "peak": cm.peak.copy(),
            "exec": dict(cm.exec, peak_bytes=cm.exec_peak),
            "stats": stats, "kernels": {
                k: {"calls": v["calls"], "flops": v["flops"],
                    "bytes": v["bytes"],
                    "per_position_calls": v["per_position_calls"].copy()}
                for k, v in cm.kernels.items()},
            "segments": cm.segments, "start_live": cm.start_live,
            "copies": copies, "ops": cm.ops, "joins": cm.joins,
            "cell": cell, "trace_s": time.perf_counter() - t0}


def _skipped_rows(cell, shards: list, micro, stats) -> None:
    """Record the row moves of the microbatches a trace skips (whose
    holders differ from microbatch to microbatch)."""
    from repro_torch.train import loop as train_loop
    groups = [s.coords for s in shards]
    for i in micro:
        for g, s in enumerate(shards):
            train_loop._rows(cell.inputs["batch"], groups, g, i,
                             cell.n_micro, s, cell.rules, stats)


def _wsum(parts: list):
    """The weighted sum of nested results (numbers, arrays, dicts)
    ``[(result, weight)]``; a key missing from a result counts 0."""
    first = parts[0][0]
    if isinstance(first, dict):
        keys = []
        for r, _ in parts:
            keys += [k for k in r if k not in keys]
        return {k: _wsum([(r[k], w) for r, w in parts if k in r])
                for k in keys}
    return sum(w * r for r, w in parts)


def _numbers(t: dict) -> dict:
    """A trace's counts: every one a sum over ops, so affine in the layers
    of each kind (the peaks are not: ``replay_peak``)."""
    return {"flops": t["flops"], "conv_flops": t["conv_flops"],
            "bytes": t["bytes"],
            "exec": {k: v for k, v in t["exec"].items()
                     if k != "peak_bytes"},
            "collectives": {k: {"bytes": v["bytes"], "count": v["count"],
                                "by_axis": v["by_axis"]}
                            for k, v in t["stats"].by_kind.items()},
            "kernels": t["kernels"]}


def depth_plan(cfg) -> list:
    """[(config, weight)]: shallow configs whose counts, weighted and
    summed, are ``cfg``'s at its depth. Each layer's program depends on
    its kind alone, so a count is affine in the layers of each kind: where
    it traces fewer layers, one layer of each kind plus, for each kind
    with more, a trace with one more of it; else one period and two
    (the rest layers kept). An encoder-decoder adds a trace with a second
    encoder layer."""
    kinds = cfg.layer_kinds()
    distinct = sorted(set(kinds), key=kinds.index)
    count = {k: kinds.count(k) for k in distinct}
    e1 = 1 if cfg.enc_dec else 0
    period, rest = cfg.period, len(cfg.rest_kinds)
    if len(distinct) * (len(distinct) + 2) < 3 * period + 2 * rest:
        def shallow(extra=()):
            pattern = tuple(distinct) + tuple(extra)
            return dataclasses.replace(cfg, pattern=pattern,
                                       n_layers=len(pattern),
                                       n_enc_layers=e1)
        plan = [(shallow(), 1 - sum(n - 1 for n in count.values()))]
        plan += [(shallow((k,)), count[k] - 1) for k in distinct
                 if count[k] > 1]
    else:
        n = cfg.n_periods
        plan = [(dataclasses.replace(cfg, n_layers=p * period + rest,
                                     n_enc_layers=e1), w)
                for p, w in ((1, 2 - n), (2, n - 1))]
    enc = cfg.n_enc_layers if cfg.enc_dec else 0
    if enc > 1:
        base, w = plan[0]
        plan[0] = (base, w - (enc - 1))
        plan.append((dataclasses.replace(base, n_enc_layers=2), enc - 1))
    return [(c, w) for c, w in plan if w != 0]


def _loop_kinds(cfg, loop: str) -> list:
    return (["enc"] * cfg.n_enc_layers if loop == "encoder layer"
            else cfg.layer_kinds())


def _items(t: dict, cfg) -> tuple:
    """A trace's segments as items: ``("seg", rise, net)`` between the
    model's layer loops, ``("loop", name, [(kind, rise, net)])`` for each
    loop over every layer in order. Returns (items, None), or (None, why)
    where a layer's segment lies outside such a loop."""
    items = []
    for label, rise, net in t["segments"]:
        if label is None:
            items.append(("seg", rise, net))
            continue
        loop, i = label
        last = items[-1] if items else None
        if (last is not None and last[0] == "loop" and last[1] == loop
                and len(last[2]) == i):
            last[2].append((_loop_kinds(cfg, loop)[i], rise, net))
        elif i == 0:
            items.append(("loop", loop, [(_loop_kinds(cfg, loop)[0], rise,
                                          net)]))
        else:
            return None, f"{loop} {i} outside a loop over the layers"
    for it in items:
        if it[0] == "loop" and len(it[2]) != len(_loop_kinds(cfg, it[1])):
            return None, f"a loop over {len(it[2])} of the layers"
    return items, None


def replay_peak(runs: list, cfg) -> tuple:
    """The live peak of ``cfg``'s trace, per position and (last) as
    executed, from the segments of the shallow traces ``runs``
    (``[(trace, weight, shallow config)]``, ``depth_plan``'s). Each layer
    of a loop over the layers rises above its start and changes the live
    bytes by its kind's amounts; a segment between the loops rises by the
    same amount in every trace, and changes the live bytes, as it does the
    bytes at the start (the inputs), by an amount affine in the layers
    (what it frees of them). The deep trace is walked segment by segment.
    Returns (peak, None), or (None, why) where the traces break these
    rules."""
    shapes, loops, segs = [], {}, []
    for t, w, c in runs:
        items, why = _items(t, c)
        if why:
            return None, why
        shapes.append([(it[0], it[1] if it[0] == "loop" else None)
                       for it in items])
        for n, it in enumerate([it for it in items if it[0] == "loop"]):
            for kind, rise, net in it[2]:
                have = loops.setdefault((n, kind), (rise, net))
                if not (np.array_equal(have[0], rise)
                        and np.array_equal(have[1], net)):
                    return None, (f"a {kind} {it[1]} of loop {n} differs "
                                  "between layers or traces")
        segs.append([(it[1], it[2], w) for it in items if it[0] == "seg"])
    if any(sh != shapes[0] for sh in shapes):
        return None, "the traces' segments differ in order"
    for j, first in enumerate(segs[0]):
        if any(not np.array_equal(s[j][0], first[0]) for s in segs):
            return None, (f"segment {j} between the loops rises by "
                          "different amounts")
    live = sum(w * t["start_live"] for t, w, _ in runs)
    peak = live.copy()
    j = n = 0
    for what, loop in shapes[0]:
        if what == "seg":
            steps = [(segs[0][j][0], sum(s[j][2] * s[j][1] for s in segs))]
            j += 1
        else:
            steps = [loops[(n, k)] for k in _loop_kinds(cfg, loop)]
            n += 1
        for rise, net in steps:
            peak = np.maximum(peak, live + rise)
            live = live + net
    return peak, None


def traced_counts(cfg, build_for, mesh, one_group: bool = True,
                  exact_depth: bool = False) -> dict:
    """The cell's counts at ``cfg``'s depth: one trace of ``cfg``
    (``exact_depth``), or the weighted sum of ``depth_plan``'s shallow
    traces with the peaks from ``replay_peak`` (module docstring), or
    where the shallow traces break its rules, one trace of ``cfg`` after
    all (``depth`` says which).
    ``build_for(cfg)`` builds the cell."""
    depth = "exact"
    if not exact_depth:
        plan = depth_plan(cfg)
        runs = [(trace(lambda c=c: build_for(c), mesh, one_group,
                       segments=True), w, c) for c, w in plan]
        peak, why = replay_peak(runs, cfg)
        depth = f"exact ({why})" if why else "replayed"
    if depth != "replayed":
        runs = [(trace(lambda: build_for(cfg), mesh, one_group), 1, cfg)]
        t = runs[0][0]
        peak = np.append(t["peak"], t["exec"]["peak_bytes"])
    else:
        for src, dst in runs[0][0]["copies"]:
            peak[list(dst)] = peak[list(src)]
    out = _wsum([(_numbers(t), w) for t, w, _ in runs])
    out["peak"] = peak[:-1]
    out["exec"]["peak_bytes"] = float(peak[-1])
    return dict(out, trace_s=sum(t["trace_s"] for t, _, _ in runs),
                ops=sum(t["ops"] for t, _, _ in runs),
                cell=runs[-1][0]["cell"], traces=len(runs), depth=depth)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _collectives(counts: dict, mesh) -> tuple:
    stats = S.CollectiveStats()
    stats.by_kind = {k: {"bytes": float(v["bytes"]),
                         "count": float(v["count"]),
                         "by_axis": {a: float(b) for a, b in
                                     v["by_axis"].items()}}
                     for k, v in counts["collectives"].items()}
    summary = C.collective_summary(stats, mesh)
    total = sum(v["bytes"] for v in summary.values())
    axes = {a: b / mesh.size for a, b in C.by_axis(stats).items()}
    return summary, total / mesh.size, axes


def _result(counts: dict, mesh, peak: float = C.PEAK_BF16_S) -> dict:
    """The JSON's counts; ``peak``: the FLOP rate of the roofline's compute
    term (bf16 for the LMs' bf16 products, TF32 for the fp32 flat scan)."""
    flops = float(np.max(counts["flops"]))
    nbytes = float(np.max(counts["bytes"]))
    colls, coll_pd, axes = _collectives(counts, mesh)
    return {
        "per_device_flops": flops,
        "per_device_conv_flops": float(np.max(counts["conv_flops"])),
        "per_device_bytes": nbytes,
        "per_device_collective_bytes": coll_pd,
        "collectives": colls,
        "roofline": C.roofline_terms(flops, nbytes, axes, mesh, peak),
        "memory": {"peak_estimate_bytes": float(np.max(counts["peak"])),
                   "device_bytes": C.DEVICE_BYTES},
        "executed": {k: float(v) for k, v in counts["exec"].items()},
        "kernels": {k: {"calls": float(v["calls"]),
                        "per_device_calls": float(
                            np.max(v["per_position_calls"])),
                        "flops": float(v["flops"]),
                        "bytes": float(v["bytes"])}
                    for k, v in counts["kernels"].items()},
        "trace_s": round(counts["trace_s"], 2), "traces": counts["traces"],
        "ops": int(counts["ops"]),
        "card": f"{C.CARD}, {C.POWER_LIMIT_W} W",
    }


def cell_result(t: dict, mesh, peak: float = C.PEAK_BF16_S) -> dict:
    """The JSON's counts of one ``trace`` (no depth extrapolation)."""
    return _result(dict(_numbers(t), peak=t["peak"],
                        exec=dict(t["exec"]), trace_s=t["trace_s"],
                        ops=t["ops"], traces=1), mesh, peak)


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             extra_rules=None, n_micro_override=None, tag: str = "",
             mesh=None, cfg=None, one_group: bool = True,
             exact_depth: bool = False) -> dict:
    """One LM cell's dry-run (``mesh``/``cfg``: another mesh of meta
    positions or config than the production ones, as tests use). A train
    cell is traced at its depth; a serving cell through ``depth_plan``
    unless ``exact_depth``."""
    if arch == "fcvi":
        return run_fcvi_cell(shape, multi_pod, verbose, tag=tag, mesh=mesh)
    cfg = cfg or get_config(arch)
    ok, reason = SP.cell_applicable(cfg, shape)
    mesh_name = _mesh_name(multi_pod) if mesh is None else "x".join(
        str(s) for s in mesh.devices.shape)
    result = {"arch": arch, "shape": shape + tag, "mesh": mesh_name}
    if not ok:
        result.update(status="skipped", reason=reason)
        return result
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device="meta")
    n_micro = n_micro_override or N_MICRO.get((arch, shape), 1)

    def build_for(c):
        return SP.build_cell(c, arch, shape, mesh, n_micro=n_micro,
                             extra_rules=extra_rules,
                             device=mesh.devices.flat[0])

    exact_depth = exact_depth or SP.SHAPES[shape]["kind"] == "train"
    counts = traced_counts(cfg, build_for, mesh, one_group, exact_depth)
    cell = counts["cell"]
    structure = M.Model(cfg, torch.device("meta"))
    named = dict(structure.named_parameters())
    n_total = sum(int(np.prod(p.shape)) for p in named.values())
    n_active = active_params(cfg, named)
    mf = C.model_flops(n_active, tokens_of(cfg, shape), cell.kind)
    result.update(status="ok", kind=cell.kind, n_micro=cell.n_micro,
                  depth=counts["depth"], one_group=one_group,
                  **_result(counts, mesh))
    flops = result["per_device_flops"]
    result.update(params_total=n_total, params_active=n_active,
                  model_flops_global=mf,
                  useful_flops_fraction=mf / (flops * mesh.size)
                  if flops else 0.0,
                  gathered=gathered_kinds(cfg, cell.rules))
    if verbose:
        _report(result)
    return result


def run_fcvi_cell(shape: str, multi_pod: bool, verbose: bool = True,
                  fcvi_variant: str = "base", tag: str = "",
                  mesh=None) -> dict:
    mesh_name = _mesh_name(multi_pod) if mesh is None else "x".join(
        str(s) for s in mesh.devices.shape)
    result = {"arch": "fcvi", "shape": (shape if isinstance(shape, str)
                                        else "custom") + tag,
              "mesh": mesh_name, "variant": fcvi_variant}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod, device="meta")
    info = SP.FCVI_SHAPES[shape] if isinstance(shape, str) else shape
    t = trace(lambda: SP.build_fcvi_cell(
        shape, mesh, variant=fcvi_variant, device=mesh.devices.flat[0]),
        mesh)
    peak = C.PEAK_TF32_S if fcvi_variant == "base" else C.PEAK_BF16_S
    result.update(status="ok", kind="fcvi_serve", n_micro=1,
                  **cell_result(t, mesh, peak))
    # useful work: 2 n d FLOPs of exact scoring a query (an IVF cell
    # scores an eighth of the rows: ``USEFUL_NOTE``)
    mf = 2.0 * info["n"] * info["d"] * info["batch"]
    flops = result["per_device_flops"]
    result.update(params_total=0, params_active=0, model_flops_global=mf,
                  useful_flops_fraction=mf / (flops * mesh.size)
                  if flops else 0.0, gathered=[])
    if verbose:
        _report(result)
    return result


def _report(r: dict) -> None:
    peak_gb = r["memory"]["peak_estimate_bytes"] / 1e9
    print(f"[{r['arch']} {r['shape']} {r['mesh']}] ok trace="
          f"{r['trace_s']:.1f}s peak/dev={peak_gb:.2f}GB "
          f"flops/dev={r['per_device_flops']:.4g} "
          f"bytes/dev={r['per_device_bytes']:.4g} "
          f"coll/dev={r['per_device_collective_bytes']:.4g}B "
          f"dominant={r['roofline']['dominant']} "
          f"bound={r['roofline']['step_lower_bound_s']:.4g}s "
          f"useful={r['useful_flops_fraction']:.2%}", flush=True)


def save_result(res: dict, art_dir: str = ART_DIR) -> str:
    os.makedirs(art_dir, exist_ok=True)
    path = os.path.join(art_dir,
                        f"{res['arch']}_{res['shape']}_{res['mesh']}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return path


USEFUL_NOTE = ("useful = model_flops_global over the dot FLOPs of every "
               "position, model_flops being the reference's 6 N T (2 N T "
               "serving) over every active parameter: it counts the "
               "embedding table as a product for each token (a lookup "
               "computes nothing, and prefill unembeds its last position "
               "only) and whisper's encoder and decoder tokens each against "
               "both stacks, and the dot FLOPs leave out convolutions; the "
               "FCVI cells' model_flops is the reference's 2 n d a query of "
               "an exact scan, which an IVF cell (fcvi-ivf8, -trunc, -opt) "
               "runs over the eighth of the rows its probes reach; so it "
               "can pass 100%: a ratio to a yardstick, not a share of the "
               "work")


def table(results: list) -> str:
    """One line a cell: arch, shape, mesh, status, the busiest position's
    peak against the card's 80 GB, the dominant term and the bound."""
    lines = [f"{'arch':22s} {'shape':12s} {'mesh':11s} {'peak GB':>8s} "
             f"{'fits':>4s} {'dominant':>10s} {'bound s':>10s} "
             f"{'useful':>7s}"]
    for r in results:
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:11s} "
                         f"{r.get('status')}: {r.get('reason') or r.get('error')}")
            continue
        gb = r["memory"]["peak_estimate_bytes"] / 1e9
        lines.append(f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:11s} "
                     f"{gb:8.2f} {'yes' if gb <= 80 else 'no':>4s} "
                     f"{r['roofline']['dominant']:>10s} "
                     f"{r['roofline']['step_lower_bound_s']:10.4g} "
                     f"{r['useful_flops_fraction']:7.2%}")
    if any(r.get("useful_flops_fraction", 0) > 1 for r in results):
        lines.append(USEFUL_NOTE)
    return "\n".join(lines)


SUMMARY_KEYS = ("arch", "shape", "mesh", "status", "reason", "error", "kind",
                "n_micro", "depth", "one_group", "per_device_flops", "per_device_bytes",
                "per_device_collective_bytes", "roofline",
                "useful_flops_fraction", "params_total", "params_active",
                "model_flops_global", "trace_s", "card")


def summary(results: list) -> list:
    """Each cell's result cut to ``SUMMARY_KEYS`` and its peak: what the
    table reads, small enough to keep beside the code."""
    out = []
    for r in results:
        row = {k: r[k] for k in SUMMARY_KEYS if k in r}
        if "memory" in r:
            row["memory"] = {"peak_estimate_bytes":
                             r["memory"]["peak_estimate_bytes"]}
        out.append(row)
    return sorted(out, key=lambda r: (r["arch"], r["shape"], r["mesh"]))


def _one(arch, shape, multi_pod, out, skip_existing) -> dict:
    """One cell (``shape`` None: the FCVI variant ``arch``), saved."""
    if shape is None:
        v = VARIANTS[arch]
        res = run_fcvi_cell(v["shape"], multi_pod,
                            fcvi_variant=v["fcvi_variant"], tag="_" + arch)
        save_result(res, out)
        return res
    path = os.path.join(out, f"{arch}_{shape}_{_mesh_name(multi_pod)}.json")
    if skip_existing and os.path.exists(path):
        with open(path) as fh:
            cached = json.load(fh)
        if cached.get("status") in ("ok", "skipped"):
            print(f"[{arch} {shape} {_mesh_name(multi_pod)}] cached, "
                  "skipping", flush=True)
            return cached
    try:
        res = run_cell(arch, shape, multi_pod)
    except Exception as e:   # a cell's failure is its JSON's
        traceback.print_exc()
        res = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod),
               "status": "error", "error": f"{type(e).__name__}: {e}"}
    save_result(res, out)
    return res


def _cost_rank(arch: str, shape, multi_pod: bool) -> tuple:
    """A cell's place in a parallel run: the longest traces first."""
    if shape is None or arch == "fcvi":
        return (3, 0)
    kind = SP.SHAPES[shape]["kind"]
    cfg = get_config(arch)
    size = (cfg.n_layers + cfg.n_enc_layers) * cfg.d_model
    return ({"train": 0, "prefill": 1}.get(kind, 2), -size)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SP.SHAPES) + list(SP.FCVI_SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default=None, choices=list(VARIANTS))
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    ap.add_argument("--summary", default=None,
                    help="also write every cell's summary to this file")
    args = ap.parse_args(argv)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []

    if args.variant:
        v = VARIANTS[args.variant]
        for mp in meshes:
            if v["arch"] == "fcvi":
                res = run_fcvi_cell(v["shape"], mp,
                                    fcvi_variant=v["fcvi_variant"],
                                    tag="_" + args.variant)
            else:
                res = run_cell(v["arch"], v["shape"], mp,
                               extra_rules=v.get("extra_rules"),
                               n_micro_override=v.get("n_micro"),
                               tag="_" + args.variant)
            save_result(res, args.out)
            results.append(res)
        return results

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = (list(SP.SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    cells = [(a, sh) for a in archs for sh in shapes if a != "fcvi"
             and sh in SP.SHAPES]
    if args.all or args.arch == "fcvi":
        fshapes = list(SP.FCVI_SHAPES) if args.shape is None else \
            [sh for sh in [args.shape] if sh in SP.FCVI_SHAPES]
        cells += [("fcvi", sh) for sh in fshapes]
    if args.arch == "fcvi":
        cells = [(a, sh) for (a, sh) in cells if a == "fcvi"]
    if args.all or args.arch == "fcvi":
        cells += [(name, None) for name, v in VARIANTS.items()
                  if v["arch"] == "fcvi"]

    todo = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    jobs = [(a, sh, m, args.out, args.skip_existing) for a, sh, m in todo]
    if args.jobs > 1:
        import multiprocessing as mp_
        # the longest traces first: training, then prefill, the deep first
        order = sorted(range(len(jobs)), key=lambda i: _cost_rank(*todo[i]))
        with mp_.get_context("spawn").Pool(args.jobs) as pool:
            done = pool.starmap(_one, [jobs[i] for i in order], chunksize=1)
        results = [None] * len(jobs)
        for i, r in zip(order, done):
            results[i] = r
    else:
        results = [_one(*j) for j in jobs]
    failures = [r for r in results if r.get("status") == "error"]
    if args.summary:
        with open(args.summary, "w") as fh:
            json.dump(summary(results), fh, indent=0)
            fh.write("\n")
    print(table(results))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f["arch"], f["shape"], f["mesh"], f["error"])
        raise SystemExit(1)
    print("\nall requested cells traced OK")
    return results


if __name__ == "__main__":
    main()
