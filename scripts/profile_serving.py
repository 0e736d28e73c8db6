#!/usr/bin/env python3
"""Where one serving batch's time goes on the card: a ``torch.profiler``
trace of timed batches of the flat, IVF and PQ engines at
``chip_smoke.py``'s full width (SIFT1M-shaped corpus, n=1,000,000, d=128,
m=8, batches of 64; IVF with nlist=1024, nprobe=16; PQ with every
``FCVIConfig`` default but the backend; every other setting at its
default).

Run from the root of the repository on a machine with one CUDA device:

    python3 scripts/profile_serving.py [--batches 8] [--backend pq ...]
        [--storage int8] [--predicate P2 ...] [--shards 8 [--placement
        cluster] [--routed]]

``--shards N`` also profiles each engine sharded over N logical shards on
the card (``make_mesh((N, 1), ("data", "model"))``, placement
``--placement``, default contiguous; ``--routed`` for routed serving, flat
cluster or IVF), beside the meshless engine on the same index.
``--backend`` (repeatable; all three when absent) picks the engines, and
``--storage`` the flat and IVF corpus storage (``FCVIConfig.storage_dtype``:
float32, the default, bfloat16 or int8; PQ ignores it). ``--predicate``
(repeatable: P1, P2, P3, the predicates of ``chip_smoke.py`` phase 3f)
profiles predicate search (``search(q, filter=...)`` over the corpus's raw
attribute table, the plan the planner picks) instead of similarity search,
on the flat and IVF engines. For
each engine it prints the host wall time per batch, the device's busy
time per batch (the sum of the kernels' device time in the trace), the
idle share 1 - busy / wall, and the kernels that take the most device time.
The last line is a JSON object with those numbers and the card's name and
power limit. Without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import fcvi  # noqa: E402
from repro_torch.core.filters import compile_predicate  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402


CONFIGS = {
    "flat": dict(),
    "ivf": dict(backend="ivf", nlist=smoke.NLIST, nprobe=smoke.NPROBE),
    "pq": dict(backend="pq"),
}


def profile(tag: str, eng, inp, batches: int, pred=None) -> dict:
    """Warm up, then trace ``batches`` batches of 64 (distinct queries, so
    no cache hits; escalation as the engine decides). With ``pred``, the
    batches are predicate searches."""
    B = smoke.B

    def search(q, f):
        if pred is None:
            return eng.search(q, f)
        return eng.search(q, filter=pred)

    search(inp.q_warm, inp.f_warm)
    search(inp.q_all[:B], inp.f_all[:B])
    eng._cache.clear()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    esc0 = eng.stats.escalations
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(batches):
            lo = (s % 8) * B
            search(inp.q_all[lo:lo + B], inp.f_all[lo:lo + B])
            eng._cache.clear()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # kernels only: an operator's own device time repeats its kernels'
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    # host side: each operator's own CPU time (its children's excluded)
    host = [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CPU]
    host_us = sum(e.self_cpu_time_total for e in host)
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]
    out = dict(
        wall_ms_per_batch=1e3 * wall / batches,
        device_busy_ms_per_batch=busy_us / 1e3 / batches,
        idle_share=1.0 - (busy_us / 1e6) / wall,
        host_op_ms_per_batch=host_us / 1e3 / batches,
        escalations=eng.stats.escalations - esc0,
        kernels=[dict(name=e.key[:80], calls=e.count,
                      device_ms_per_batch=e.self_device_time_total / 1e3
                      / batches) for e in top],
        host_ops=[dict(name=e.key[:80], calls=e.count,
                       host_ms_per_batch=e.self_cpu_time_total / 1e3
                       / batches) for e in top_host])
    print(f"[{tag}] {batches} batches of {B}: wall {out['wall_ms_per_batch']:.3f}"
          f" ms/batch, device busy {out['device_busy_ms_per_batch']:.3f} "
          f"ms/batch, idle share {out['idle_share']:.3f}, host time in torch "
          f"operators {out['host_op_ms_per_batch']:.3f} ms/batch, escalated "
          f"queries {out['escalations']}")
    for k in out["kernels"]:
        print(f"[{tag}]   {k['device_ms_per_batch']:.4f} ms/batch "
              f"{k['calls']:5d} calls  {k['name']}")
    for k in out["host_ops"]:
        print(f"[{tag} host]   {k['host_ms_per_batch']:.4f} ms/batch "
              f"{k['calls']:5d} calls  {k['name']}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--backend", action="append",
                    choices=sorted(CONFIGS), help="engines to profile")
    ap.add_argument("--storage", default="float32",
                    choices=sorted(fcvi.STORAGE_DTYPES),
                    help="flat and IVF corpus storage dtype")
    ap.add_argument("--predicate", action="append",
                    choices=sorted(smoke.PREDICATES),
                    help="profile predicate search with these predicates")
    ap.add_argument("--shards", type=int, default=0,
                    help="also profile each engine over this many shards")
    ap.add_argument("--placement", default="contiguous",
                    help="the sharded engines' placement")
    ap.add_argument("--routed", action="store_true",
                    help="the sharded engines route (flat cluster, IVF)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    power = smoke.card()
    inp = smoke.make_inputs()
    res = {"card": power, "storage": args.storage}
    for tag in args.backend or CONFIGS:
        cfg = fcvi.FCVIConfig(storage_dtype=args.storage, **CONFIGS[tag])
        index = fcvi.build(inp.corpus.vectors, inp.corpus.filters, cfg,
                           device=dev)
        engines = {tag: engine_mod.FCVIEngine(
            index, engine_mod.EngineConfig(), device=dev,
            attributes=inp.corpus.filters)}
        if args.shards:
            placement = ("contiguous" if tag == "pq"
                         else "balanced" if tag == "ivf"
                         and args.placement == "contiguous"
                         else args.placement)
            routing = "routed" if args.routed and tag != "pq" else "dense"
            engines[f"{tag} {args.shards} shards {placement} {routing}"] = \
                engine_mod.FCVIEngine(
                    index, engine_mod.EngineConfig(), device=dev,
                    mesh=make_mesh((args.shards, 1), ("data", "model"),
                                   device=dev),
                    placement=placement, routing=routing,
                    attributes=inp.corpus.filters)
        for name_e, eng in engines.items():
            if not args.predicate:
                res[name_e] = profile(name_e, eng, inp, args.batches)
            for name in args.predicate or ():
                if tag == "pq":
                    continue   # PQ serves no predicate search
                pred = smoke.PREDICATES[name]
                cp = compile_predicate(pred, eng._attr_names)
                plan = eng.planner.choose(cp)
                res[f"{name_e} {name}"] = dict(
                    plan=plan, **profile(f"{name_e} {name} {plan}", eng,
                                         inp, args.batches, pred))
        del engines, eng, index
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
