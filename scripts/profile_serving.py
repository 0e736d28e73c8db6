#!/usr/bin/env python3
"""Where one serving batch's time goes on the card: a ``torch.profiler``
trace of timed batches of the flat and IVF engines at ``chip_smoke.py``'s
full width (SIFT1M-shaped corpus, n=1,000,000, d=128, m=8, batches of 64;
IVF with nlist=1024, nprobe=16; every other setting at its default).

Run from the root of the repository on a machine with one CUDA device:

    python3 scripts/profile_serving.py [--batches 8]

For each engine it prints the host wall time per batch, the device's busy
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
from repro_torch.serve import engine as engine_mod  # noqa: E402


def profile(tag: str, eng, inp, batches: int) -> dict:
    """Warm up, then trace ``batches`` batches of 64 (distinct queries, so
    no cache hits; escalation as the engine decides)."""
    B = smoke.B
    eng.search(inp.q_warm, inp.f_warm)
    eng.search(inp.q_all[:B], inp.f_all[:B])
    eng._cache.clear()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    esc0 = eng.stats.escalations
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for s in range(batches):
            lo = (s % 8) * B
            eng.search(inp.q_all[lo:lo + B], inp.f_all[lo:lo + B])
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    power = smoke.card()
    inp = smoke.make_inputs()
    res = {"card": power}
    for tag, cfg in (("flat", fcvi.FCVIConfig()),
                     ("ivf", fcvi.FCVIConfig(backend="ivf", nlist=smoke.NLIST,
                                             nprobe=smoke.NPROBE))):
        index = fcvi.build(inp.corpus.vectors, inp.corpus.filters, cfg,
                           device=dev)
        eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(),
                                    device=dev)
        res[tag] = profile(tag, eng, inp, args.batches)
        del eng, index
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
