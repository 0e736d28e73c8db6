#!/usr/bin/env python3
"""Where the time of a top-k scan goes, kernel by kernel, on one card.

Runs the fused PQ scan + top-k (``pq_score_topk``) and the flat L2 scan
(``score_topk``) on random operands at the serving shapes (n=1M rows, b=64
queries; PQ: M=8, ksub=256, 32 coarse groups; flat: d=128), on both of
their paths, forced: the buffered path (candidate buffers in shared memory,
then a merge) and the selection path (every score to scratch, then a radix
select per query). Prints each kernel's device time per call from
``torch.profiler`` (CUDA activity), so a call's time splits into its scan
and its selection or merge. The scan's time on the selection path is the
scan without any candidate buffer.

    python3 scripts/profile_topk.py [--kk 80 320 2048] [--iters 5]

Needs one CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.index import pq  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_score_topk as scan  # noqa: E402
from repro_torch.kernels import pq_lut  # noqa: E402


def kernel_times(fn, iters: int) -> list:
    """[(kernel name, ms per call)] of ``fn`` on the card."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0 and e.device_type.name == "CUDA":
            out.append((e.key.split("(")[0].split("::")[-1], t / iters / 1e3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kk", type=int, nargs="+", default=[80, 320, 2048])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_topk: no CUDA device", file=sys.stderr)
        return 1
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card {power}; torch {torch.__version__}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, m, ksub, ncoarse, b, d = 1_000_000, 8, 256, 32, 64, 128
    codes = torch.randint(0, ksub, (n, m), generator=g,
                          device=dev).to(torch.uint8)
    coarse = torch.randint(0, ncoarse, (n,), generator=g,
                           device=dev).to(torch.int32)
    layout = pq.grouped_layout(codes, coarse, ncoarse)
    luts = torch.rand((b, m, ncoarse * ksub), generator=g, device=dev) * 10
    x = torch.randn((n, d), generator=g, device=dev)
    sq = torch.sum(x * x, dim=-1)
    q = torch.randn((b, d), generator=g, device=dev)
    _build.build()
    runs = []
    for kk in args.kk:
        runs += [(f"pq_score_topk kk={kk} {path}",
                  lambda kk=kk, s=s: pq_lut.pq_score_topk(
                      *layout, luts, kk, _select=s))
                 for path, s in (("buffered", False), ("selection", True))]
        kf = kk + 8          # the flat scan's width: k' + the refine's pad
        runs += [(f"score_topk kk={kf} {path}",
                  lambda kf=kf, s=s: scan.score_topk(x, sq, q, kf,
                                                     _select=s))
                 for path, s in (("buffered", False), ("selection", True))]
    for tag, fn in runs:
        parts = kernel_times(fn, args.iters)
        total = sum(t for _, t in parts)
        print(f"{tag}: {total:.4f} ms = " + " + ".join(
            f"{name} {t:.4f}" for name, t in parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
