#!/usr/bin/env python3
"""The flat scan's accuracy on near-cancelling scores, and its time, on one
card.

Rows and queries around shared centres (``||x||^2`` about MAG, a spread of
0.2 a column: scores about -8), so ``2 <q, x>`` and the norms cancel and
the dot product's error shows whole in the score. For each stored type
(fp32, bf16, int8) and MAG in 64, 250 and 1000 (n=100,000, d=128, b=64,
kk=88) it prints the largest error of the scan's scores and of the plain
fp32 version's against fp64 scores of the same rows, and the scan's
distance from the plain version as a share of the L2 tolerance (rtol 1e-5,
atol 1e-4). Then the scan's time at the serving shapes (n=1M, d=128, b=64,
kk 88 and 328, fp32 and bf16 rows; CUDA events, per call).

``--group G`` builds the scan from a copy of the sources under ``build/``
with MMA sums of G k-steps (the source's ``kGroup``, 4), to compare
accumulation lengths; run each G as its own process. Every line carries
the card's name and power limit.

    python3 scripts/scan_accuracy.py [--group 1|2|4]

Needs one CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.index import quant  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_score_topk as scan  # noqa: E402

GROUP = "constexpr int kGroup = 4;"


def use_group(group: int) -> None:
    """Point the build at a copy of the sources whose MMA sums run
    ``group`` k-steps."""
    if group == 4:
        return
    src = _build.CSRC / "fused_score_topk.cu"
    text = src.read_text()
    if GROUP not in text:
        raise RuntimeError(f"{src.name} has no '{GROUP}'")
    copy = _build.BUILD_ROOT.parent / f"csrc_kgroup{group}"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(_build.CSRC, copy)
    (copy / src.name).write_text(
        text.replace(GROUP, f"constexpr int kGroup = {group};"))
    _build.CSRC = copy


def stored(x, dtype):
    """(rows at ``dtype``, scales or None, fp32 squared norms)."""
    if dtype == "int8":
        rows, sc = quant.quantize_rows(x)
        return rows, sc, quant.sq_norms_of(rows, sc)
    rows = x if dtype == "float32" else x.to(torch.bfloat16)
    return rows, None, torch.sum(rows.float() ** 2, dim=-1)


def accuracy(dev, tag: str, power: str) -> None:
    n, b, d, kk = 100_000, 64, 128, 88
    rng = np.random.default_rng(0)
    for mag in (64, 250, 1000):
        centre = rng.standard_normal((b, d)) * np.sqrt(mag / d)
        x = centre[np.arange(n) % b] + 0.2 * rng.standard_normal((n, d))
        q = centre + 0.2 * rng.standard_normal((b, d))
        x = torch.tensor(x, dtype=torch.float32, device=dev)
        q = torch.tensor(q, dtype=torch.float32, device=dev)
        for dtype in ("float32", "bfloat16", "int8"):
            rows, sc, sq = stored(x, dtype)
            vals, ids = scan.score_topk(rows, sq, q, kk, sc)
            idx = ids.long()
            full = 2.0 * (q @ rows.float().T)
            if sc is not None:
                full = full * sc
            plain = torch.gather((full - sq[None, :]) - torch.sum(
                q * q, dim=-1, keepdim=True), 1, idx)
            deq = rows.double() if sc is None else \
                rows.double() * sc.double()[:, None]
            xd, qd = deq[idx], q.double()[:, None, :]
            exact = (2.0 * (xd * qd).sum(-1) - sq.double()[idx]
                     - (qd * qd).sum(-1))
            err, err_plain = ((t.double() - exact).abs().max().item()
                              for t in (vals, plain))
            share = ((vals - plain).abs()
                     / (1e-4 + 1e-5 * plain.abs())).max().item()
            print(f"accuracy {tag} {dtype} |x|^2~{mag} (scores about "
                  f"{vals.mean().item():.2f}): against fp64 the scan "
                  f"{err:.3g}, the plain version {err_plain:.3g}; the scan "
                  f"against the plain version {share:.3f} of the L2 "
                  f"tolerance; card {power}")
            del rows, sc, sq, full, plain, deq
        del x, q


def times(dev, tag: str, power: str, iters: int = 20) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1_000_000, 128), generator=g, device=dev)
    q = torch.randn((64, 128), generator=g, device=dev)
    for dtype in ("float32", "bfloat16"):
        rows, sc, sq = stored(x, dtype)
        for kk in (88, 328):
            def call():
                return scan.score_topk(rows, sq, q, kk, sc)
            call()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(iters):
                call()
            end.record()
            torch.cuda.synchronize()
            print(f"time {tag} {dtype} n=1000000 b=64 d=128 kk={kk}: "
                  f"{start.elapsed_time(end) / iters:.4f} ms; card {power}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--group", type=int, default=4, choices=(1, 2, 4))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_accuracy: no CUDA device", file=sys.stderr)
        return 1
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    use_group(args.group)
    _build.build()
    dev = torch.device("cuda")
    tag = f"kGroup={args.group}"
    accuracy(dev, tag, power)
    times(dev, tag, power)
    return 0


if __name__ == "__main__":
    sys.exit(main())
