#!/usr/bin/env python3
"""The flat scan's accuracy on near-cancelling scores, and its time, on one
card.

Rows and queries around shared centres (``||x||^2`` about MAG, a spread of
0.2 a column: scores about -8), so ``2 <q, x>`` and the norms cancel and
the dot product's error shows whole in the score. For each stored type
(fp32, bf16, int8) and MAG in 64, 250 and 1000 (n=100,000, d=128, b=64,
kk=88) it prints the largest error of the scan's scores and of the same
expression through an fp32 matrix product against fp64 scores of the
same rows, and the scan's distance from that product as a share of the
L2 tolerance (rtol 1e-5, atol 1e-4). Then the scan's time at the serving shapes (n=1M, d=128, b=64,
kk 88 and 328, fp32 and bf16 rows; CUDA events, per call).

``--corpus`` measures instead on ``chip_smoke.py``'s SIFT1M-shaped corpus
(n=1M, d=128, the first batch of 64 transformed queries), where the
serving path's checks run: the flat scan at fp32, bf16 and int8 (kk 88,
328, 2056) and the IVF scans B5 and B7 at the same three types (nlist
1024, nprobe 16, k 80, 320, 3200). For each it prints, over the live
slots, the scan's distance from the plain version as a share of each
slot's L2 tolerance (the check ``chip_smoke.py`` makes), and the scan's
and the plain version's distances from the fp64 scores of the same stored
rows (each as a share of that slot's tolerance about the fp64 score), and
the same for a dot product rounded once to fp32 from fp64 (``dot64``,
the flat plain version's); the rounding unit of the score's largest
term (2^-24 of max(2|<q, x>|, ||x||^2, ||q||^2)) beside it.

``--group G`` builds the scan from a copy of the sources under ``build/``
with MMA sums of G k-steps (the source's ``kGroup``, 1), to compare
accumulation lengths; run each G as its own process. Every line carries
the card's name and power limit.

    python3 scripts/scan_accuracy.py [--group 1|2|4] [--corpus]

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

GROUP = "constexpr int kGroup = 1;"


def use_group(group: int) -> None:
    """Point the build at a copy of the sources whose MMA sums run
    ``group`` k-steps."""
    if group == 1:
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
                  f"{err:.3g}, the fp32 matrix product {err_plain:.3g}; the "
                  f"scan against that product {share:.3f} of the L2 "
                  f"tolerance; card {power}")
            del rows, sc, sq, full, plain, deq
        del x, q


def at_ids(rows, sq, sc, q, ids, with_q2: bool):
    """(the fp64 scores of the stored rows at ``ids`` (b, k), the dot64
    version's fp32 scores there, the rounding unit of each score's largest
    term): ``(2 <q, x>) scale - ||x||^2`` (``- ||q||^2`` with ``with_q2``)
    with the stored norms."""
    idx = ids.long().clamp(min=0)
    xr = rows[idx].double()                          # codes for int8
    qd = q.double()[:, None, :]
    dot = (xr * qd).sum(-1)
    s64 = 2.0 * dot
    s32 = 2.0 * dot.float()
    if sc is not None:
        s64 = s64 * sc.double()[idx]
        s32 = s32 * sc[idx]
    s64 = s64 - sq.double()[idx]
    s32 = s32 - sq[idx]
    big = torch.maximum(s64.abs() + sq.double()[idx], sq.double()[idx])
    if with_q2:
        q2 = (qd * qd).sum(-1)
        s64 = s64 - q2
        s32 = s32 - torch.sum(q * q, dim=-1, keepdim=True)
        big = torch.maximum(big, q2.expand_as(big))
    return s64, s32, big * 2.0 ** -24


def shares(kind, dtype, k, got, want, rows, sq, sc, q, with_q2, tag, power):
    """One line of per-slot shares for a scan's (vals, ids) ``got`` against
    its plain version's ``want``, over the live slots."""
    gv, gi = got
    wv, wi = want
    live = torch.isfinite(wv) & torch.isfinite(gv)
    tol = 1e-4 + 1e-5 * wv.abs()
    vs_plain = ((gv - wv).abs() / tol)[live]
    ex_g, d64_g, unit = at_ids(rows, sq, sc, q, gi, with_q2)
    ex_w, _, _ = at_ids(rows, sq, sc, q, wi, with_q2)
    tol_ex = 1e-4 + 1e-5 * ex_g.abs()
    e_scan = (gv.double() - ex_g).abs()[live]
    e_plain = (wv.double() - ex_w).abs()[live]
    e_d64 = (d64_g.double() - ex_g).abs()[live]
    vs_d64 = ((gv - d64_g).abs() / (1e-4 + 1e-5 * d64_g.abs()))[live]
    worst = int(vs_plain.argmax())
    ws = wv[live][worst].item()
    print(f"corpus {tag} {kind} {dtype} k={k}: worst slot: score {ws:.4f}, "
          f"tolerance {tol[live][worst].item():.3g}, the scan from fp64 "
          f"{e_scan[worst].item():.3g}, the plain version "
          f"{(wv.double() - ex_g).abs()[live][worst].item():.3g}")
    print(f"corpus {tag} {kind} {dtype} k={k}: {int(live.sum())} live slots; "
          f"the scan against the plain version: max "
          f"{vs_plain.max().item():.3f} of its slot's tolerance, "
          f"{int((vs_plain > 1).sum())} slots past it; against fp64 (share "
          f"of the slot's tolerance about the fp64 score): the scan "
          f"{e_scan.max().item():.3g} "
          f"({(e_scan / tol_ex[live]).max().item():.3f}), the plain version "
          f"{e_plain.max().item():.3g} "
          f"({(e_plain / (1e-4 + 1e-5 * ex_w.abs()[live])).max().item():.3f}),"
          f" dot64 {e_d64.max().item():.3g} "
          f"({(e_d64 / tol_ex[live]).max().item():.3f}); the scan against "
          f"dot64: max {vs_d64.max().item():.3f} of its slot's tolerance, "
          f"{int((vs_d64 > 1).sum())} slots past it; rounding unit of the "
          f"largest term up to {unit[live].max().item():.3g}, slot "
          f"tolerance down to {tol[live].min().item():.3g}; card {power}")


def corpus(dev, tag: str, power: str, n: int, nlist: int) -> None:
    """Per-slot shares on chip_smoke.py's corpus (see the module note),
    at n rows."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke as smoke
    from repro_torch.core import fcvi
    from repro_torch.kernels import ops, ref

    smoke.N, smoke.NLIST = n, nlist
    inp = smoke.make_inputs()
    b = smoke.B
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:b],
                                                    inp.f_all[:b]))
    for dtype in ("float32", "bfloat16", "int8"):
        ix = fcvi.build(inp.corpus.vectors, inp.corpus.filters,
                        fcvi.FCVIConfig(storage_dtype=dtype), device=dev)
        be = ix.backend
        x, sq, sc = be.vectors, be.sq_norms, be.scales
        q = ix.transform.apply(qv, qf).contiguous()
        for kk in (88, 328, 2056):
            got = ops.score_topk(x, sq, q, kk, scales=sc)
            want = ref.ref_score_topk(x, sq, q, kk, sc)
            shares("flat", dtype, kk, got, want, x, sq, sc, q, True, tag,
                   power)
        del ix, be, x, sq, sc
        torch.cuda.empty_cache()
        ix = fcvi.build(inp.corpus.vectors, inp.corpus.filters,
                        fcvi.FCVIConfig(backend="ivf", nlist=smoke.NLIST,
                                        nprobe=smoke.NPROBE,
                                        storage_dtype=dtype), device=dev)
        be = ix.backend
        q = ix.transform.apply(qv, qf).contiguous()
        c2 = torch.sum(be.centroids * be.centroids, dim=-1)
        _, probes = ops.score_topk(be.centroids, c2, q, smoke.NPROBE)
        uniq, member = ops.dedup_probes(probes, smoke.NLIST)
        d = be.grouped.shape[-1]
        rows = be.grouped.reshape(-1, d)
        gsq = be.grouped_sq.reshape(-1)
        gsc = (None if be.grouped_scales is None
               else be.grouped_scales.reshape(-1))
        grp = (be.grouped, be.grouped_sq, be.valid)
        for k in (80, 320, 3200):
            got = ops.ivf_score_topk_dedup(*grp, uniq, member, q, k,
                                           scales=be.grouped_scales)
            want = ref.ref_ivf_score_topk_dedup(*grp, uniq, member, q, k,
                                                be.grouped_scales)
            shares("ivf-B5", dtype, k, got, want, rows, gsq, gsc, q, False,
                   tag, power)
            got = ops.ivf_score_topk_batch(*grp, probes, q, k,
                                           scales=be.grouped_scales)
            want = ref.ref_ivf_score_topk_batch(*grp, probes, q, k,
                                                be.grouped_scales)
            shares("ivf-B7", dtype, k, got, want, rows, gsq, gsc, q, False,
                   tag, power)
        del ix, be, rows
        torch.cuda.empty_cache()


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
    ap.add_argument("--group", type=int, default=1, choices=(1, 2, 4))
    ap.add_argument("--corpus", action="store_true",
                    help="per-slot shares on chip_smoke.py's corpus")
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="the corpus's rows (--corpus)")
    ap.add_argument("--nlist", type=int, default=1024,
                    help="the IVF lists (--corpus)")
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
    if args.corpus:
        corpus(dev, tag, power, args.n, args.nlist)
        times(dev, tag, power)
        return 0
    accuracy(dev, tag, power)
    times(dev, tag, power)
    return 0


if __name__ == "__main__":
    sys.exit(main())
