#!/usr/bin/env python3
"""Where the time of a top-k scan goes, kernel by kernel, on one card.

Runs the fused PQ scan + top-k (``pq_score_topk``) and the flat L2 scan
(``score_topk``, at fp32, bf16 and int8 rows) on random operands at the
serving shapes (n=1M rows, b=64 queries; PQ: M=8, ksub=256, 32 coarse
groups; flat: d=128), on both of their paths, forced where the shape
allows it: the buffered path (candidate buffers in shared memory, then a
merge) and the selection path (every score to scratch, then a radix select
per query). Prints each kernel's device time per call from
``torch.profiler`` (CUDA activity), so a call's time splits into its
kernels: for the buffered paths the sample pass, the threshold, the scan
and the merge (PQ: after the LUT relayout). The flat scan's own profile
(its ``_stats``: block thread 0's clock cycles by phase) splits the scan
into its cuts and the rest, and counts the cuts and admitted candidates a
chunk took; the PQ scan's (``pq_lut.STAT_NAMES``) counts the words
admitted a query and the cuts. The PQ operands here are random LUTs over
uniformly random codes and coarse ids: every group is alike and no query
is nearer one group, so its admissions spread evenly over the chunks;
``chip_smoke.py`` phase 3c prints the same counts on the clustered
SIFT1M-shaped index, where a query's admissions fall in its nearest
groups' chunks. Every line carries the card's name and power limit.

With ``--plans`` it instead times the flat planner's choice of a query
operand resident for every column chunk against the operand staged a chunk
at a time (``qstream``, forced) at d=128, on the same operands (CUDA
events, per call), and checks that both give the same (vals, ids) bits.

With ``--select`` it times the selection path's select: the flat scan at
kk=88 (forced) and kk=2056, the IVF dedup and batch scans at k=3200 (nlist
1024, 16 random probes a query, about 977 rows a list) and the fused PQ
scan at kk=2048, each call split into its kernels (``torch.profiler``) and
timed whole (CUDA events), with the select's stages from its own profile
(each launch's span on the card's global timer and what its blocks did:
a histogram pass, the compaction, the finish's select and sort); then the
select alone (``topk_select.select_topk``, the same kernels) on a (b, n)
score scratch of the same shape and live entries, beside
``torch.topk(scores, kk, dim=1, sorted=True)`` on that scratch (CUDA
events; the scratch is larger than L2, as the scan leaves it) and the
select's bytes bound: one read of each query's live entries at 3.35 TB/s.
``--full-row`` adds the select alone with its candidate buffer cut to kk
and on a scratch of equal scores, both of which force the histogram
passes over the full row.

    python3 scripts/profile_topk.py [--kk 80 320 2048] [--iters 5] [--plans]
    python3 scripts/profile_topk.py --pq --kk 320 512 1024 2048
    python3 scripts/profile_topk.py --select [--full-row] [--iters 5]

Needs one CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.index import pq  # noqa: E402
from repro_torch.index import quant  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import fused_score_topk as scan  # noqa: E402
from repro_torch.kernels import ivf_score  # noqa: E402
from repro_torch.kernels import pq_lut  # noqa: E402
from repro_torch.kernels import topk_select  # noqa: E402
from repro_torch.launch.cost_analysis import PEAK_BYTES_S  # noqa: E402


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
            names = re.findall(r"(\w+_kernel)\b", e.key)
            out.append((names[-1] if names else e.key[:40],
                        t / iters / 1e3))
    return out


def flat_profile(x, sq, q, kk, scales=None) -> str:
    """The flat buffered scan's split from its own profile: the share of
    block thread 0's cycles spent cutting buffers, and the cuts and
    admitted candidates a chunk (a block) took."""
    stats = torch.zeros(scan.STATS, dtype=torch.int64, device=x.device)
    scan.score_topk(x, sq, q, kk, scales, _select=False, _stats=stats)
    torch.cuda.synchronize()
    et = _build.ELEMENT_TYPES[x.dtype][0]
    p = scan.plan(x.shape[0], q.shape[0], kk, x.shape[1],
                  torch.cuda.get_device_properties(
                      x.device).multi_processor_count, False, et)
    blocks = p.nchunks * -(-q.shape[0] // p.bq)
    v = dict(zip(scan.STAT_NAMES, stats.tolist()))
    cycles = sum(v[k] for k in scan.STAT_NAMES[:6])
    return (f"scan phases (thread 0's cycles): " + ", ".join(
        f"{k} {v[k] / max(cycles, 1):.3f}" for k in scan.STAT_NAMES[:6])
        + f"; a chunk's cuts {v['cuts'] / blocks:.2f}, candidates admitted "
        f"a query a chunk {v['admitted'] / blocks / p.bq:.1f} ({blocks} "
        f"chunks x query tiles, bq {p.bq}, cap {p.cap}, {p.stages} ring "
        f"slots)")


def pq_profile(layout, luts, kk) -> str:
    """The fused PQ scan's buffered pass 1 from its own profile: words
    admitted a query (over the whole corpus and a chunk) and the cuts."""
    stats = torch.zeros(pq_lut.STATS, dtype=torch.int64, device=luts.device)
    pq_lut.pq_score_topk(*layout, luts, kk, _select=False, _stats=stats)
    torch.cuda.synchronize()
    v = dict(zip(pq_lut.STAT_NAMES, stats.tolist()))
    b = luts.shape[0]
    p = pq_lut.topk_plan(layout[0].shape[0], b, kk, luts.shape[1],
                         luts.shape[2] // (len(layout[3]) - 1),
                         torch.cuda.get_device_properties(
                             luts.device).multi_processor_count, False)
    return (f"random LUTs: words admitted a query {v['admitted'] / b:.1f} "
            f"(a query a chunk {v['admitted'] / v['query_chunks']:.2f}), "
            f"cuts {v['cuts']} ({v['cuts'] / b:.2f} a query, "
            f"{v['cut_words'] / max(v['cuts'], 1):.1f} words a cut); plan bq "
            f"{p.bq}, {p.blocks_per_sm} blocks an SM, {p.nchunks} chunks, "
            f"cap {p.cap}, tile {p.tile}, sample {p.sample}")


def time_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the card (CUDA events, one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_plans(dev, g, iters: int, power: str) -> None:
    """The planner's resident query operand against the streamed one, each
    pair timed in turn (choice, forced, forced, choice) and checked bit for
    bit."""
    plan0 = scan.plan
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def streamed(n, nq, kk, d, num_sms, select=None, et=0):
        p = plan0(n, nq, kk, d, num_sms, select, et)
        cap, stages = scan.buffered_cap(p.bq, kk, d, et, True)
        return dataclasses.replace(p, qstream=True, cap=cap, stages=stages)

    def force():
        scan.plan = streamed

    n, b, d = 1_000_000, 64, 128
    for tag, kk in (("fp32", 88), ("fp32", 328), ("bf16", 88),
                    ("bf16", 328), ("int8", 328)):
        x = torch.randn((n, d), generator=g, device=dev)
        q = torch.randn((b, d), generator=g, device=dev)
        sc = None
        if tag == "bf16":
            x = x.to(torch.bfloat16)
        elif tag == "int8":
            x, sc = quant.quantize_rows(x)
        sq = (quant.sq_norms_of(x, sc) if sc is not None
              else torch.sum(x.float() ** 2, dim=-1))
        et = _build.ELEMENT_TYPES[x.dtype][0]

        def call():
            return scan.score_topk(x, sq, q, kk, sc, _select=False)
        chosen = scan.plan(n, b, kk, d, sms, False, et)
        want = call()
        force()
        try:
            other = scan.plan(n, b, kk, d, sms, False, et)
            got = call()
            t_other = [time_ms(call, iters)]
        finally:
            scan.plan = plan0
        t_chosen = [time_ms(call, iters)]
        force()
        try:
            t_other.append(time_ms(call, iters))
        finally:
            scan.plan = plan0
        t_chosen.append(time_ms(call, iters))
        same = all(torch.equal(a, c) for a, c in zip(want, got))
        print(f"plans qstream {tag} n={n} b={b} d={d} kk={kk}: planned "
              f"(bq {chosen.bq}, cap {chosen.cap}, stages {chosen.stages}, "
              f"qstream {chosen.qstream}, {chosen.nchunks} chunks) "
              f"{min(t_chosen):.4f} ms {t_chosen}; forced (bq {other.bq}, "
              f"cap {other.cap}, stages {other.stages}, qstream "
              f"{other.qstream}, {other.nchunks} chunks) {min(t_other):.4f} "
              f"ms {t_other}; bit-equal {same}; card {power}")
        if not same:
            raise AssertionError(f"plans {tag} kk={kk}: results differ")
        del x, q, sq, want, got


def stages(stats) -> str:
    """The select's launches from its profile: each pass launch's span and
    what its blocks did (h histogram, c compaction), then the finish."""
    st = stats.tolist()
    out = []
    for p in range(_build.SELECT_PASSES + 1):
        if not st[3 * p + 2]:
            continue
        what = ("finish" if p == _build.SELECT_PASSES else
                "".join(m for bit, m in ((1, "h"), (2, "c"))
                        if st[3 * p + 2] & bit))
        out.append(f"{what} {(st[3 * p + 1] - st[3 * p]) / 1e6:.4f}")
    return ", ".join(out)


def split(tag: str, fn, iters: int, power: str) -> float:
    """Print ``fn``'s kernels (profiler), its time per call (events) and
    its select's stages (``fn(stats)`` fills them)."""
    parts = kernel_times(lambda: fn(None), iters)
    ms = time_ms(lambda: fn(None), iters)
    stats = _build.select_stats(torch.device("cuda"))
    fn(stats)
    torch.cuda.synchronize()
    print(f"select {tag}: call {ms:.4f} ms (events); kernels "
          + " + ".join(f"{name} {t:.4f}" for name, t in parts)
          + f"; select stages ms (global timer) {stages(stats)}; card "
          f"{power}")
    return ms


def library_topk(tag: str, scores, kk: int, live: int, iters: int,
                 power: str, cap=None) -> None:
    """The select alone and torch.topk on a (b, n) score scratch, beside
    the select's bound; the select checked against its plain version."""
    got = topk_select.select_topk(scores, kk, _cap=cap)
    want = ref.ref_select_topk(scores, kk)
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        raise AssertionError(f"select {tag}: differs from its plain version")
    ms = time_ms(lambda: topk_select.select_topk(scores, kk, _cap=cap), iters)
    stats = _build.select_stats(scores.device)
    topk_select.select_topk(scores, kk, _cap=cap, _stats=stats)
    lib = time_ms(lambda: torch.topk(scores, kk, dim=1, sorted=True), iters)
    bound = 1e3 * (4 * live + 12 * scores.shape[0] * kk) / PEAK_BYTES_S
    buf = "" if cap is None else f" (buffer {cap})"
    print(f"select {tag}: the select alone on the ({scores.shape[0]}, "
          f"{scores.shape[1]}) scratch{buf} {ms:.4f} ms (stages: "
          f"{stages(stats)}), bit-equal to its plain "
          f"version; torch.topk {lib:.4f} ms; select bound {bound:.4f} ms "
          f"(bytes: {live} live entries read once, (vals, ids) written); "
          f"card {power}")


def select_profile(dev, g, iters: int, power: str, full_row: bool) -> None:
    """The selection path's select at the serving shapes (see above)."""
    n, b, d = 1_000_000, 64, 128
    x = torch.randn((n, d), generator=g, device=dev)
    sq = torch.sum(x * x, dim=-1)
    q = torch.randn((b, d), generator=g, device=dev)
    scores = (2.0 * (q @ x.T) - sq[None, :]) - torch.sum(q * q, -1,
                                                        keepdim=True)
    for kk in (88, 2056):
        split(f"flat kk={kk}", lambda st, kk=kk: scan.score_topk(
            x, sq, q, kk, _select=True, _sel_stats=st), iters, power)
        library_topk(f"flat kk={kk}", scores, kk, b * n, iters, power)
        if full_row:
            library_topk(f"flat kk={kk}", scores, kk, b * n, iters, power,
                         cap=kk)
    if full_row:
        ties = torch.full((b, n), -1.25, device=dev)
        library_topk("every score equal kk=88", ties, 88, b * n, iters,
                     power)
        del ties
    del scores
    # IVF: 1024 lists of about 977 rows (max_list 984), 16 random probes a
    # query; the library's scratch is the plain dedup scores (b, s * L),
    # -inf off each query's member lists
    nlist, nprobe, k = 1024, 16, 3200
    sizes = torch.full((nlist,), n // nlist, device=dev)
    sizes[: n % nlist] += 1
    L = -(-int(sizes.max()) // 8) * 8
    grouped = x.new_zeros((nlist, L, d))
    valid = (torch.arange(L, device=dev)[None, :] < sizes[:, None]).float()
    grouped[valid > 0.5] = x
    gsq = torch.sum(grouped * grouped, dim=-1)
    probes = torch.argsort(torch.rand((b, nlist), generator=g, device=dev),
                           dim=1)[:, :nprobe].to(torch.int32).contiguous()
    uniq, member = ref.dedup_probes(probes, nlist)
    ded = (grouped, gsq, valid, uniq, member, q)
    split(f"ivf dedup k={k} ({uniq.numel()} slots)",
          lambda st: ivf_score.ivf_score_topk_dedup(
              *ded, k, _select=True, _sel_stats=st), iters, power)
    split(f"ivf batch k={k}", lambda st: ivf_score.ivf_score_topk_batch(
        grouped, gsq, valid, probes, q, k, _select=True, _sel_stats=st),
        iters, power)
    s, _ = ref._dedup_scores(*ded)
    live = int(torch.isfinite(s).sum())
    library_topk(f"ivf dedup k={k}", s, k, live, iters, power)
    del s, grouped, gsq, valid, x
    m, ksub, ncoarse, kk = 8, 256, 32, 2048
    codes = torch.randint(0, ksub, (n, m), generator=g,
                          device=dev).to(torch.uint8)
    coarse = torch.randint(0, ncoarse, (n,), generator=g,
                           device=dev).to(torch.int32)
    layout = pq.grouped_layout(codes, coarse, ncoarse)
    luts = torch.rand((b, m, ncoarse * ksub), generator=g, device=dev) * 10
    split(f"pq kk={kk}", lambda st: pq_lut.pq_score_topk(
        *layout, luts, kk, _select=True, _sel_stats=st), iters, power)
    ccodes = (coarse[:, None] * ksub + codes.to(torch.int32)).contiguous()
    neg = -ref.ref_pq_score_batch(ccodes, luts)
    library_topk(f"pq kk={kk}", neg, kk, b * n, iters, power)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kk", type=int, nargs="+", default=[80, 320, 2048])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--plans", action="store_true",
                    help="time the flat planner's choices (see above)")
    ap.add_argument("--select", action="store_true",
                    help="time the selection path's select (see above)")
    ap.add_argument("--full-row", action="store_true",
                    help="with --select: force the full-row passes")
    ap.add_argument("--pq", action="store_true",
                    help="only the fused PQ scan (both paths at each kk)")
    ap.add_argument("--b", type=int, nargs="+", default=[64],
                    help="with --pq: the batch sizes (queries a call)")
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
    if args.plans:
        _build.build()
        compare_plans(dev, g, max(args.iters, 20), power)
        return 0
    if args.select:
        _build.build()
        select_profile(dev, g, args.iters, power, args.full_row)
        return 0
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
    xb = x.to(torch.bfloat16)
    xi, si = quant.quantize_rows(x)
    rows = {"fp32": (x, sq, None),
            "bf16": (xb, torch.sum(xb.float() ** 2, dim=-1), None),
            "int8": (xi, quant.sq_norms_of(xi, si), si)}
    _build.build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    runs = []
    for kk in args.kk:
        for bs in args.b if args.pq else [b]:
            lb = luts[:bs].contiguous()
            plan = pq_lut.topk_plan(n, bs, kk, m, ksub, sms)
            runs += [(f"pq_score_topk b={bs} kk={kk} {path}"
                      f"{' (planned)' if s == plan.select else ''}",
                      lambda kk=kk, s=s, lb=lb: pq_lut.pq_score_topk(
                          *layout, lb, kk, _select=s),
                      ("pq", kk, lb) if not s else None)
                     for path, s in (("buffered", False), ("selection", True))
                     if s or pq_lut.word_plan(kk) is not None]
        kf = kk + 8          # the flat scan's width: k' + the refine's pad
        for tag, (xr, sqr, sc) in ({} if args.pq else rows).items():
            et = _build.ELEMENT_TYPES[xr.dtype][0]
            paths = [("selection", True)]
            if not scan.plan(n, b, kf, d, sms, et=et).select:
                paths.insert(0, ("buffered", False))
            runs += [(f"score_topk {tag} kk={kf} {path}",
                      lambda kf=kf, s=s, xr=xr, sqr=sqr, sc=sc:
                      scan.score_topk(xr, sqr, q, kf, sc, _select=s),
                      (xr, sqr, kf, sc) if not s else None)
                     for path, s in paths]
    for tag, fn, prof in runs:
        parts = kernel_times(fn, args.iters)
        total = sum(t for _, t in parts)
        ms = time_ms(fn, args.iters)
        print(f"{tag}: {total:.4f} ms = " + " + ".join(
            f"{name} {t:.4f}" for name, t in parts) + f" (call {ms:.4f} ms, "
            f"CUDA events); card {power}")
        if prof is not None and prof[0] == "pq":
            print(f"    {pq_profile(layout, prof[2], prof[1])}; card {power}")
        elif prof is not None:
            xr, sqr, kf, sc = prof
            print(f"    {flat_profile(xr, sqr, q, kf, sc)}; card {power}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
