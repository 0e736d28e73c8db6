#!/usr/bin/env python3
"""The PQ ADC scans B9 (``pq_score_batch``) and B10 (``pq_score``) and the
combined-cosine re-rank B4 on the card, each as a host loop and as device
time, at ``chip_smoke.py``'s full width.

Run from the root of the repository on a machine with one CUDA device:

    python3 scripts/profile_rerank_adc.py [--iters 20]

B9 and B10 run on phase 3c's PQ index (SIFT1M-shaped corpus, n=1,000,000,
d=128, every ``FCVIConfig`` default but the backend: M=8, ncoarse=32,
ksub=256, int32 combined codes) with the first batch's LUTs: B9 at b=64
and at an escalation sub-batch's b=16, B10 at b=1. Each is held bit for
bit against its plain version and timed beside ``embedding_bag`` (the one
PyTorch call that computes the same sums) and its bytes bound; the device
time is ``torch.profiler``'s kernel sum a call, split by kernel (so the
LUT relayout's share shows where there is one).

B4 runs on random (64, kp, 128) / (64, kp, 8) candidate tiles at kp = 80,
328 and 2056 (the default k', the flat path's escalated k' and
``EngineConfig(k=64)``'s): ``ops.rescore`` alone, the re-rank sequence it
sits in (``ops.rescore`` -> ``topk_first`` -> ``torch.gather`` of the
ids, k=10, 64 at kp=2056) and, where the package has it,
``ops.rescore_topk``, the same function as one launch. Each is timed as a
host loop (CUDA events around back-to-back calls, so a call's host cost
shows) and as device time, with its kernel launches a call.

``--luts`` times the PQ scan LUTs on the same index instead, at b=64, 16
and 1: ``index.pq.scan_luts`` (one ``pq_scan_luts`` launch) and the chain
of plain torch ops around B8 that it replaced (``chip_smoke.chain_luts``:
B8, the residual, its squared sum per subspace, the broadcast terms),
each as a host loop and as device time with its launches and each
kernel's share, beside the bound of one write of the table; then the
kernel at every tiling of up to 8 queries and 1 to 32 coarse ids a block
(``pq_lut.luts_plan``'s choice marked), each bit-equal to the planned
one, by device time (the host's cost of a call hides the tiling in a host
loop).

It also prints whether ``topk_first`` on the card orders -0.0, +0.0 and
NaN as on the CPU (a stable descending sort: NaN first, the two zeros
equal). The last line is a JSON object with every number and the card's
name and power limit. Without a CUDA device it exits 1 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import fcvi  # noqa: E402
from repro_torch.index import pq as pq_mod  # noqa: E402
from repro_torch.kernels import _build, ops, pq_lut, ref  # noqa: E402

B, D, M = smoke.B, smoke.D, smoke.M


def ptxas_lines() -> list:
    """-Xptxas -v's registers, shared memory and spills of pq_lut.cu's
    and rescore.cu's kernels, one line each."""
    log = _build.build_log()
    out = []
    for src in ("pq_lut.cu", "rescore.cu"):
        part = log.split(f"== {src}", 1)[-1].split("\n== ", 1)[0]
        name = None
        for line in part.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                name = m.group(1)
            elif name and ("spill" in line or "registers" in line):
                short = re.sub(r"^_ZN\w*?_cu_\w{8}\d+", "", name)[:48]
                out.append(f"{src} {short}: {line.strip()}")
    return out


def timed(tag, fn, iters, power, extra="") -> dict:
    host = smoke.time_ms(fn, iters)
    dev, split, launches = smoke.device_time(fn)
    parts = "; ".join(f"{n} {t:.4f}" for n, t in
                      sorted(split.items(), key=lambda x: -x[1]))
    print(f"[{tag}] host loop {host:.4f} ms a call, device {dev:.4f} ms "
          f"({launches:g} launches a call: {parts}){extra}; card {power}")
    return dict(host_ms=host, device_ms=dev, launches=launches, split=split)


def pq_index():
    """(phase 3c's PQ index, the first batch's transformed queries)."""
    dev = torch.device("cuda", 0)
    inp = smoke.make_inputs()
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters,
                       fcvi.FCVIConfig(backend="pq"), device=dev)
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    return index, index.transform.apply(qv, qf).contiguous()


def luts(iters, power) -> dict:
    index, q_t = pq_index()
    be = index.backend
    m, ksub, dsub = be.codebooks.shape
    c = be.ncoarse
    out = {}
    for b in (B, smoke.B_ESC, 1):
        qb = q_t[:b].contiguous()
        table = 4 * b * m * c * ksub
        inputs = 4 * (b * m * dsub + m * ksub * dsub + c * m * dsub
                      + c * m * ksub + m * ksub)
        bnd, by = smoke.bound_ms(table + inputs,
                                 b * m * ksub * (2 * dsub + 4 * c)
                                 + b * c * m * 3 * dsub)
        runs = {"scan_luts": lambda: pq_mod.scan_luts(be, qb),
                "chain_luts (replaced)": lambda: smoke.chain_luts(be, qb)}
        for name, fn in runs.items():
            r = timed(f"{name} b={b}", fn, iters, power,
                      f"; table ({b},{m},{c * ksub}) {table / 1e6:.2f} MB; "
                      f"bound {bnd:.5f} ({by})")
            out[f"{name} b={b}"] = dict(r, bound_ms=bnd, bound_by=by)
        out[f"tilings b={b}"] = tilings(be, qb, power)
    return out


def tilings(be, qb, power) -> dict:
    """``pq_scan_luts`` at each (queries, coarse ids) a block, every
    codeword a block (the default shapes' plan keeps kc = ksub)."""
    b = qb.shape[0]
    m, ksub, dsub = be.codebooks.shape
    terms = (be.codebooks, be.coarse_centers, be.coarse_dot, be.cb_sq)
    planned = pq_lut.luts_plan(b, m, ksub, dsub, be.ncoarse, torch.cuda.
                               get_device_properties(0).multi_processor_count)
    want = pq_lut.pq_scan_luts(qb, *terms)
    times = {}
    for qt in (q for q in (1, 2, 4, 8) if q <= b):
        for cr in (c for c in (1, 2, 4, 8, 16, 32) if c <= be.ncoarse):
            p = pq_lut.LutPlan(
                qt=qt, kc=planned.kc, cr=cr, vec=planned.vec,
                blocks=-(-b // qt) * -(-ksub // planned.kc)
                * -(-be.ncoarse // cr),
                smem=pq_lut.luts_smem(qt, planned.kc, cr, dsub))
            got = pq_lut.pq_scan_luts(qb, *terms, _plan=p)
            smoke.check(torch.equal(got.view(torch.int32),
                                    want.view(torch.int32)),
                        f"pq_scan_luts b={b} qt={qt} cr={cr} differs")
            times[f"{qt}x{cr}"] = smoke.device_time(
                lambda: pq_lut.pq_scan_luts(qb, *terms, _plan=p))[0]
    ranked = sorted(times.items(), key=lambda kv: kv[1])
    print(f"[scan_luts tilings b={b}] queries x coarse ids a block, device "
          f"ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ranked)
          + f"; planned {planned.qt}x{planned.cr}; card {power}")
    return dict(times=times, planned=f"{planned.qt}x{planned.cr}")


def adc(iters, power) -> dict:
    dev = torch.device("cuda", 0)
    index, q_t = pq_index()
    be = index.backend
    luts = pq_mod.scan_luts(be, q_t)
    codes = be.ccodes
    n, m = codes.shape
    kk = luts.shape[-1]
    pos = codes.long() + kk * torch.arange(m, device=dev)
    out = {}
    for b in (B, smoke.B_ESC, 1):
        lb = luts[:b].contiguous()
        if b == 1:
            fn = (lambda: ops.pq_score(codes, lb[0]))
            smoke.check(torch.equal(fn(), ref.ref_pq_score(codes, lb[0])),
                        "pq_score differs from its plain version")
        else:
            fn = (lambda: ops.pq_score_batch(codes, lb))
            smoke.check(torch.equal(fn(), ref.ref_pq_score_batch(codes, lb)),
                        f"pq_score_batch b={b} differs from its plain version")
        w = lb.permute(1, 2, 0).reshape(m * kk, b).contiguous()
        lib = smoke.time_ms(lambda: torch.nn.functional.embedding_bag(
            pos, w, mode="sum"), iters)
        bnd, by = smoke.bound_ms(codes.nbytes + lb.nbytes + 4 * b * n,
                                 b * n * m)
        name = "pq_score" if b == 1 else f"pq_score_batch b={b}"
        r = timed(name, fn, iters, power,
                  f"; bit-equal; embedding_bag {lib:.4f} ms; bound "
                  f"{bnd:.4f} ({by}); codes ({n},{m}) {codes.dtype}, luts "
                  f"({b},{m},{kk})")
        out[name] = dict(r, library_ms=lib, bound_ms=bnd, bound_by=by)
    return out


def rerank(iters, power) -> dict:
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for kp, k in ((smoke.KP, 10), (328, 10), (2056, 64)):
        cv = torch.randn((B, kp, D), generator=gen, device=dev)
        cf = torch.randn((B, kp, M), generator=gen, device=dev)
        qn = torch.randn((B, D), generator=gen, device=dev)
        fqn = torch.randn((B, M), generator=gen, device=dev)
        cand = torch.randint(0, smoke.N, (B, kp), generator=gen,
                             device=dev, dtype=torch.int32)

        def seq():
            s = ops.rescore(cv, cf, qn, fqn, 0.5)
            vals, p = ref.topk_first(s, k)
            return vals, torch.gather(cand, -1, p)

        bnd, by = smoke.bound_ms(
            4 * (B * kp * (D + M + 1) + B * (D + M)) + 8 * B * k,
            B * kp * (6 * (D + M) + 12))
        tag = f"kp={kp} k={k}"
        if kp == smoke.KP:
            out["rescore"] = timed(
                f"rescore ({B},{kp},{D})/({B},{kp},{M})",
                lambda: ops.rescore(cv, cf, qn, fqn, 0.5), 50, power)
        out[f"sequence {tag}"] = dict(timed(
            f"rescore -> topk_first -> gather {tag}", seq, 50, power,
            f"; bound {bnd:.5f} ({by})"), bound_ms=bnd, bound_by=by)
        if hasattr(ops, "rescore_topk"):
            fused = (lambda: ops.rescore_topk(cv, cf, qn, fqn, 0.5, cand, k))
            got, want = fused(), seq()
            smoke.check(torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]),
                        f"rescore_topk {tag} differs from the sequence")
            out[f"rescore_topk {tag}"] = dict(timed(
                f"rescore_topk {tag}", fused, 50, power,
                f"; bit-equal to the sequence; bound {bnd:.5f} ({by})"),
                bound_ms=bnd, bound_by=by)
    return out


def sort_order() -> dict:
    """Whether the card's topk_first puts NaN first and keeps -0.0 and
    +0.0 in position order, as the CPU's does, at a short and a long row."""
    out = {}
    g = torch.Generator().manual_seed(0)
    for n in (smoke.KP, 20000):
        x = torch.randint(-3, 4, (4, n), generator=g).float()
        x[x == 0] = torch.where(torch.rand((4, n), generator=g) < 0.5,
                                -0.0, 0.0)[x == 0]
        x[:, 7::97] = float("nan")
        cpu = ref.topk_first(x, n)
        gpu = ref.topk_first(x.cuda(), n)
        same = (torch.equal(cpu[1], gpu[1].cpu())
                and torch.equal(cpu[0].view(torch.int32),
                                gpu[0].cpu().view(torch.int32)))
        print(f"[sort] topk_first on the card orders NaN, -0.0 and +0.0 as "
              f"the CPU does at n={n}: {same}")
        out[str(n)] = same
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--luts", action="store_true",
                    help="time the PQ scan LUTs only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_rerank_adc: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    power = smoke.card()
    _build.build()
    ptx = ptxas_lines()
    for line in ptx:
        print(f"[ptxas] {line}")
    out = {"card": power, "ptxas": ptx}
    if args.luts:
        out["luts"] = luts(args.iters, power)
    else:
        out["sort"] = sort_order()
        out["rerank"] = rerank(args.iters, power)
        out["adc"] = adc(args.iters, power)
    print(power)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
