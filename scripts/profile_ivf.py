#!/usr/bin/env python3
"""Where the IVF list scans' time goes on the card: B5
(``ivf_score_topk_dedup``), B6 (``ivf_score_topk_dedup_rows``) and B7
(``ivf_score_topk_batch``) at ``chip_smoke.py``'s full width
(SIFT1M-shaped corpus, n=1,000,000, d=128, nlist=1024, nprobe=16, one
batch of 64 queries: phase 3b's first batch), at every storage dtype over
the same lists (bf16 rows and int8 codes with per-row scales made from the
fp32 index's transformed rows).

Run from the root of the repository on a machine with one CUDA device:

    python3 scripts/profile_ivf.py [--storage float32 bfloat16 int8]
        [--ks 80 320 3200] [--d384] [--iters 20]

It prints the batch's member statistics (unique probed lists, a histogram
of member queries a list, the lists' live rows and the member pairs), what
``-Xptxas -v`` reported for the list scan's kernels, and for each dtype, k
and scan: the call's time (CUDA events over ``--iters`` calls), its bytes
bound (``chip_smoke.ivf_bound``), and the device time of each kernel the
call launches (``torch.profiler``), per call. At k=3200 the selection path
is timed forced as well. ``--d384`` adds an IVF corpus at d=384 (phase 3g's,
fp32). The last line is a JSON object with those numbers and the card's
name and power limit. Without a CUDA device it exits 1 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import fcvi  # noqa: E402
from repro_torch.data.synthetic import (CorpusSpec, make_corpus,  # noqa: E402
                                        sample_queries)
from repro_torch.index import ivf as ivf_mod  # noqa: E402
from repro_torch.index import quant  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import ivf_score as ivf_kern  # noqa: E402

B = smoke.B


def ptxas_lines() -> list:
    """-Xptxas -v's registers, shared memory and spills of ivf_score.cu's
    list scan and merge kernels, one line each."""
    log = _build.build_log()
    part = log.split("== ivf_score.cu", 1)[-1].split("\n== ", 1)[0]
    out, name = [], None
    for line in part.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "list_" in name and (
                "spill" in line or "registers" in line):
            short = re.sub(r"^_ZN\w*?_cu_\w{8}\d+", "", name)[:48]
            out.append(f"{short}: {line.strip()}")
    return out


def scans(be, q_t, k, probes, uniq, member, gpv, gpf, select=None):
    """Each scan as fn(stats=None), and its payload floats a winner."""
    grp = (be.grouped, be.grouped_sq, be.valid)
    ded = (*grp, uniq, member, q_t)
    sc = be.grouped_scales
    return {
        "B5": (lambda st=None: ivf_kern.ivf_score_topk_dedup(
            *ded, k, scales=sc, _select=select, _stats=st), 0),
        "B6": (lambda st=None: ivf_kern.ivf_score_topk_dedup_rows(
            *ded, gpv, gpf, k, scales=sc, _select=select, _stats=st),
            gpv.shape[-1] + gpf.shape[-1]),
        "B7": (lambda st=None: ivf_kern.ivf_score_topk_batch(
            *grp, probes, q_t, k, scales=sc, _select=select, _stats=st), 0),
    }


def scan_profile(fn, blocks: int) -> dict:
    """Pass 1's own profile (``ivf_score.STAT_NAMES``) of one call: cycles
    a block by phase (consumer thread 0's and the producer's), the cuts,
    admitted candidates, tiles and passes over all blocks."""
    st = torch.zeros(ivf_kern.STATS, dtype=torch.int64, device="cuda")
    fn(st)
    torch.cuda.synchronize()
    v = dict(zip(ivf_kern.STAT_NAMES, st.tolist()))
    for name in ivf_kern.STAT_NAMES[:7]:
        v[name] = v[name] / blocks
    return v


def profile(tag, be, q_t, ks, iters, power) -> dict:
    sms = torch.cuda.get_device_properties(q_t.device).multi_processor_count
    c2 = torch.sum(be.centroids * be.centroids, dim=-1)
    _, probes = ops.score_topk(be.centroids, c2, q_t, smoke.NPROBE)
    uniq, member = ops.dedup_probes(probes, smoke.NLIST)
    lists = be.lists
    d = be.grouped.shape[-1]
    gpv = torch.zeros((*lists.shape, d), device=q_t.device)
    gpf = torch.zeros((*lists.shape, smoke.M), device=q_t.device)
    res = {"members": smoke.member_stats(be, uniq, member)}
    for k in ks:
        forced = (None, True) if k >= 40 * smoke.KP else (None,)
        for select in forced:
            for name, (fn, row_floats) in scans(be, q_t, k, probes, uniq,
                                                member, gpv, gpf,
                                                select).items():
                ms = smoke.time_ms(fn, iters)
                bnd, by, real, _ = smoke.ivf_bound(be, uniq, member, B, k,
                                                   row_floats)
                split = smoke.kernel_split(fn)
                key = f"{name} k={k}" + (" selection (forced)" if select
                                         else "")
                items = (B * smoke.NPROBE if name == "B7"
                         else uniq.shape[0])
                prof = scan_profile(fn, min(items, sms))
                res[key] = dict(ms=ms, bound_ms=bnd, bound_by=by,
                                split=split, scan=prof)
                parts = "; ".join(f"{n} {t:.4f}" for n, t in
                                  sorted(split.items(), key=lambda x: -x[1]))
                print(f"[{tag}] {key} d={d}: {ms:.4f} ms, bound {bnd:.4f} "
                      f"({by}; {real / 1e6:.1f} MB of live rows); kernels "
                      f"(device ms a call): {parts}; card {power}")
                print(f"[{tag}] {key} pass 1 by phase, thousands of cycles "
                      "a block: " + ", ".join(
                          f"{n} {prof[n] / 1e3:.1f}"
                          for n in ivf_kern.STAT_NAMES[:7])
                      + "; " + ", ".join(f"{n} {prof[n]}" for n in
                                         ivf_kern.STAT_NAMES[7:]))
    return res


def slabs(index, dtype):
    """The index's lists at ``dtype``: fp32 as built, bf16 rows, or int8
    codes with per-row scales, from the same transformed rows."""
    be = index.backend
    if dtype == "float32":
        return be
    x_t = index.transform.apply_normalized(index.vectors_n, index.filters_n)
    if dtype == "bfloat16":
        return ivf_mod.from_lists(x_t.to(torch.bfloat16), be.centroids,
                                  be.lists, be.list_sizes)
    codes, scales = quant.quantize_rows(x_t)
    return ivf_mod.from_lists(codes, be.centroids, be.lists, be.list_sizes,
                              scales)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--storage", nargs="+",
                    default=["float32", "bfloat16", "int8"],
                    choices=sorted(fcvi.STORAGE_DTYPES))
    ap.add_argument("--ks", nargs="+", type=int,
                    default=[smoke.KP, 4 * smoke.KP, 40 * smoke.KP])
    ap.add_argument("--d384", action="store_true",
                    help="add an IVF corpus at d=384 (fp32)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_ivf: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    power = smoke.card()
    _build.build()
    ptx = ptxas_lines()
    for line in ptx:
        print(f"[ptxas] {line}")
    inp = smoke.make_inputs()
    cfg = fcvi.FCVIConfig(backend="ivf", nlist=smoke.NLIST,
                          nprobe=smoke.NPROBE)
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters, cfg,
                       device=dev)
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    q_t = index.transform.apply(qv, qf).contiguous()
    out = {"card": power, "ptxas": ptx}
    for dtype in args.storage:
        out[dtype] = profile(dtype, slabs(index, dtype), q_t, args.ks,
                             args.iters, power)
        torch.cuda.empty_cache()
    if args.d384:
        del index
        torch.cuda.empty_cache()
        emb = make_corpus(CorpusSpec(n=smoke.N, d=smoke.EMB_D,
                                     n_categories=6, n_numeric=2, seed=0))
        eq, ef = sample_queries(emb, B, seed=1)
        eix = fcvi.build(emb.vectors, emb.filters, cfg, device=dev)
        ev, evf = (torch.tensor(a, device=dev) for a in (eq, ef))
        out["float32 d=384"] = profile(
            "d=384", eix.backend, eix.transform.apply(ev, evf).contiguous(),
            [smoke.KP, 40 * smoke.KP], args.iters, power)
    print(power)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
