#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card, and hold every CUDA
kernel against its plain PyTorch version at the main path's shapes.

Run from the root of the repository, on a machine with one CUDA device:

    python3 chip_smoke.py

Phases, each of which raises (and exits non-zero) on a failure:

1. build: nvcc compiles the kernels of ``src/repro_torch/csrc`` for sm_90a
   (one compiler per source, all at once) and prints what ``-Xptxas -v``
   reports: registers, shared memory, spills.
2. kernels: each kernel against its plain version on the same CUDA tensors,
   at the main path's shapes (SIFT1M scale: n=1,000,000 rows of d=128, m=8
   filter columns, batches of 64). Prints the largest error, the id
   agreement outside near-ties, and the kernel's time beside its bound, the
   plain version's time and, where one PyTorch call computes the same
   function, that call's time (CUDA events, after a warm-up).
3. end to end: a synthetic SIFT1M-shaped corpus, ``fcvi.build`` on the card
   with every ``FCVIConfig`` default, ``FCVIEngine`` with every
   ``EngineConfig`` default, then 512 queries, the first 64 again (cache
   hits), 1,000 inserts (the delta tier's scan goes through the rows
   kernel), 64 queries, ``compact()``, 64 queries, and one ``fcvi.query``
   call (the ids-only scan). The first batch is checked against a CPU
   engine (the plain path) on the same state; recall@10 is measured
   against ``ground_truth_combined`` on the card.
4. a ``kernels`` JSON line with each kernel's launches in phase 3 (each
   must be > 0), errors, times and bound.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script prints no result and exits 1.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import fcvi, theory  # noqa: E402
from repro_torch.data.synthetic import (CorpusSpec, make_corpus,  # noqa: E402
                                        sample_queries)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

N, D, M, B = 1_000_000, 128, 8, 64
KP = 80                      # k' of the defaults: k=10, lam=0.5, c=4
L2_RTOL, L2_ATOL = 1e-5, 1e-4
COS_ATOL = 1e-5

SOURCES = {
    "fused_transform": ("src/repro_torch/csrc/fcvi_transform.cu",
                        "src/repro/kernels/fcvi_transform.py:34"),
    "score_topk": ("src/repro_torch/csrc/fused_score_topk.cu",
                   "src/repro/kernels/fused_score_topk.py:191"),
    "score_topk_rows": ("src/repro_torch/csrc/fused_score_topk.cu",
                        "src/repro/kernels/fused_score_topk.py:287"),
    "rescore": ("src/repro_torch/csrc/rescore.cu",
                "src/repro/kernels/rescore.py:46"),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what bounds it) from bytes moved and fp32 ops."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def ids_outside_ties(ref_vals, ref_ids, ids, rtol, atol):
    """(agreeing, compared) id slots outside the reference's near-ties: a
    slot is a near-tie when its reference score lies within atol + rtol *
    |score| of a neighbour. ``ref_vals`` carries one score more than the
    slots compared, so the last slot's successor is known."""
    rv = ref_vals.double().cpu().numpy()
    k = ids.shape[1]
    gap = np.abs(np.diff(rv, axis=1))
    tol = atol + rtol * np.abs(rv)
    tie = np.zeros(rv.shape, bool)
    tie[:, 1:] |= gap <= tol[:, 1:]
    tie[:, :-1] |= gap <= tol[:, :-1]
    keep = ~tie[:, :k]
    same = (ids.cpu().numpy() == ref_ids[:, :k].cpu().numpy())
    return int((same & keep).sum()), int(keep.sum())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] nvcc, sm_90a, {time.perf_counter() - t0:.1f} s")
    print(_build.build_log().rstrip())


def phase_kernels(dev, gen) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    res = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # B1 fused_transform: the engine's query transform (64 rows) and the
    # corpus transform of build/compaction (1M rows); identity normalizers,
    # 0/1 partition fold, as the hot path calls it
    p = ref.partition_matrix(D, M, device=dev)
    alpha = 1.0
    for rows in (B, N):
        vn, fn = randn(rows, D), randn(rows, M)
        got = ops.fused_transform(vn, fn, p, alpha)
        want = ref.ref_fused_transform(vn, fn, p, alpha)
        err = (got - want).abs().max().item()
        check(err <= 1e-5, f"fused_transform ({rows}, {D}) error {err}")
        ms = time_ms(lambda: ops.fused_transform(vn, fn, p, alpha), 20)
        plain = time_ms(lambda: ref.ref_fused_transform(vn, fn, p, alpha), 20)
        lib = time_ms(lambda: torch.addmm(vn, fn, p, alpha=-alpha), 20)
        bnd, by = bound_ms(4 * (2 * rows * D + rows * M + M * D),
                           rows * D * (2 * M + 2))
        print(f"[kernel] fused_transform ({rows},{D})x({rows},{M}): max_abs_err "
              f"{err:.3g} kernel_ms {ms:.4f} plain_ms {plain:.4f} "
              f"library_ms(addmm) {lib:.4f} bound_ms {bnd:.4f} ({by})")
        res["fused_transform"] = dict(
            max_abs_err=max(err, res.get("fused_transform", {}).get(
                "max_abs_err", 0.0)),
            ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by, library_ms=lib)
        del vn, fn, got, want

    # B2 score_topk / B3 score_topk_rows at b=64 against the 1M-row corpus,
    # kk = k'+REFINE_PAD with the defaults (88) and escalated (328)
    x = randn(N, D)
    sq = torch.sum(x * x, dim=-1)
    q = randn(B, D)
    pv, pf = randn(N, D), randn(N, M)
    scan_in = 4 * (N * D + N + B * D)
    scan_ops = 2 * B * N * D + 3 * B * N
    for kk in (88, 328):
        vals, ids = ops.score_topk(x, sq, q, kk)
        rvals, rids = ref.ref_score_topk(x, sq, q, kk + 1)
        err = (vals - rvals[:, :kk]).abs().max().item()
        tol = (L2_ATOL + L2_RTOL * rvals[:, :kk].abs()).max().item()
        agree, total = ids_outside_ties(rvals, rids, ids, L2_RTOL, L2_ATOL)
        check(err <= tol, f"score_topk kk={kk} error {err} > {tol}")
        check(agree == total, f"score_topk kk={kk}: {total - agree} ids "
              "differ outside near-ties")
        out = ops.score_topk_rows(x, sq, pv, pf, q, kk)
        idx = ids.long()
        check(torch.equal(out[0], vals) and torch.equal(out[1], ids),
              "score_topk_rows (vals, ids) differ from score_topk")
        check(torch.equal(out[2], x[idx]) and torch.equal(out[3], pv[idx])
              and torch.equal(out[4], pf[idx]),
              "score_topk_rows rows differ from the gathered rows")
        ms = time_ms(lambda: ops.score_topk(x, sq, q, kk))
        ms_rows = time_ms(lambda: ops.score_topk_rows(x, sq, pv, pf, q, kk))
        plain = time_ms(lambda: ref.ref_score_topk(x, sq, q, kk), 5)
        plain_rows = time_ms(
            lambda: ref.ref_score_topk_rows(x, sq, pv, pf, q, kk), 5)
        bnd, by = bound_ms(scan_in + 8 * B * kk, scan_ops)
        rows_bytes = 4 * B * kk * (2 * (D + M) + D)
        bnd_rows, by_rows = bound_ms(scan_in + 8 * B * kk + rows_bytes,
                                     scan_ops)
        print(f"[kernel] score_topk b={B} n={N} d={D} kk={kk}: max_abs_err "
              f"{err:.3g} ids {agree}/{total} outside near-ties; kernel_ms "
              f"{ms:.4f} plain_ms {plain:.4f} bound_ms {bnd:.4f} ({by})")
        print(f"[kernel] score_topk_rows kk={kk}: rows exact; kernel_ms "
              f"{ms_rows:.4f} plain_ms {plain_rows:.4f} bound_ms "
              f"{bnd_rows:.4f} ({by_rows})")
        if kk == 88:  # the main path's default width goes in the JSON line
            res["score_topk"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd,
                                     bound_by=by, library_ms=None)
            res["score_topk_rows"] = dict(ms=ms_rows, plain_ms=plain_rows,
                                          bound_ms=bnd_rows,
                                          bound_by=by_rows, library_ms=None)
        for name in ("score_topk", "score_topk_rows"):
            res[name]["max_abs_err"] = max(err, res[name].get("max_abs_err",
                                                              0.0))
        del vals, ids, rvals, rids, out
    del x, sq, q, pv, pf

    # B4 rescore on the engine's (64, 80) candidate tiles
    cv, cf, qn, fqn = randn(B, KP, D), randn(B, KP, M), randn(B, D), randn(B, M)
    got = ops.rescore(cv, cf, qn, fqn, 0.5)
    err = (got - ref.ref_rescore(cv, cf, qn, fqn, 0.5)).abs().max().item()
    check(err <= COS_ATOL, f"rescore error {err}")
    ms = time_ms(lambda: ops.rescore(cv, cf, qn, fqn, 0.5), 50)
    plain = time_ms(lambda: ref.ref_rescore(cv, cf, qn, fqn, 0.5), 50)
    bnd, by = bound_ms(4 * (B * KP * (D + M + 1) + B * (D + M)),
                       B * KP * (6 * (D + M) + 12))
    print(f"[kernel] rescore ({B},{KP},{D})/({B},{KP},{M}): max_abs_err "
          f"{err:.3g} kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
          f"{bnd:.5f} ({by})")
    res["rescore"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bnd, bound_by=by, library_ms=None)
    torch.cuda.empty_cache()
    return res


def phase_end_to_end(dev, power: str) -> dict:
    """The user's path at SIFT1M scale; returns the kernels' launch counts."""
    t0 = time.perf_counter()
    corpus = make_corpus(CorpusSpec(n=N, d=D, n_categories=6, n_numeric=2,
                                    seed=0))
    q_all, f_all = sample_queries(corpus, 512 + 64 + 64, seed=1)
    q_warm, f_warm = sample_queries(corpus, B, seed=3)
    rng = np.random.default_rng(2)
    new_v = (corpus.vectors[rng.integers(0, N, 1000)]
             + 0.1 * rng.normal(size=(1000, D))).astype(np.float32)
    new_f = corpus.filters[rng.integers(0, N, 1000)]
    print(f"[e2e] corpus n={N} d={D} m={M}: {time.perf_counter() - t0:.1f} s "
          "(host, setup)")

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(),
                       device=dev)
    torch.cuda.synchronize()
    print(f"[e2e] build on the card: {time.perf_counter() - t0:.2f} s")
    state0 = fcvi.index_state(index)
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(), device=dev)

    t0 = time.perf_counter()
    eng.search(q_warm, f_warm)      # first-call allocations, kept apart
    cold = time.perf_counter() - t0
    warm_esc = eng.stats.escalations
    lat, served = [], []
    for s in range(0, 512, B):
        t0 = time.perf_counter()
        served.append(eng.search(q_all[s:s + B], f_all[s:s + B]))
        lat.append(time.perf_counter() - t0)
    scores = np.concatenate([s for s, _ in served])
    ids = np.concatenate([i for _, i in served])
    check(scores.shape == (512, 10) and np.isfinite(scores).all(),
          "scores are not finite (512, 10)")
    check(((ids >= 0) & (ids < N)).all(), "ids out of range")
    esc = eng.stats.escalations - warm_esc
    again = eng.search(q_all[:B], f_all[:B])
    check(eng.stats.cache_hits == B, "the repeated batch missed the cache")
    check(np.array_equal(again[1], ids[:B]), "cached ids differ")
    eng.insert(new_v, new_f)
    mid = eng.search(q_all[512:576], f_all[512:576])
    eng.compact()
    check(eng.index.size == N + 1000 and eng.stats.compactions == 1,
          "compaction did not fold the inserts")
    late = eng.search(q_all[576:], f_all[576:])
    for s, i in (mid, late):
        check(np.isfinite(s).all() and ((i >= 0) & (i < N + 1000)).all(),
              "post-insert results out of range")
    qv, qf = (torch.tensor(a, device=dev) for a in (q_all[:B], f_all[:B]))
    fcvi.query(eng.index, qv, qf, 10)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    total_s = sum(lat)
    print(f"[e2e] counts {json.dumps(counts)}")
    print(f"[e2e] 512 queries in batches of {B}: qps {512 / total_s:.1f} "
          f"batch p50 {1e3 * np.percentile(lat, 50):.2f} ms p99 "
          f"{1e3 * np.percentile(lat, 99):.2f} ms (first, cold batch "
          f"{1e3 * cold:.2f} ms, not in these); escalations {esc} of 512; "
          f"cache hits {eng.stats.cache_hits}; card {power}")
    print(f"[e2e] batch ms {[round(1e3 * t, 2) for t in lat]}")

    # recall@10 against the exact combined-score top-10, on the card
    vn, fn = state0["vectors_n"], state0["filters_n"]
    true = []
    for s in range(0, 512, B):
        qn, fqn = index.transform.normalize(
            torch.tensor(q_all[s:s + B], device=dev),
            torch.tensor(f_all[s:s + B], device=dev))
        true.append(fcvi.ground_truth_combined(vn, fn, qn, fqn, 10, 0.5)[1]
                    .cpu().numpy())
    recall = fcvi.recall_at_k(ids, np.concatenate(true))
    print(f"[e2e] recall@10 {recall:.4f} over 512 queries; card {power}")
    check(recall >= 0.9, f"recall@10 {recall} below 0.9")

    # the first batch against a CPU engine (plain path) on the same state
    t0 = time.perf_counter()
    cpu_ix = fcvi.index_from_state(index.config, state0, device="cpu")
    cpu_eng = engine_mod.FCVIEngine(cpu_ix, engine_mod.EngineConfig(),
                                    device="cpu")
    cs, ci = cpu_eng.search(q_all[:B], f_all[:B])
    qc, fc = torch.tensor(q_all[:B]), torch.tensor(f_all[:B])
    kp = theory.k_prime(10, 0.5, 1.0, N, 4.0)
    _, _, margin = engine_mod._batch_step(cpu_ix, None, qc, fc, k=10, kp=kp,
                                          kd=0, gather_free=True)
    edge = (margin - eng.cfg.escalate_margin).abs().numpy() < 1e-5
    rows = ~edge
    err = float(np.abs(scores[:B][rows] - cs[rows]).max())
    check(err <= COS_ATOL, f"first batch scores differ from the CPU engine "
          f"by {err}")
    diff = np.zeros_like(cs, bool)
    diff[rows] = ids[:B][rows] != ci[rows]
    gap = np.abs(np.diff(cs.astype(np.float64), axis=1))
    tie = np.zeros_like(diff)
    tie[:, 1:] |= gap <= COS_ATOL
    tie[:, :-1] |= gap <= COS_ATOL
    tie[:, -1] = True          # the CPU engine's 11th score is unknown
    check(not (diff & ~tie).any(), "first batch ids differ from the CPU "
          "engine outside near-ties")
    print(f"[e2e] first batch vs CPU engine (plain path): max score err "
          f"{err:.3g}, {int(diff.sum())} id slots differ, all at near-ties; "
          f"{int(edge.sum())} escalation-boundary queries excluded; "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    power = card()
    print(f"[card] {power}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    phase_build()
    res = phase_kernels(dev, torch.Generator(device=dev).manual_seed(0))
    counts = phase_end_to_end(dev, power)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        launches = counts.get(name, 0)
        check(launches > 0, f"kernel {name} was not launched on the main "
              "path")
        r = res[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
