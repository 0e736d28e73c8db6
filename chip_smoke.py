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
3. end to end, flat: a synthetic SIFT1M-shaped corpus, ``fcvi.build`` on
   the card with every ``FCVIConfig`` default, ``FCVIEngine`` with every
   ``EngineConfig`` default, then 512 queries, the first 64 again (cache
   hits), 1,000 inserts (the delta tier's scan goes through the rows
   kernel), 64 queries, ``compact()``, 64 queries, and one ``fcvi.query``
   call (the ids-only scan). The first batch is checked against a CPU
   engine (the plain path) on the same state; recall@10 is measured
   against ``ground_truth_combined`` on the card.
3b. end to end, IVF: the same corpus and queries with
   ``FCVIConfig(backend="ivf", nlist=1024, nprobe=16)`` (every other field
   and all of ``EngineConfig`` at their defaults). The build prints the
   k-means time and the list layout (max_list, mean list, pad fraction).
   Then the IVF kernels B5, B6 and B7 are held against their plain
   versions on the built index's slabs with a batch's coarse probes, at
   k=80 and k=320 (the escalated k'), as phase 2 holds the others. Then
   the same serving sequence as phase 3, one ``fcvi.query`` (B5) and one
   direct ``ops.ivf_score_topk_batch`` call on the index's slabs (B7: no
   serving path calls it, in the JAX package either). Checks: the first
   batch against a CPU engine on the same state; one batch at
   ``nprobe=nlist`` against the flat engine on the same corpus; recall@10
   printed beside the flat path's (IVF is approximate: no floor).
4. a ``kernels`` JSON line with each kernel's launches over phases 3 and 3b
   (each must be > 0), errors, times and bound.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device
the script prints no result and exits 1.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import clustering, fcvi, theory  # noqa: E402
from repro_torch.data.synthetic import (CorpusSpec, make_corpus,  # noqa: E402
                                        sample_queries)
from repro_torch.index import flat as flat_mod  # noqa: E402
from repro_torch.index import ivf as ivf_mod  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12

N, D, M, B = 1_000_000, 128, 8, 64
KP = 80                      # k' of the defaults: k=10, lam=0.5, c=4
NLIST, NPROBE = 1024, 16     # IVF-Flat at SIFT1M's size: nlist ~ sqrt(n)
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
    "ivf_score_topk_dedup": ("src/repro_torch/csrc/ivf_score.cu",
                             "src/repro/kernels/ivf_score.py:209"),
    "ivf_score_topk_dedup_rows": ("src/repro_torch/csrc/ivf_score.cu",
                                  "src/repro/kernels/ivf_score.py:315"),
    "ivf_score_topk_batch": ("src/repro_torch/csrc/ivf_score.cu",
                             "src/repro/kernels/ivf_score.py:94"),
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


@dataclasses.dataclass
class Inputs:
    """The corpus and query stream both end-to-end phases serve (host)."""

    corpus: object
    q_all: np.ndarray      # 640 queries: 512 timed, then 64 + 64 after inserts
    f_all: np.ndarray
    q_warm: np.ndarray     # the warm-up batch, apart from the timed ones
    f_warm: np.ndarray
    new_v: np.ndarray      # 1,000 inserts
    new_f: np.ndarray


def make_inputs() -> Inputs:
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
    return Inputs(corpus, q_all, f_all, q_warm, f_warm, new_v, new_f)


def serve(tag: str, eng, inp: Inputs, power: str):
    """The serving sequence of phases 3 and 3b: a warm-up batch, 512 timed
    queries in batches of 64, the first 64 again (cache hits), 1,000
    inserts, 64 queries, ``compact()``, 64 queries. Returns (scores, ids)
    of the 512."""
    t0 = time.perf_counter()
    eng.search(inp.q_warm, inp.f_warm)   # first-call allocations, kept apart
    cold = time.perf_counter() - t0
    warm_esc = eng.stats.escalations
    lat, served = [], []
    for s in range(0, 512, B):
        t0 = time.perf_counter()
        served.append(eng.search(inp.q_all[s:s + B], inp.f_all[s:s + B]))
        lat.append(time.perf_counter() - t0)
    scores = np.concatenate([s for s, _ in served])
    ids = np.concatenate([i for _, i in served])
    check(scores.shape == (512, 10) and np.isfinite(scores).all(),
          f"{tag}: scores are not finite (512, 10)")
    check(((ids >= 0) & (ids < N)).all(), f"{tag}: ids out of range")
    esc = eng.stats.escalations - warm_esc
    again = eng.search(inp.q_all[:B], inp.f_all[:B])
    check(eng.stats.cache_hits == B, f"{tag}: the repeated batch missed the "
          "cache")
    check(np.array_equal(again[1], ids[:B]), f"{tag}: cached ids differ")
    eng.insert(inp.new_v, inp.new_f)
    mid = eng.search(inp.q_all[512:576], inp.f_all[512:576])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    check(eng.index.size == N + 1000 and eng.stats.compactions == 1,
          f"{tag}: compaction did not fold the inserts")
    late = eng.search(inp.q_all[576:], inp.f_all[576:])
    for s, i in (mid, late):
        check(np.isfinite(s).all() and ((i >= 0) & (i < N + 1000)).all(),
              f"{tag}: post-insert results out of range")
    total_s = sum(lat)
    print(f"[{tag}] 512 queries in batches of {B}: qps {512 / total_s:.1f} "
          f"batch p50 {1e3 * np.percentile(lat, 50):.2f} ms p99 "
          f"{1e3 * np.percentile(lat, 99):.2f} ms (first, cold batch "
          f"{1e3 * cold:.2f} ms, not in these); escalations {esc} of 512; "
          f"cache hits {eng.stats.cache_hits}; compact() {compact_s:.2f} s; "
          f"card {power}")
    print(f"[{tag}] batch ms {[round(1e3 * t, 2) for t in lat]}")
    return scores, ids


def recall_vs_truth(index, state0, inp: Inputs, ids, dev) -> float:
    """recall@10 of ``ids`` (the 512 timed queries) against the exact
    combined-score top-10 over the original corpus, on the card."""
    vn, fn = state0["vectors_n"], state0["filters_n"]
    true = []
    for s in range(0, 512, B):
        qn, fqn = index.transform.normalize(
            torch.tensor(inp.q_all[s:s + B], device=dev),
            torch.tensor(inp.f_all[s:s + B], device=dev))
        true.append(fcvi.ground_truth_combined(vn, fn, qn, fqn, 10, 0.5)[1]
                    .cpu().numpy())
    return fcvi.recall_at_k(ids, np.concatenate(true))


def margins(eng, q: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Each query's first-stage top-10 margin, as the engine's escalation
    test reads it."""
    kp = theory.k_prime(10, 0.5, 1.0, eng.index.size, 4.0)
    dev = eng.device
    _, _, margin = eng._step(None, torch.tensor(q, device=dev),
                             torch.tensor(f, device=dev), k=10, kp=kp, kd=0)
    return margin.cpu().numpy()


def same_top10(tag: str, scores, ids, want_s, want_i, exclude) -> None:
    """Combined scores within COS_ATOL and ids equal outside near-ties of
    the reference (want_*), over the queries not in ``exclude``."""
    rows = ~exclude
    err = float(np.abs(scores[rows] - want_s[rows]).max())
    check(err <= COS_ATOL, f"{tag}: scores differ by {err}")
    diff = np.zeros_like(want_s, bool)
    diff[rows] = ids[rows] != want_i[rows]
    gap = np.abs(np.diff(want_s.astype(np.float64), axis=1))
    tie = np.zeros_like(diff)
    tie[:, 1:] |= gap <= COS_ATOL
    tie[:, :-1] |= gap <= COS_ATOL
    tie[:, -1] = True          # the reference's 11th score is unknown
    check(not (diff & ~tie).any(), f"{tag}: ids differ outside near-ties")
    print(f"[{tag}] max score err {err:.3g}, {int(diff.sum())} id slots "
          f"differ, all at near-ties; {int(exclude.sum())} of "
          f"{len(exclude)} queries excluded")


def against_cpu_engine(tag: str, index, state0, scores, ids, q, f,
                       exclude) -> None:
    """The first batch against a CPU engine (the plain path) on the same
    state; escalation-boundary queries and those in ``exclude`` are left
    out."""
    t0 = time.perf_counter()
    cpu_ix = fcvi.index_from_state(index.config, state0, device="cpu")
    cpu_eng = engine_mod.FCVIEngine(cpu_ix, engine_mod.EngineConfig(),
                                    device="cpu")
    cs, ci = cpu_eng.search(q, f)
    edge = np.abs(margins(cpu_eng, q, f) - cpu_eng.cfg.escalate_margin) < 1e-5
    same_top10(f"{tag} first batch vs CPU engine (plain path)", scores, ids,
               cs, ci, edge | exclude)
    print(f"[{tag}] {int(edge.sum())} escalation-boundary queries excluded; "
          f"{time.perf_counter() - t0:.1f} s")


def phase_end_to_end(dev, power: str, inp: Inputs):
    """The flat path at SIFT1M scale; returns its kernels' launch counts and
    recall@10."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters,
                       fcvi.FCVIConfig(), device=dev)
    torch.cuda.synchronize()
    print(f"[e2e] build on the card: {time.perf_counter() - t0:.2f} s")
    state0 = fcvi.index_state(index)
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(), device=dev)
    scores, ids = serve("e2e", eng, inp, power)
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    fcvi.query(eng.index, qv, qf, 10)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    print(f"[e2e] counts {json.dumps(counts)}")
    recall = recall_vs_truth(index, state0, inp, ids, dev)
    print(f"[e2e] recall@10 {recall:.4f} over 512 queries; card {power}")
    check(recall >= 0.9, f"recall@10 {recall} below 0.9")
    against_cpu_engine("e2e", index, state0, scores[:B], ids[:B],
                       inp.q_all[:B], inp.f_all[:B], np.zeros(B, bool))
    return counts, recall


def probe_ties(centroids, q_t, nprobe) -> np.ndarray:
    """(b,) bool: queries whose nprobe-th and (nprobe+1)-th coarse scores
    (float64) lie within the L2 tolerance: fp32 rounding may give the card
    and the CPU different probe sets there."""
    c = centroids.double().cpu().numpy()
    q = q_t.double().cpu().numpy()
    d2 = np.sort(((q * q).sum(1)[:, None] - 2 * q @ c.T
                  + (c * c).sum(1)[None]), axis=1)
    a, b = d2[:, nprobe - 1], d2[:, nprobe]
    return (b - a) <= L2_ATOL + L2_RTOL * np.abs(b)


def ivf_bound(be, uniq, member, nq, k, row_floats):
    """(bound ms, what bounds it, real-row bytes, padded bytes) of one IVF
    scan: the unique probed lists' valid flags and live rows (vector + norm)
    read once, the queries and member matrix read, (vals, ids) and
    ``row_floats`` payload floats per winner written (and read); fp32
    operations 2d + 2 per (member pair, live row)."""
    sizes = be.list_sizes.long().cpu().numpy()
    mem = member.cpu().numpy() > 0.5
    live = mem.any(axis=1)
    lists = uniq.long().cpu().numpy()[live]
    rows = int(sizes[lists].sum())
    pair_rows = int((mem[live].sum(axis=1) * sizes[lists]).sum())
    d = be.grouped.shape[-1]
    real = 4 * rows * (d + 1) + 4 * len(lists) * be.max_list
    padded = 4 * len(lists) * be.max_list * (d + 2)
    io = 4 * (nq * d + member.numel()) + 8 * nq * k + 8 * nq * k * row_floats
    bnd, by = bound_ms(real + io, pair_rows * (2 * d + 2))
    return bnd, by, real, padded


def ivf_kernels(index, inp: Inputs, dev, power: str) -> dict:
    """B5, B6 and B7 against their plain versions on the built index's slabs,
    with the coarse probes of the first timed batch, at k=80 and 320."""
    be = index.backend
    q = torch.tensor(inp.q_all[:B], device=dev)
    f = torch.tensor(inp.f_all[:B], device=dev)
    q_t = index.transform.apply(q, f).contiguous()
    c2 = torch.sum(be.centroids * be.centroids, dim=-1)
    _, probes = ops.score_topk(be.centroids, c2, q_t, NPROBE)
    uniq, member = ops.dedup_probes(probes, NLIST)
    gpv = ivf_mod.build_grouped_payload(index.vectors_n, be.lists)
    gpf = ivf_mod.build_grouped_payload(index.filters_n, be.lists)
    n_live = int((member > 0.5).any(dim=1).sum())
    print(f"[ivf-kernel] batch of {B}: {n_live} unique probed lists of "
          f"{NLIST} ({B * NPROBE} probes)")
    grp = (be.grouped, be.grouped_sq, be.valid)
    ded = (*grp, uniq, member, q_t)
    res = {}
    for k in (KP, 4 * KP):
        vals, ids = ops.ivf_score_topk_dedup(*ded, k)
        rvals, rids = ref.ref_ivf_score_topk_dedup(*ded, k + 1)
        out = ops.ivf_score_topk_dedup_rows(*ded, gpv, gpf, k)
        check(torch.equal(out[0], vals) and torch.equal(out[1], ids),
              "ivf_score_topk_dedup_rows (vals, ids) differ from B5's")
        dead = torch.isneginf(vals)[..., None]
        idx = ids.long()
        check(torch.equal(out[2], torch.where(dead, 0.0,
                                              gpv.reshape(-1, D)[idx]))
              and torch.equal(out[3], torch.where(dead, 0.0,
                                                  gpf.reshape(-1, M)[idx])),
              "ivf_score_topk_dedup_rows rows differ from the gathered rows")
        bv, bi = ops.ivf_score_topk_batch(*grp, probes, q_t, k)
        rbv, rbi = ref.ref_ivf_score_topk_batch(*grp, probes, q_t, k + 1)
        runs = {
            "ivf_score_topk_dedup": (
                (vals, ids), (rvals, rids),
                lambda: ops.ivf_score_topk_dedup(*ded, k),
                lambda: ref.ref_ivf_score_topk_dedup(*ded, k), 0),
            "ivf_score_topk_dedup_rows": (
                (vals, ids), (rvals, rids),
                lambda: ops.ivf_score_topk_dedup_rows(*ded, gpv, gpf, k),
                lambda: ref.ref_ivf_score_topk_dedup_rows(*ded, gpv, gpf, k),
                D + M),
            "ivf_score_topk_batch": (
                (bv, bi), (rbv, rbi),
                lambda: ops.ivf_score_topk_batch(*grp, probes, q_t, k),
                lambda: ref.ref_ivf_score_topk_batch(*grp, probes, q_t, k),
                0),
        }
        for name, (got, want, kernel, plain_fn, row_floats) in runs.items():
            wv = want[0][:, :k]
            live = ~torch.isneginf(wv)
            err = (got[0] - wv)[live].abs().max().item()
            tol = (L2_ATOL + L2_RTOL * wv[live].abs()).max().item()
            agree, total = ids_outside_ties(want[0], want[1], got[1], L2_RTOL,
                                            L2_ATOL)
            check(err <= tol, f"{name} k={k} error {err} > {tol}")
            check(agree == total, f"{name} k={k}: {total - agree} ids differ "
                  "outside near-ties")
            ms = time_ms(kernel, 20)
            plain = time_ms(plain_fn, 3)
            bnd, by, real, padded = ivf_bound(be, uniq, member, B, k,
                                              row_floats)
            print(f"[kernel] {name} b={B} nlist={NLIST} max_list="
                  f"{be.max_list} d={D} nprobe={NPROBE} k={k}: max_abs_err "
                  f"{err:.3g} ids {agree}/{total} outside near-ties; "
                  f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
                  f"{bnd:.4f} ({by}; probed lists {real / 1e6:.1f} MB of "
                  f"real rows, {padded / 1e6:.1f} MB padded)")
            if k == KP:       # the main path's default width goes in the line
                res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                 bound_ms=bnd, bound_by=by, library_ms=None)
            else:
                res[name]["max_abs_err"] = max(err, res[name]["max_abs_err"])
    print("[ivf-kernel] B6 (vals, ids) bit-equal to B5's and its rows "
          f"bit-equal to the gathered rows at k={KP} and {4 * KP}; card "
          f"{power}")
    return res


def phase_ivf(dev, power: str, inp: Inputs, flat_recall: float):
    """The IVF path at SIFT1M scale; returns the IVF kernels' results and
    the launch counts of its build and serving (the kernel checks between
    them are not counted)."""
    cfg = fcvi.FCVIConfig(backend="ivf", nlist=NLIST, nprobe=NPROBE)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    index = fcvi.build(inp.corpus.vectors, inp.corpus.filters, cfg,
                       device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    be = index.backend
    t0 = time.perf_counter()
    clustering.kmeans(be.vectors, NLIST, iters=15,
                      generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    sizes = be.list_sizes.double()
    pad = 1.0 - N / (NLIST * be.max_list)
    slab_mb = (be.grouped.nbytes + be.grouped_sq.nbytes
               + be.valid.nbytes) / 1e6
    print(f"[ivf] build on the card {build_s:.2f} s (k-means nlist={NLIST} "
          f"iters=15 alone, same inputs: {kmeans_s:.2f} s); max_list "
          f"{be.max_list}, mean list {sizes.mean().item():.1f}, smallest "
          f"{int(sizes.min().item())}, pad fraction {pad:.3f}; serving slabs "
          f"{slab_mb:.0f} MB, grouped payloads "
          f"{4 * NLIST * be.max_list * (D + M) / 1e6:.0f} MB; card {power}")
    res = ivf_kernels(index, inp, dev, power)
    torch.cuda.empty_cache()

    state0 = fcvi.index_state(index)
    eng = engine_mod.FCVIEngine(index, engine_mod.EngineConfig(), device=dev)
    _build.reset_launch_counts()
    scores, ids = serve("ivf", eng, inp, power)
    qv, qf = (torch.tensor(a, device=dev) for a in (inp.q_all[:B],
                                                    inp.f_all[:B]))
    fcvi.query(eng.index, qv, qf, 10)
    ib = eng.index.backend
    q_t = eng.index.transform.apply(qv, qf).contiguous()
    c2 = torch.sum(ib.centroids * ib.centroids, dim=-1)
    probes = ops.score_topk(ib.centroids, c2, q_t, NPROBE)[1]
    vals, _ = ops.ivf_score_topk_batch(ib.grouped, ib.grouped_sq, ib.valid,
                                       probes, q_t, KP)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(vals).all()), "ivf_score_topk_batch on the "
          "index's slabs returned non-finite scores")
    for name, n in _build.launch_counts().items():
        counts[name] = counts.get(name, 0) + n
    print(f"[ivf] counts {json.dumps(counts)}")

    recall = recall_vs_truth(index, state0, inp, ids, dev)
    print(f"[ivf] recall@10 {recall:.4f} over 512 queries (flat path "
          f"{flat_recall:.4f}); card {power}")
    qb, fb = inp.q_all[:B], inp.f_all[:B]
    ties = probe_ties(be.centroids, index.transform.apply(qv, qf), NPROBE)
    print(f"[ivf] {int(ties.sum())} of {B} first-batch queries at a probe "
          "near-tie")
    against_cpu_engine("ivf", index, state0, scores[:B], ids[:B], qb, fb,
                       ties)

    # full probe scans every row: the flat engine's top-10 on the same
    # corpus and state, queries at either engine's escalation boundary
    # left out
    full = dataclasses.replace(index, config=dataclasses.replace(
        cfg, nprobe=NLIST))
    flat_ix = dataclasses.replace(index, config=fcvi.FCVIConfig(),
                                  backend=flat_mod.build(be.vectors))
    engs = [engine_mod.FCVIEngine(ix, engine_mod.EngineConfig(), device=dev)
            for ix in (full, flat_ix)]
    (fs, fi), (ls, li) = (e.search(qb, fb) for e in engs)
    edge = np.zeros(B, bool)
    for e in engs:
        edge |= np.abs(margins(e, qb, fb) - e.cfg.escalate_margin) < 1e-5
    same_top10(f"ivf nprobe={NLIST} vs flat engine", fs, fi, ls, li, edge)
    return res, counts


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
    inp = make_inputs()
    counts, recall = phase_end_to_end(dev, power, inp)
    torch.cuda.empty_cache()
    ivf_res, ivf_counts = phase_ivf(dev, power, inp, recall)
    res.update(ivf_res)
    for name, n in ivf_counts.items():
        counts[name] = counts.get(name, 0) + n
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        launches = counts.get(name, 0)
        check(launches > 0, f"kernel {name} was not launched on the main "
              "paths (phases 3 and 3b)")
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
