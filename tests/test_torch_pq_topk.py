"""The fused PQ scan + top-k's design (``pq_lut.pq_score_topk``), emulated in
numpy step by step on its own plan, against the plain version and JAX.

The card's kernels run only on the card (``tests/test_torch_gpu.py`` holds
them to ``ref.ref_pq_score_topk`` bit for bit). Here a numpy emulation walks
the plan ``pq_lut.topk_plan`` gives: the rows stably grouped by coarse id,
the sample pass's evenly spaced rows and, as each query's starting
threshold, the lower edge of its kk-th best sampled word's 24-bit bin (the
threshold kernel's two 12-bit histogram passes; a word at or above it is
admitted), each
(query tile, chunk) block's tiles of rows with their appends (past a
buffer's cap into its spill area) and, after a tile, the order-keeping cut
of every buffer past ``cap - margin`` back to kk, the chunk's last cut, and
the merge's streams (``stream_words`` from the largest least word of a
chunk's full list: each warp's rounds with its own cuts, then warp 0's
gather). Its (vals, ids) must equal
``ref.ref_pq_score_topk`` and ``lax.top_k(-pq_score_batch)`` of the JAX
package bit for bit, no spill may pass its tile of words, and every word of
the true top-kk must be admitted. Words are ``pack(ord_bits(-d2), id)``: -0.0 ranks
below +0.0, equal scores go to the smaller row.
"""
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from jax import lax
from repro.kernels import ops as jops
from repro_torch.index import pq
from repro_torch.kernels import pq_lut, ref
from test_torch_support import tensor

MASK32 = np.uint64(0xFFFFFFFF)


def words_of(d2: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """pack(ord_bits(-d2), id) as uint64 (select_common.cuh's key)."""
    bits = (-d2).astype(np.float32).view(np.uint32)
    ordb = np.where(bits & np.uint32(0x80000000), ~bits,
                    bits | np.uint32(0x80000000)).astype(np.uint64)
    low = (~ids.astype(np.uint32)).astype(np.uint64)
    return (ordb << np.uint64(32)) | low


def decode(w: np.ndarray):
    hi = (w >> np.uint64(32)).astype(np.uint32)
    bits = np.where(hi & np.uint32(0x80000000), hi & np.uint32(0x7FFFFFFF),
                    ~hi).astype(np.uint32)
    ids = (~(w & MASK32).astype(np.uint32)).astype(np.int32)
    return bits.view(np.float32), ids


def in_order_d2(gcodes: np.ndarray, cgroup: np.ndarray, luts: np.ndarray,
                ksub: int) -> np.ndarray:
    """(b, n) the left-to-right fp32 sum over m from the m = 0 entry, of
    each grouped row's combined codes (coarse id * ksub + code)."""
    comb = cgroup[:, None].astype(np.int64) * ksub + gcodes.astype(np.int64)
    total = luts[:, 0, :][:, comb[:, 0]]
    for m in range(1, gcodes.shape[1]):
        total = (total + luts[:, m, :][:, comb[:, m]]).astype(np.float32)
    return total.astype(np.float32)


def cut(buf: list, kk: int):
    """The order-keeping cut: the kk largest words of ``buf`` in their
    order, and the kk-th largest (warp_cut)."""
    kth = np.sort(np.array(buf, np.uint64))[-kk]
    kept = [w for w in buf if w >= kth]
    assert len(kept) == kk
    return kept, kth


def stream_words(src: np.ndarray, kk: int, slots: int, warps: int,
                 stats: dict, thr0=np.uint64(0)) -> np.ndarray:
    """``stream_words``: each warp takes rounds of 256 words (warp w's k-th
    round at (w + k * warps) * 256), appends the words above its threshold
    (from thr0; 0 marks an empty slot), cuts when more than slots - 256 are
    held; warp 0 gathers the warps' lists, cutting when the next list would
    pass its slots."""
    lists = []
    for w in range(warps):
        buf, thr = [], np.uint64(thr0)
        for base in range(w * 256, len(src), warps * 256):
            buf += [x for x in src[base:base + 256] if x > thr]
            assert len(buf) <= slots
            if len(buf) > slots - 256:
                buf, thr = cut(buf, kk)
                stats["merge_cuts"] += 1
        if len(buf) > kk:
            buf, _ = cut(buf, kk)
        lists.append(buf)
    total = list(lists[0])
    for lst in lists[1:]:
        if len(total) + len(lst) > slots:
            total, _ = cut(total, kk)
        total += lst
    if len(total) > kk:
        total, _ = cut(total, kk)
    return np.array(total, np.uint64)


def emulate(codes, coarse, luts, kk, plan, ksub, dtype=torch.uint8):
    """The buffered path of ``plan`` in numpy over the port's grouped layout
    (``pq.grouped_layout`` of the codes as ``dtype``): (vals, ids) and a
    profile."""
    n, m = codes.shape
    b = luts.shape[0]
    ncoarse = luts.shape[2] // ksub
    gcodes, gid, _, goff = pq.grouped_layout(
        tensor(codes).to(dtype), tensor(coarse).to(torch.int32), ncoarse)
    gcodes, gid = gcodes.numpy(), gid.numpy()
    assert gcodes.dtype == (np.uint8 if dtype == torch.uint8 else np.int32)
    cgroup = np.repeat(np.arange(ncoarse), np.diff(goff))
    words = words_of(in_order_d2(gcodes, cgroup, luts, ksub), gid[None, :])
    stats = dict(admitted=0, cuts=0, merge_cuts=0, max_fill=0, spilled=0)
    thr0 = np.zeros(b, np.uint64)
    if plan.sample:
        pos = np.arange(plan.sample) * n // plan.sample
        assert (np.diff(pos) > 0).all() and pos[-1] < n
        kth = np.sort(words[:, pos], axis=1)[:, -kk]
        # the threshold kernel's two 12-bit histogram passes: the lower
        # edge of the kk-th best sampled word's 24-bit bin
        thr0 = (kth >> np.uint64(40)) << np.uint64(40)
        assert (thr0 <= kth).all()
    true_top = np.sort(words, axis=1)[:, -kk:]
    part = np.zeros((b, plan.nchunks, kk), np.uint64)
    tile, cap, mark = plan.tile, plan.cap, plan.cap - plan.margin
    assert kk <= mark
    for q0 in range(0, b, plan.bq):
        qs = range(q0, min(b, q0 + plan.bq))
        for ch in range(plan.nchunks):
            r0 = ch * plan.chunk_rows
            r1 = min(n, r0 + plan.chunk_rows)
            assert r0 < r1
            bufs = {q: [] for q in qs}
            thr = {q: thr0[q] for q in qs}
            admitted = {q: set() for q in qs}
            for t0 in range(r0, r1, tile):
                t1 = min(r1, t0 + tile)
                for q in qs:
                    new = [w for w in words[q, t0:t1] if w >= thr[q]]
                    bufs[q] += new
                    admitted[q].update(new)
                    stats["admitted"] += len(new)
                    stats["max_fill"] = max(stats["max_fill"], len(bufs[q]))
                    stats["spilled"] = max(stats["spilled"],
                                           len(bufs[q]) - cap)
                    assert len(bufs[q]) - cap <= tile   # the spill area
                for q in qs:   # the cuts after a tile
                    if len(bufs[q]) > mark:
                        bufs[q], thr[q] = cut(bufs[q], kk)
                        stats["cuts"] += 1
            for q in qs:
                if len(bufs[q]) > kk:
                    bufs[q], _ = cut(bufs[q], kk)
                part[q, ch, :len(bufs[q])] = bufs[q]
                mine = words[q, r0:r1]
                top = np.intersect1d(mine, true_top[q])
                assert set(top.tolist()) <= admitted[q]
    vals = np.zeros((b, kk), np.float32)
    ids = np.zeros((b, kk), np.int32)
    for q in range(b):
        # the merge starts from the largest least word of a full list
        full = part[q][(part[q] != 0).all(axis=1)]
        bound = full.min(axis=1).max() if len(full) else np.uint64(0)
        assert bound <= true_top[q].min()
        thr0 = bound - np.uint64(1) if bound else np.uint64(0)
        best = stream_words(part[q].ravel(), kk, plan.word_slots,
                            plan.word_warps, stats, thr0)
        assert len(best) == kk
        best = np.sort(best)[::-1]
        vals[q], ids[q] = decode(best)
    return vals, ids, stats


def make_case(seed, n, m, ksub, ncoarse, b, *, kind="spread", groups=None):
    """codes (n, m) int64, coarse ids (n,), luts (b, m, ncoarse * ksub)
    float32. kind: "spread" (quarter-integer LUTs: many equal scores),
    "random", "zeros" (signed zeros and 0.5), "equal" (every entry 1.25:
    every score ties). ``groups`` (ncoarse,) weights the coarse ids (a 0
    leaves a group empty)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ksub, (n, m))
    p = None if groups is None else np.asarray(groups, float) / sum(groups)
    coarse = rng.choice(ncoarse, n, p=p)
    shape = (b, m, ncoarse * ksub)
    if kind == "spread":
        luts = rng.integers(0, 40, shape).astype(np.float32) * 0.25
    elif kind == "random":
        luts = rng.random(shape).astype(np.float32)
    elif kind == "zeros":
        luts = np.where(rng.random(shape) < 0.5, -0.0, 0.0).astype(np.float32)
        luts[:, :, ::7] = 0.5
    else:
        luts = np.full(shape, 1.25, np.float32)
    return codes, coarse, luts


def plain(codes, coarse, luts, kk, ksub):
    ccodes = tensor(coarse[:, None] * ksub + codes).to(torch.int32)
    v, i = ref.ref_pq_score_topk(ccodes, tensor(luts), kk)
    return v.numpy(), i.numpy()


def jax_top_k(codes, coarse, luts, kk, ksub, own_sums=False):
    """lax.top_k of the negated distances: the JAX package's
    ``pq_score_batch``, or (``own_sums``) the port's in-order sums, where
    the LUT entries do not sum exactly in any order."""
    ccodes = (coarse[:, None] * ksub + codes).astype(np.int32)
    if own_sums:
        d2 = jnp.asarray(ref.ref_pq_score_batch(
            tensor(ccodes), tensor(luts)).numpy())
    else:
        d2 = jops.pq_score_batch(jnp.asarray(ccodes), jnp.asarray(luts),
                                 use_pallas=False)
    v, i = lax.top_k(-d2, kk)
    return np.asarray(v), np.asarray(i)


def assert_bits(got, want):
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])


# (name, n, M, ksub, ncoarse, b, kk, kind, groups, code bytes, sms)
CASES = [
    ("serving_shape_small", 6000, 8, 64, 8, 16, 80, "spread", None, 1, 4),
    ("signed_zeros", 3000, 8, 64, 8, 5, 300, "zeros", None, 4, 2),
    ("mass_ties", 3000, 8, 16, 4, 3, 40, "equal", None, 1, 1),
    ("kk_equals_n", 700, 4, 16, 4, 3, 700, "spread", None, 1, 132),
    ("n_below_8kk", 1500, 8, 32, 4, 4, 200, "random", None, 1, 2),
    ("one_group", 4000, 8, 32, 1, 6, 50, "random", None, 1, 2),
    ("empty_groups", 4000, 4, 16, 6, 3, 60, "spread", [7, 0, 10, 0, 3, 0],
     4, 2),
    ("b_past_the_tile", 3000, 8, 32, 4, 21, 30, "random", None, 1, 3),
    ("m16", 2500, 16, 32, 4, 5, 40, "random", None, 1, 2),
    ("m64", 2000, 64, 16, 2, 3, 40, "random", None, 1, 2),
    ("m128", 1200, 128, 16, 2, 3, 30, "random", None, 4, 2),
    ("int32_codes", 5000, 8, 32, 8, 9, 90, "spread", None, 4, 2),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_buffered_path_bit_equal(case):
    """The emulated buffered path equals the plain version bit for bit and
    lax.top_k of the negated distances: the JAX package's where the LUT
    entries sum exactly in any order (quarter-integers, all equal), the
    port's own in-order sums otherwise (random entries; signed zeros, where
    a row of -0.0 entries sums to -0.0 in the port and +0.0 in JAX); the
    planned buffers never spill and every true top-kk word is admitted."""
    _, n, m, ksub, ncoarse, b, kk, kind, groups, cb, sms = case
    codes, coarse, luts = make_case(len(case[0]) + n, n, m, ksub, ncoarse, b,
                                    kind=kind, groups=groups)
    plan = pq_lut.topk_plan(n, b, kk, m, ksub, sms, select=False)
    assert (plan.sample > 0) == (n >= 8 * kk)
    got = emulate(codes, coarse, luts, kk, plan, ksub,
                  torch.uint8 if cb == 1 else torch.int32)
    want = plain(codes, coarse, luts, kk, ksub)
    assert_bits(got[:2], want)
    assert_bits(got[:2], jax_top_k(codes, coarse, luts, kk, ksub,
                                   own_sums=kind in ("random", "zeros")))
    assert got[2]["max_fill"] <= plan.cap


@pytest.mark.parametrize("cap_slack", [1, 40])
@pytest.mark.parametrize("kind", ["random", "equal", "zeros"])
def test_emulated_cuts_with_small_buffers(kind, cap_slack):
    """With buffers of kk + the margin + a few words, a margin smaller than
    a tile and one long chunk a query tile, cuts run after many tiles and
    appends spill past the buffers; the result stays the plain version's
    bits, also with every score equal (words differ by id only) and with
    signed zeros."""
    n, m, ksub, ncoarse, b, kk = 6000, 8, 16, 4, 3, 20
    codes, coarse, luts = make_case(11, n, m, ksub, ncoarse, b, kind=kind)
    plan = pq_lut.topk_plan(n, b, kk, m, ksub, 1, select=False)
    plan = dataclasses.replace(plan, tile=128, margin=16,
                               cap=kk + 16 + cap_slack, chunk_rows=n,
                               nchunks=1)
    if kind == "equal":   # no starting threshold: the first tile spills
        plan = dataclasses.replace(plan, sample=0)
    got = emulate(codes, coarse, luts, kk, plan, ksub)
    assert_bits(got[:2], plain(codes, coarse, luts, kk, ksub))
    assert got[2]["cuts"] > 2
    if kind == "equal":
        assert got[2]["spilled"] > 0


def test_sample_threshold_cuts_admissions():
    """On random LUTs the sample's threshold admits about kk * n / sample
    rows a query over the whole corpus (the design's claim), where a
    threshold of 0 admits every row until a chunk's first cut."""
    n, m, ksub, ncoarse, b, kk = 40_000, 8, 32, 8, 4, 50
    codes, coarse, luts = make_case(3, n, m, ksub, ncoarse, b, kind="random")
    plan = pq_lut.topk_plan(n, b, kk, m, ksub, 2, select=False)
    assert plan.sample == n // 8
    _, _, stats = emulate(codes, coarse, luts, kk, plan, ksub)
    expect = kk * n / plan.sample
    assert stats["admitted"] / b < 3 * expect
    bare = dataclasses.replace(plan, sample=0)
    _, _, stats0 = emulate(codes, coarse, luts, kk, bare, ksub)
    assert stats0["admitted"] > 3 * stats["admitted"]
