"""The selection path's select and B5 ``mask=``'s tensor-core design, on the
CPU.

The select (``csrc/select_common.cuh``) is planned in Python
(``_build.select_plan``): chunks a query, the grid, the candidate buffer,
the histogram scratch and the sort. Its passes are emulated here in numpy,
digit for digit (16-bit full-row digits, the compaction, 11-bit digits over
the buffer), against a sort, so the state machine's pass counts and its
result are held without a card. B5 ``mask=`` now runs the flat scan over
the eligible slots of the flattened grouped slab, with B5's epilogue; that
function, composed here in plain PyTorch from the wrapper's own operands
(``ref.ref_ivf_masked_slots``, the plain version of its operand builder),
is held against the port's
plain B5 and the JAX package's B5 ``mask=`` (its Pallas kernel in
interpret mode and its plain path): scores at rtol 1e-5 / atol 1e-4, ids
equal outside near-ties, dead slots exactly (-inf, 0).
"""
import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ref
from test_torch_filter_kernels import _check_masked, _opt
from test_torch_quant_kernels import _ivf_operands
from test_torch_support import ivf_inputs, tensor

SMS = 132   # the H100's SMs
FINISH_STATIC = 4 * 2048 + 64   # select_finish's FinishState, bytes


# -- the planner --------------------------------------------------------------

@pytest.mark.parametrize("nq,n,seg_len", [
    (64, 1_000_000, None), (64, 2 ** 31 - 1, None), (1, 1_000_000, None),
    (9, 3000, None), (64, 1024 * 984, 984), (64, 16 * 984, 984),
    (7, 24 * 200, 200), (4, 40 * 70_000, 70_000), (1, 1, None)])
def test_select_plan_every_kk(nq, n, seg_len):
    """At every kk in 1..50,000: the buffer holds kk (twice kk, a power of
    two, where histograms run), histograms run exactly where the entries
    outnumber the buffer, a chunk's entries fit 16-bit counters and are a
    run of whole segments where a segment fits, the grid covers the SMs
    twice unless a chunk is at its floor, and the scratch and the finish's
    shared memory are what the source expects."""
    for kk in range(1, 50_001):
        p = _build.select_plan(nq, n, kk, SMS, seg_len=seg_len)
        assert min(kk, n) <= p.cap <= max(1, n)
        assert p.hist == (n > p.cap)
        assert p.passes == (_build.SELECT_PASSES if p.hist else 1)
        if p.hist:
            assert p.cap >= 2 * kk and p.cap >= _build.SELECT_MIN_CAP
            assert p.cap & (p.cap - 1) == 0
        assert 1 <= p.chunk <= _build.SELECT_MAX_CHUNK
        assert p.nchunks == max(1, math.ceil(n / p.chunk)) <= 65535
        if seg_len is not None and seg_len <= _build.SELECT_MAX_CHUNK:
            assert p.chunk % seg_len == 0
            floor = seg_len
        else:
            floor = _build.SELECT_MIN_CHUNK
        assert nq * p.nchunks >= 2 * SMS or p.chunk == floor
        assert p.sort_len & (p.sort_len - 1) == 0
        assert kk <= p.sort_len < 2 * kk
        assert p.sort_in_smem == (12 * p.sort_len <= _build.SORT_SMEM_LIMIT)
        parts = _build.select_scratch_bytes(p, nq)
        assert parts["hist"] >= (4 * _build.SELECT_HIST_WORDS * nq
                                 if p.hist else 0)
        assert p.hist or parts["hist"] == 0
        assert parts["bufw"] >= 8 * p.cap * nq
        assert parts["bufp"] >= 4 * p.cap * nq
        assert (parts["sort_w"] == 0) == p.sort_in_smem
        smem = 12 * p.sort_len if p.sort_in_smem else 0
        assert smem + FINISH_STATIC <= 232_448


def test_select_plan_serving_shapes_and_refusals():
    """b=64 at n=1M: 16 chunks a query (1,024 blocks, the card twice over);
    IVF k'=3200 over 16 probed lists: no histogram; a forced buffer below
    kk, k=0, and n past int32 raise."""
    p = _build.select_plan(64, 1_000_000, 2056, SMS)
    assert (p.nchunks, p.cap, p.hist, p.sort_in_smem) == (16, 16384, True,
                                                         True)
    assert not _build.select_plan(64, 16 * 984, 3200, SMS, seg_len=984).hist
    assert _build.select_plan(64, 100_000, 100, SMS, cap=100).cap == 100
    for bad in (dict(kk=0), dict(n=2 ** 31), dict(cap=50)):
        args = dict(nq=4, n=100_000, kk=100, num_sms=SMS) | bad
        with pytest.raises(ValueError):
            _build.select_plan(**args)


# -- the passes, emulated -----------------------------------------------------

def _ord_eq0(s):
    """select_common.cuh's ord_bits_eq0 on float32 scores, as uint64."""
    b = s.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = np.where(b == 0x80000000, 0, b)
    return np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)


def _emulate_select(scores, kk, cap):
    """One query's multi-block select, digit for digit: (the kk best
    packed words, best first; the histogram passes run)."""
    live = np.flatnonzero(scores > -np.inf)
    w = (_ord_eq0(scores[live]) << np.uint64(32)) | \
        (~live.astype(np.uint64) & np.uint64(0xFFFFFFFF))
    hist_passes = 0
    prefix = fixed = np.uint64(0)
    want, shift = kk, 48
    mode = "hist" if scores.size > cap else "compact"
    for _ in range(_build.SELECT_PASSES if mode == "hist" else 1):
        if mode == "hist":
            hist_passes += 1
            under = w[(w & fixed) == prefix]
            if fixed == 0 and under.size <= kk:
                mode = "compact"
                continue
            dig = ((under >> np.uint64(shift)) & np.uint64(0xFFFF)).astype(
                np.int64)
            counts = np.bincount(dig, minlength=1 << 16)[::-1]
            above = np.cumsum(counts) - counts
            d = int(np.argmax(above + counts >= want))
            prefix |= np.uint64((65535 - d) << shift)
            fixed |= np.uint64(0xFFFF << shift)
            want -= int(above[d])
            if kk - want + int(counts[d]) <= cap or shift == 0:
                mode = "compact"
            else:
                shift -= 16
        elif mode == "compact":
            buf = w[(w & fixed) >= prefix]
            assert buf.size <= cap
            mode = "done"
    assert mode == "done"
    # the finish: 11-bit digits below the fixed bits, over the buffer
    if buf.size <= kk:
        thr = np.uint64(0)
    else:
        low = 64 if fixed == 0 else int(np.log2(int(fixed) & -int(fixed)))
        while low > 0:
            width = min(11, low)
            sh = low - width
            under = buf[(buf & fixed) == prefix]
            dig = ((under >> np.uint64(sh)) & np.uint64((1 << width) - 1)
                   ).astype(np.int64)
            counts = np.bincount(dig, minlength=1 << width)[::-1]
            above = np.cumsum(counts) - counts
            d = int(np.argmax(above + counts >= want))
            prefix |= np.uint64(((1 << width) - 1 - d) << sh)
            fixed |= np.uint64(((1 << width) - 1) << sh)
            want -= int(above[d])
            low = sh
            if counts[d] == want:
                break
        thr = prefix
    out = np.sort(buf[buf >= thr])[::-1]
    return out, hist_passes


@pytest.mark.parametrize("case", ["spread", "ties", "signed_zeros", "dead",
                                  "few_live"])
def test_select_passes_emulated(case):
    """The passes' state machine against a sort: spread scores take one
    histogram; equal scores past the buffer take the full-row passes under
    the prefix (every score bit, then key bits); -0.0 ties +0.0; -inf
    entries never compete; fewer live entries than kk keep them all."""
    rng = np.random.default_rng(7)
    n, kk, cap = 70_000, 300, 1024
    s = rng.normal(-3.0, 0.5, n).astype(np.float32)
    if case == "ties":
        s[:] = -1.25
    elif case == "signed_zeros":
        s = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    elif case == "dead":
        s[rng.random(n) < 0.9] = -np.inf
    elif case == "few_live":
        s[:] = -np.inf
        s[rng.choice(n, 100, replace=False)] = 1.0
    got, passes = _emulate_select(s, kk, cap)
    live = np.flatnonzero(s > -np.inf)
    w = (_ord_eq0(s[live]) << np.uint64(32)) | (
        ~live.astype(np.uint64) & np.uint64(0xFFFFFFFF))
    want = np.sort(w)[::-1][:kk]
    np.testing.assert_array_equal(got, want)
    assert passes == {"spread": 1, "ties": 4, "signed_zeros": 4, "dead": 1,
                      "few_live": 1}[case]


# -- the select's plain version and dispatch ----------------------------------

def test_ref_select_topk_matches_a_sort():
    """(score desc, column asc); NaN and -inf never enter; unfilled slots
    (-inf, 0); -0.0 ties +0.0 and keeps its bits; k past n."""
    rng = np.random.default_rng(3)
    s = rng.integers(-4, 4, (5, 40)).astype(np.float32) * 0.5
    s[0, ::3] = np.nan
    s[1, ::2] = -np.inf
    s[2] = np.where(rng.random(40) < 0.5, -0.0, 0.0)
    s[3, :] = -np.inf
    for k in (1, 7, 40, 55):
        vals, ids = ref.ref_select_topk(tensor(s), k)
        for r in range(5):
            keep = np.flatnonzero(s[r] > -np.inf)
            order = keep[np.lexsort((keep, -s[r, keep]))][:k]
            m = order.size
            np.testing.assert_array_equal(ids[r, :m].numpy(), order)
            np.testing.assert_array_equal(
                vals[r, :m].numpy().view(np.uint32),
                s[r, order].view(np.uint32))
            assert torch.isneginf(vals[r, m:]).all()
            assert (ids[r, m:] == 0).all()


# -- B5 mask=: the eligible slots and the member bits -------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_slots_match_numpy_nonzero(seed):
    """The eligible slots (the plain version of the card's builder): flat
    ids of valid * mask > 0.5 in the lists with a member query, ascending
    (numpy.nonzero over the same product); each list's member bits, OR-ed
    over its sources (a routed tail repeats a live id under an empty member
    row; a source no query probed adds nothing)."""
    rng = np.random.default_rng(seed)
    nlist, L, b = 12, 37, 70
    valid = (rng.random((nlist, L)) < 0.8).astype(np.float32)
    mask = (rng.random((nlist, L)) < 0.4).astype(np.float32)
    uniq = np.int32([0, 2, 3, 5, 8, 11, 2, 2])
    member = (rng.random((8, b)) < 0.3).astype(np.float32)
    member[6:] = 0.0           # the routed tail: a live id, no member
    member[1] = 0.0            # a source no query probed
    ids, lbits = ref.ref_ivf_masked_slots(
        *map(tensor, (valid, mask, uniq, member)))
    want_bits = np.zeros((nlist, b), bool)
    for src, lst in enumerate(uniq):
        want_bits[lst] |= member[src] > 0.5
    live = want_bits.any(axis=1)
    want = np.nonzero((((valid * mask) > 0.5) & live[:, None]).reshape(-1))
    np.testing.assert_array_equal(ids.numpy(), want[0])
    bits = lbits.numpy().view(np.uint64)
    for j in range(b):
        got = (bits[:, j // 64] >> np.uint64(j % 64)) & np.uint64(1)
        np.testing.assert_array_equal(got.astype(bool), want_bits[:, j])


# -- B5 mask=: the new kernel's function, composed in plain PyTorch -----------

def _b5_masked(grouped, gsq, valid, uniq, member, q, k, scales, mask):
    """What the tensor-core masked scan computes: over the eligible slots
    of the flattened slab, (2 <x, q>) scale - ||x||^2 (no ||q||^2), -inf
    where the query's member bit of the slot's list is clear, the first k
    by (score desc, flat id asc), unfilled slots (-inf, 0)."""
    nlist, L, d = grouped.shape
    ids, lbits = ref.ref_ivf_masked_slots(valid, mask, uniq, member)
    ids = ids.long()
    rows = grouped.reshape(nlist * L, d)[ids].to(torch.float32)
    s = 2.0 * (q @ rows.T)
    if scales is not None:
        s = s * scales.reshape(-1)[ids]
    s = s - gsq.reshape(-1)[ids]
    j = torch.arange(q.shape[0])
    words = lbits[ids // L][:, j // 64]
    bit = (words >> (j % 64)) & 1
    s = torch.where(bit.T.bool(), s, float("-inf"))
    vals, pos = ref.ref_select_topk(s, k)
    out = torch.where(torch.isneginf(vals), 0,
                      ids[pos.long()] if ids.numel() else pos)
    return vals, out.to(torch.int32)


def _b5_case(dtype, case, rng):
    if dtype == "float32":
        g, sq, valid, _, q, _, _ = ivf_inputs(16, 72, 6, 4, d=32)
        mine, theirs, scales = tensor(g), jnp.asarray(g), None
    else:
        (mine, theirs, scales, sq, valid, _, _, _, q, _,
         _) = _ivf_operands(dtype)
    nlist, max_list = valid.shape
    b = q.shape[0]
    mask = (rng.random((nlist, max_list)) < 0.2).astype(np.float32)
    uniq = np.arange(nlist, dtype=np.int32)
    member = np.ones((nlist, b), np.float32)
    k = 18
    if case == "routed":
        uniq = np.int32([3, 7, 11, 3])
        member = np.ones((4, b), np.float32)
        member[3] = 0.0
    elif case == "random_member":
        member = (rng.random((nlist, b)) < 0.3).astype(np.float32)
    elif case == "zero_mask":
        mask[:] = 0.0
    elif case == "past_eligible":
        mask[:] = 0.0
        mask[2, :5] = 1.0
        mask[9, 10:13] = 1.0
        k = 40
    return mine, theirs, scales, sq, valid, q, mask, uniq, member, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["all_ones", "routed", "random_member",
                                  "zero_mask", "past_eligible"])
def test_b5_masked_design_matches_reference(dtype, case):
    """The masked flat scan of the flattened grouped slab over the eligible
    slots, with no ||q||^2 term and a member test per query, equals B5
    ``mask=``: the port's plain B5 (ids outside near-ties, dead slots
    exactly) and the JAX package's, its Pallas kernel in interpret mode and
    its plain path."""
    rng = np.random.default_rng(11)
    (mine, theirs, scales, sq, valid, q, mask, uniq, member,
     k) = _b5_case(dtype, case, rng)
    ops_args = (tensor(sq), tensor(valid), tensor(uniq), tensor(member),
                tensor(q))
    got = _b5_masked(mine, tensor(sq), tensor(valid), tensor(uniq),
                     tensor(member), tensor(q), k, _opt(scales),
                     tensor(mask))
    want = ref.ref_ivf_score_topk_dedup(mine, *ops_args, k, _opt(scales),
                                        tensor(mask))
    nxt = ref.ref_ivf_score_topk_dedup(mine, *ops_args, k + 1, _opt(scales),
                                       tensor(mask))[0][:, -1]
    _check_masked(want[0].numpy(), want[1].numpy(), got[0], got[1],
                  nxt.numpy())
    live = int((~torch.isneginf(want[0])).sum())
    if case == "zero_mask":
        assert live == 0
    if case == "past_eligible":
        assert 0 < int((~torch.isneginf(want[0])).sum(dim=1).max()) < k
    jargs = (theirs, *map(jnp.asarray, (sq, valid, uniq, member, q)))
    jkw = dict(scales=_opt(scales, jnp.asarray), mask=jnp.asarray(mask))
    for use_pallas in (True, False):
        jv, ji = jops.ivf_score_topk_dedup(*jargs, k, use_pallas=use_pallas,
                                           **jkw)
        _check_masked(jv, ji, got[0], got[1], nxt.numpy())
