"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device
(decided in the ``cuda`` fixture at run time). On the card run
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``. This
file imports no JAX: the card's machine has none.

Tolerances: fused_transform rtol = atol = 1e-5, and bit for bit with the
0/1 partition fold; scan scores (flat and IVF) rtol 1e-5, atol 1e-4 in
every slot with ids equal outside near-ties (the flat scan's dot products
come off the tensor cores, its plain version's are rounded once from
fp64; the list scans sum as the IVF plain versions' fp32 product); the
carried rows and the rows variants' (scores, ids) exactly; rescore atol
1e-5, and the fused re-rank (``rescore_topk``) bit for bit against
``ops.rescore`` + ``topk_first`` + the gather of the ids; the PQ LUT cross
term rtol 1e-5, atol 1e-4 against the plain einsum (and bit for bit
against its column-order sum), the scan LUT and the PQ ADC scans bit for
bit (each side rounds the same fp32 ops in the same order). The bf16 and
int8-scaled scan variants are held the same way as the fp32 scans, their
carried rows bit for bit against the plain dequantized rows, and exactly
on integer codes with power-of-two scales.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.index import pq
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import fused_score_topk as scan
from repro_torch.kernels import ivf_score, pq_lut
from repro_torch.kernels import rescore as rescore_kern
from repro_torch.serve.engine import EngineConfig, FCVIEngine
from test_torch_support import (assert_topk_match,  # noqa: F401
                                candidate_ties, cuda, ivf_inputs, normal,
                                scan_inputs, tensor, tie_inputs,
                                transform_inputs)

pytestmark = pytest.mark.gpu

L2_RTOL, L2_ATOL = 1e-5, 1e-4


@pytest.mark.parametrize("embedding", [False, True])
@pytest.mark.parametrize("n", [1, 300, 4099])
def test_fused_transform_matches_plain(cuda, embedding, n):
    v, f, proj, norms = transform_inputs(n, 64, 8, embedding)
    args = [tensor(a, cuda) for a in (v, f, proj)]
    nargs = [tensor(a, cuda) for a in norms]
    for norm_args in ([], nargs):
        got = ops.fused_transform(*args, 1.5, *norm_args)
        want = ref.ref_fused_transform(*args, 1.5, *norm_args)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if not embedding:  # the 0/1 fold is exact: bit for bit
        assert torch.equal(ops.fused_transform(*args, 1.5),
                           ref.ref_fused_transform(*args, 1.5))


@pytest.mark.parametrize("n,b,k,d", [(1000, 5, 10, 64), (1000, 5, 88, 64),
                                     (1000, 70, 300, 64), (256, 3, 256, 64),
                                     (5000, 17, 1500, 64), (3000, 2, 2048, 64),
                                     (2000, 9, 88, 128), (1000, 5, 88, 30)])
def test_score_topk_matches_plain(cuda, n, b, k, d):
    """Ragged corpus and query tiles, widths up to the 2048 limit, and a
    width d that is no multiple of 4 (the kernel's scalar staging path)."""
    x, sq, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    vals, ids = ops.score_topk(x, sq, q, k)
    rv, ri = ref.ref_score_topk(x, sq, q, k)
    nxt = None
    if k < n:
        nxt = ref.ref_score_topk(x, sq, q, k + 1)[0][:, -1].cpu()
    assert_topk_match(rv.cpu(), ri.cpu(), vals.cpu(), ids.cpu(),
                      rtol=L2_RTOL, atol=L2_ATOL, next_vals=nxt)
    out = ops.score_topk_rows(x, sq, pv, pf, q, k)
    assert torch.equal(out[0], vals) and torch.equal(out[1], ids)
    idx = ids.long()
    assert torch.equal(out[2], x[idx])
    assert torch.equal(out[3], pv[idx])
    assert torch.equal(out[4], pf[idx])


def test_score_topk_ties_keep_first_occurrence(cuda):
    x, sq, q = (tensor(a, cuda) for a in tie_inputs())
    vals, ids = ops.score_topk(x, sq, q, 40)
    rv, ri = ref.ref_score_topk(x, sq, q, 40)
    assert torch.equal(vals, rv) and torch.equal(ids, ri)


def test_rescore_matches_plain(cuda):
    rng = np.random.default_rng(3)
    args = [tensor(a, cuda) for a in (normal(rng, 5, 80, 64),
                                      normal(rng, 5, 80, 8),
                                      normal(rng, 5, 64), normal(rng, 5, 8))]
    torch.testing.assert_close(ops.rescore(*args, 0.6),
                               ref.ref_rescore(*args, 0.6), rtol=0, atol=1e-5)


def test_wrappers_count_launches_and_check_inputs(cuda):
    _build.reset_launch_counts()
    x, sq, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(300, 3))
    ops.score_topk(x, sq, q, 10)
    ops.score_topk_rows(x, sq, pv, pf, q, 10)
    assert _build.launch_counts() == {"score_topk": 1, "score_topk_rows": 1}
    with pytest.raises(ValueError):
        ops.score_topk(x.double(), sq, q, 10)
    with pytest.raises(ValueError):
        ops.score_topk(x, sq, q, 301)
    assert _build.launch_counts() == {"score_topk": 1, "score_topk_rows": 1}


def _ivf_check(got, want, want_next):
    """Kernel (vals, ids) against the plain version's, plus its (k+1)-th
    scores for the near-tie rule (None when k covers every candidate)."""
    nxt = None if want_next is None else want_next[0][:, -1].cpu()
    assert_topk_match(want[0].cpu(), want[1].cpu(), got[0].cpu(),
                      got[1].cpu(), rtol=L2_RTOL, atol=L2_ATOL,
                      next_vals=nxt)


@pytest.mark.parametrize("nlist,max_list,b,nprobe,k,d", [
    (16, 40, 5, 4, 10, 64), (32, 264, 9, 8, 80, 64),
    (64, 136, 70, 16, 320, 128), (8, 24, 3, 8, 200, 30),
    (16, 200, 4, 16, 2048, 64)])
def test_ivf_kernels_match_plain(cuda, nlist, max_list, b, nprobe, k, d):
    """B5, B6 and B7 against their plain versions: an empty list, a valid
    mask that is no prefix, k beyond the live candidates (dead slots), a
    width that is no multiple of 4, and k at the 2048 limit."""
    g, gsq, valid, probes, q, pv, pf = (
        tensor(a, cuda) for a in ivf_inputs(nlist, max_list, b, nprobe, d=d))
    uniq, member = ops.dedup_probes(probes, nlist)
    total = nlist * max_list

    def nxt(fn, *args):
        return fn(*args, k + 1) if k < total else None

    dedup_args = (g, gsq, valid, uniq, member, q)
    got = ops.ivf_score_topk_dedup(*dedup_args, k)
    _ivf_check(got, ref.ref_ivf_score_topk_dedup(*dedup_args, k),
               nxt(ref.ref_ivf_score_topk_dedup, *dedup_args))
    out = ops.ivf_score_topk_dedup_rows(*dedup_args, pv, pf, k)
    assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])
    dead = torch.isneginf(got[0])[..., None]
    idx = got[1].long()
    assert torch.equal(out[2], torch.where(dead, 0.0, pv.reshape(-1, d)[idx]))
    assert torch.equal(out[3], torch.where(dead, 0.0,
                                           pf.reshape(-1, pf.shape[-1])[idx]))
    batch_args = (g, gsq, valid, probes, q)
    got = ops.ivf_score_topk_batch(*batch_args, k)
    _ivf_check(got, ref.ref_ivf_score_topk_batch(*batch_args, k),
               nxt(ref.ref_ivf_score_topk_batch, *batch_args))
    one = ops.ivf_score_topk(g, gsq, valid, probes[1], q[1], k)
    _ivf_check((one[0][None], one[1][None]), (got[0][1:2], got[1][1:2]), None)


def test_ivf_kernels_tie_orders_and_dense_member(cuda):
    """Exact ties (integer data): B5 keeps the smaller flat id, B7 the
    earlier probe position (probes out of list order, one list probed twice
    by query 0); a dense member matrix over every list, as the mask plan
    will pass it, takes every list's partial."""
    g, gsq, valid, probes, q, _, _ = (
        tensor(a, cuda) for a in ivf_inputs(12, 48, 6, 5, d=16, ints=True))
    probes[0, 4] = probes[0, 1]
    for k in (30, 150):
        uniq, member = ops.dedup_probes(probes, 12)
        args = (g, gsq, valid, uniq, member, q)
        vals, ids = ops.ivf_score_topk_dedup(*args, k)
        rv, ri = ref.ref_ivf_score_topk_dedup(*args, k)
        assert torch.equal(vals, rv) and torch.equal(ids, ri)
        assert (vals[:, 1:] == vals[:, :-1]).any()   # the data really ties
        vals, ids = ops.ivf_score_topk_batch(g, gsq, valid, probes, q, k)
        rv, ri = ref.ref_ivf_score_topk_batch(g, gsq, valid, probes, q, k)
        assert torch.equal(vals, rv) and torch.equal(ids, ri)
        every = torch.arange(12, dtype=torch.int32, device=cuda)
        dense = torch.ones((12, 6), device=cuda)
        args = (g, gsq, valid, every, dense, q)
        vals, ids = ops.ivf_score_topk_dedup(*args, k)
        rv, ri = ref.ref_ivf_score_topk_dedup(*args, k)
        assert torch.equal(vals, rv) and torch.equal(ids, ri)


def test_ivf_wrappers_count_launches_and_check_inputs(cuda):
    g, gsq, valid, probes, q, pv, pf = (
        tensor(a, cuda) for a in ivf_inputs(8, 16, 3, 2))
    uniq, member = ops.dedup_probes(probes, 8)
    _build.reset_launch_counts()
    ops.ivf_score_topk_dedup(g, gsq, valid, uniq, member, q, 5)
    ops.ivf_score_topk_dedup_rows(g, gsq, valid, uniq, member, q, pv, pf, 5)
    ops.ivf_score_topk_batch(g, gsq, valid, probes, q, 5)
    want = {"ivf_score_topk_dedup": 1, "ivf_score_topk_dedup_rows": 1,
            "ivf_score_topk_batch": 1}
    assert _build.launch_counts() == want
    for bad in (lambda: ops.ivf_score_topk_dedup(g, gsq, valid, uniq.long(),
                                                 member, q, 5),
                lambda: ops.ivf_score_topk_dedup(g, gsq, valid, uniq,
                                                 member.T.contiguous(), q, 5),
                lambda: ops.ivf_score_topk_batch(g, gsq, valid, probes, q,
                                                 0)):
        with pytest.raises(ValueError):
            bad()
    assert _build.launch_counts() == want


def test_ivf_engine_on_card_matches_cpu_engine(cuda):
    """The IVF serving path through the kernels, both step variants, the
    delta tier and compaction, against the plain path on the same state."""
    corpus = make_corpus(CorpusSpec(n=4000, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 100, seed=3)
    fcfg = fcvi.FCVIConfig(backend="ivf", nlist=32, nprobe=6)
    gpu_ix = fcvi.build(corpus.vectors, corpus.filters, fcfg, device=cuda)
    cpu_ix = fcvi.index_from_state(fcfg, fcvi.index_state(gpu_ix),
                                   device="cpu")
    rng = np.random.default_rng(4)
    new_v, new_f = normal(rng, 300, 64), corpus.filters[:300]
    for gather_free in (True, False):
        cfg = EngineConfig(k=10, batch_size=32, escalate_margin=0.05,
                           gather_free=gather_free)
        engines = [FCVIEngine(gpu_ix, cfg, device=cuda),
                   FCVIEngine(cpu_ix, EngineConfig(**vars(cfg)),
                              device="cpu")]
        _build.reset_launch_counts()
        for e in engines:
            e.insert(new_v, new_f)
        (gs, gi), (cs, ci) = (e.search(q, fq) for e in engines)
        assert_topk_match(cs, ci, gs, gi, rtol=0, atol=1e-5)
        assert engines[0].stats.escalations == engines[1].stats.escalations
        counts = _build.launch_counts()
        scan = ("ivf_score_topk_dedup_rows" if gather_free
                else "ivf_score_topk_dedup")
        for name in ("fused_transform", "score_topk", scan, "rescore"):
            assert counts.get(name, 0) > 0, counts
        assert counts.get("rescore_wide", 0) == 0, counts
    engines[0].compact()
    assert engines[0].index.size == 4300
    s, i = engines[0].search(q, fq)
    assert np.isfinite(s).all() and ((i >= 0) & (i < 4300)).all()


def test_engine_on_card_matches_cpu_engine(cuda):
    """The whole serving path through the kernels (delta tier and
    compaction included) against the plain path on the same state."""
    corpus = make_corpus(CorpusSpec(n=4000, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 100, seed=3)
    cfg = EngineConfig(k=10, batch_size=32, escalate_margin=0.05,
                       compact_threshold=600)
    gpu_ix = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(),
                        device=cuda)
    cpu_ix = fcvi.index_from_state(gpu_ix.config, fcvi.index_state(gpu_ix),
                                   device="cpu")
    engines = [FCVIEngine(gpu_ix, cfg, device=cuda),
               FCVIEngine(cpu_ix, EngineConfig(**vars(cfg)), device="cpu")]
    _build.reset_launch_counts()
    rng = np.random.default_rng(4)
    new_v, new_f = normal(rng, 700, 64), corpus.filters[:700]
    for step in range(3):
        (gs, gi), (cs, ci) = (e.search(q, fq) for e in engines)
        assert_topk_match(cs, ci, gs, gi, rtol=0, atol=1e-5)
        for e in engines:
            e.insert(new_v[step * 300:(step + 1) * 300],
                     new_f[step * 300:(step + 1) * 300])
    assert engines[0].stats.compactions == engines[1].stats.compactions == 1
    assert engines[0].stats.escalations == engines[1].stats.escalations > 0
    counts = _build.launch_counts()
    for name in ("fused_transform", "score_topk_rows", "rescore"):
        assert counts.get(name, 0) > 0, counts
    assert counts.get("rescore_wide", 0) == 0, counts


@pytest.mark.parametrize("b,m,dsub,ksub", [(64, 8, 16, 256), (1, 8, 16, 256),
                                           (5, 4, 8, 32), (130, 2, 4, 1024),
                                           (3, 3, 7, 100), (4, 2, 64, 4096)])
def test_pq_lut_qdot_matches_plain(cuda, b, m, dsub, ksub):
    """B8 at the serving shapes, b = 1, more queries than one block holds,
    a codebook past 48 KB of shared memory, an odd dsub, and a (4096, 64)
    codebook (1 MB, past a block's shared memory: its codewords are tiled)
    that the card once refused. Each slot within the L2 tolerance of the
    plain einsum, and bit-equal to the column-order sum of rounded
    products that the kernel computes."""
    rng = np.random.default_rng(b + ksub)
    qs, cb = (tensor(a, cuda) for a in (normal(rng, b, m, dsub),
                                        normal(rng, m, ksub, dsub)))
    got = ops.pq_lut_qdot(qs, cb)
    torch.testing.assert_close(got, ref.ref_pq_lut_qdot(qs, cb),
                               rtol=L2_RTOL, atol=L2_ATOL)
    assert torch.equal(got, ref.in_order_sum(qs[:, :, None, :] * cb[None]))


def _scan_luts_case(case, dev):
    """(queries (b, d), codebooks, centres, coarse_dot, cb_sq) for one case
    of ``test_pq_scan_luts_bit_equal_to_plain``."""
    b, m, ncoarse, ksub, dsub = SCAN_LUTS_CASES[case]
    rng = np.random.default_rng(ncoarse + ksub + dsub)
    q = normal(rng, b, m * dsub)
    cb = normal(rng, m, ksub, dsub)
    cen = normal(rng, ncoarse, m * dsub)
    if case == "signed_zeros":      # -0.0 and +0.0 entries, zero residuals
        q[:, ::2] = -0.0
        cb[:, ::3] = -0.0
        cen[0] = q[0]
        cen[1, ::2] = 0.0
    if case == "large_centres":     # residual norms near 1e10 and 1e-2
        cen *= 1e4
        cen[0] = q[0] + 1e-3
    q, cb, cen = (tensor(a, dev) for a in (q, cb, cen))
    cdot = torch.einsum("cmd,mkd->cmk", cen.reshape(ncoarse, m, dsub), cb)
    return q, cb, cen, cdot.contiguous(), torch.sum(cb * cb, dim=-1)


# (b, M, ncoarse, ksub, dsub): the serving shape; each of b in {1, 16,
# 64}, ncoarse in {1, 32, 1024}, ksub in {16, 256, 4096} and dsub in {4,
# 16, 120}; a codebook past shared memory (4096 x 64 and 4096 x 120); a
# ksub that is no multiple of 4 (scalar stores); -0.0; large centres.
# Each table at most 537 MB.
SCAN_LUTS_CASES = {
    "serving": (64, 8, 32, 256, 16),
    "b16_ncoarse1024_ksub16_dsub4": (16, 8, 1024, 16, 4),
    "b64_ncoarse1024": (64, 8, 1024, 256, 16),
    "b1_ncoarse1_ksub4096_dsub120": (1, 2, 1, 4096, 120),
    "codebook_4096x64": (16, 4, 32, 4096, 64),
    "ragged": (5, 3, 7, 13, 5),
    "signed_zeros": (9, 4, 3, 24, 8),
    "large_centres": (16, 8, 32, 256, 16),
}


@pytest.mark.parametrize("case", list(SCAN_LUTS_CASES))
def test_pq_scan_luts_bit_equal_to_plain(cuda, case):
    """The scan LUT kernel bit for bit against its plain version (each
    sum in column order of rounded products, then the three element-wise
    steps, each rounded as torch rounds them), one launch a call; -0.0
    keeps its sign where the plain version's does."""
    args = _scan_luts_case(case, cuda)
    b, m, ncoarse, ksub, _ = SCAN_LUTS_CASES[case]
    _build.reset_launch_counts()
    got = ops.pq_scan_luts(*args)
    assert _build.launch_counts() == {"pq_scan_luts": 1}
    want = ref.ref_pq_scan_luts(*args)
    assert got.shape == (b, m, ncoarse * ksub)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_pq_scan_luts_refuses_and_plans(cuda):
    """Operands the kernel does not take raise before a launch; the plan
    fills the card at the serving batch and the escalation's."""
    q, cb, cen, cdot, cbsq = _scan_luts_case("serving", cuda)
    _build.reset_launch_counts()
    for bad in (lambda: ops.pq_scan_luts(q[:, :64], cb, cen, cdot, cbsq),
                lambda: ops.pq_scan_luts(q, cb, cen, cdot[:, :4], cbsq),
                lambda: ops.pq_scan_luts(q, cb, cen.double(), cdot, cbsq),
                lambda: ops.pq_scan_luts(q, cb.transpose(1, 2), cen, cdot,
                                         cbsq)):
        with pytest.raises(ValueError):
            bad()
    assert _build.launch_counts() == {}
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for b in (64, 16, 1):
        p = pq_lut.luts_plan(b, 8, 256, 16, 32, sms)
        assert p.blocks * 8 >= sms and p.vec and p.kc == 256


@pytest.mark.parametrize("n,m,k,b,dtype", [
    (1000, 8, 8192, 64, torch.int32), (4099, 8, 256, 1, torch.uint8),
    (300, 4, 32, 9, torch.uint8), (70001, 8, 8192, 17, torch.int32),
    (1, 8, 256, 3, torch.int32)])
def test_pq_score_kernels_match_plain(cuda, n, m, k, b, dtype):
    """B9 and B10 bit for bit: kernel and plain version both add the M LUT
    values left to right in fp32. Ragged n and b, uint8 and int32 codes."""
    rng = np.random.default_rng(n + b)
    codes = tensor(rng.integers(0, k, (n, m)), cuda).to(dtype)
    luts = tensor(rng.random((b, m, k)).astype(np.float32), cuda)
    got = ops.pq_score_batch(codes, luts)
    assert torch.equal(got, ref.ref_pq_score_batch(codes, luts))
    one = ops.pq_score(codes, luts[-1])
    assert torch.equal(one, ref.ref_pq_score(codes, luts[-1]))
    assert torch.equal(one, got[-1])


def test_pq_wrappers_count_launches_and_check_inputs(cuda):
    rng = np.random.default_rng(0)
    codes = tensor(rng.integers(0, 64, (500, 4)).astype(np.int32), cuda)
    luts = tensor(rng.random((3, 4, 64)).astype(np.float32), cuda)
    qs, cb = tensor(normal(rng, 3, 4, 8), cuda), tensor(normal(rng, 4, 64, 8),
                                                        cuda)
    _build.reset_launch_counts()
    ops.pq_lut_qdot(qs, cb)
    ops.pq_score_batch(codes, luts)
    ops.pq_score(codes, luts[0])
    ops.pq_scan_luts(qs.reshape(3, 32), cb, normal_t(rng, (2, 32), cuda),
                     torch.zeros((2, 4, 64), device=cuda),
                     torch.zeros((4, 64), device=cuda))
    want = {"pq_lut_qdot": 1, "pq_score_batch": 1, "pq_score": 1,
            "pq_scan_luts": 1}
    assert _build.launch_counts() == want
    for bad in (lambda: ops.pq_score_batch(codes.long(), luts),
                lambda: ops.pq_score_batch(codes, luts[:, :3]),
                lambda: ops.pq_score_batch(codes, luts.transpose(1, 2)),
                lambda: ops.pq_score_batch(   # a row's codes past the smem
                    torch.zeros((10, 4096), dtype=torch.int32, device=cuda),
                    torch.zeros((3, 4096, 4), device=cuda)),
                lambda: ops.pq_lut_qdot(qs, cb[:2]),
                lambda: ops.pq_scan_luts(qs, cb, cb, cb, cb)):
        with pytest.raises(ValueError):
            bad()
    assert _build.launch_counts() == want


def normal_t(rng, shape, dev):
    return tensor(normal(rng, *shape), dev)


def test_pq_engine_on_card_matches_cpu_engine(cuda):
    """The PQ serving path through B1, the scan LUT (B8 fused with the
    rest of the table), the fused ADC scan + top-k, B4 and (delta tier)
    B2, with escalation and compaction, against the plain path on the same
    state; queries at a candidate near-tie are left out. B8 alone and B9
    (pq_score_batch) are off the serving path."""
    corpus = make_corpus(CorpusSpec(n=4000, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 100, seed=3)
    fcfg = fcvi.FCVIConfig(backend="pq", pq_ksub=64, pq_coarse=8)
    gpu_ix = fcvi.build(corpus.vectors, corpus.filters, fcfg, device=cuda)
    cpu_ix = fcvi.index_from_state(fcfg, fcvi.index_state(gpu_ix),
                                   device="cpu")
    qn, fqn = cpu_ix.transform.normalize(tensor(q), tensor(fq))
    q_t = cpu_ix.transform.apply_normalized(qn, fqn)
    keep = np.ones(len(q), bool)
    for kp in (80, 320):
        vals = pq.search(cpu_ix.backend, q_t, kp + 1)[0]
        keep &= ~candidate_ties(vals, kp)
    cfg = EngineConfig(k=10, batch_size=32, escalate_margin=0.05)
    engines = [FCVIEngine(gpu_ix, cfg, device=cuda),
               FCVIEngine(cpu_ix, EngineConfig(**vars(cfg)), device="cpu")]
    _build.reset_launch_counts()
    new_v = normal(np.random.default_rng(4), 300, 64)
    for e in engines:
        e.insert(new_v, corpus.filters[:300])
    (gs, gi), (cs, ci) = (e.search(q, fq) for e in engines)
    assert_topk_match(cs[keep], ci[keep], gs[keep], gi[keep], rtol=0,
                      atol=1e-5)
    assert engines[0].stats.escalations == engines[1].stats.escalations > 0
    counts = _build.launch_counts()
    for name in ("fused_transform", "pq_scan_luts", "pq_score_topk",
                 "rescore", "score_topk"):
        assert counts.get(name, 0) > 0, counts
    assert counts.get("pq_score_batch", 0) == 0, counts
    assert counts.get("pq_lut_qdot", 0) == 0, counts
    assert counts.get("rescore_wide", 0) == 0, counts
    engines[0].compact()
    assert engines[0].index.size == 4300
    s, i = engines[0].search(q, fq)
    assert np.isfinite(s).all() and ((i >= 0) & (i < 4300)).all()


# -- the storage ladder: bf16 and int8-scaled variants of B2, B3, B5-B7 -----

def _stored(x, dtype, misalign=False):
    """(rows stored at ``dtype``, per-row scales or None, squared norms of
    the stored rows) of fp32 rows ``x`` on the card. ``misalign`` places
    the rows 8 bytes past a 16-byte boundary, so the kernels take their
    scalar staging path."""
    from repro_torch.index import quant

    if dtype == "int8":
        rows, scales = quant.quantize_rows(x)
        sq = quant.sq_norms_of(rows, scales)
    else:
        rows, scales = x.to(torch.bfloat16), None
        sq = torch.sum(rows.float() ** 2, dim=-1)
    if misalign:
        shift = 8 // rows.element_size()
        buf = torch.empty(rows.numel() + shift, dtype=rows.dtype,
                          device=rows.device)
        rows = buf[shift:].view(rows.shape).copy_(rows)
    return rows, scales, sq


def _dequant(rows, scales):
    out = rows.float()
    return out if scales is None else out * scales[..., None]


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("n,b,k,d,misalign", [
    (1000, 5, 10, 64, False), (1000, 70, 300, 64, False),
    (5000, 17, 1500, 128, False), (2000, 9, 88, 128, True),
    (1000, 5, 88, 30, False), (1000, 5, 40, 40, False)])
def test_score_topk_variants_match_plain(cuda, dtype, n, b, k, d, misalign):
    """B2/B3 at bf16 and int8 (scaled): ragged tiles, a row width that is no
    multiple of 16 bytes (d=30; d=40 for int8) and a misaligned corpus (the
    scalar staging path). B3's (vals, ids) equal B2's bit for bit and its
    rows equal the plain dequantized rows bit for bit."""
    x, _, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    rows, scales, sq = _stored(x, dtype, misalign)
    vals, ids = ops.score_topk(rows, sq, q, k, scales=scales)
    rv, ri = ref.ref_score_topk(rows, sq, q, k, scales)
    nxt = None
    if k < n:
        nxt = ref.ref_score_topk(rows, sq, q, k + 1, scales)[0][:, -1].cpu()
    assert_topk_match(rv.cpu(), ri.cpu(), vals.cpu(), ids.cpu(),
                      rtol=L2_RTOL, atol=L2_ATOL, next_vals=nxt)
    out = ops.score_topk_rows(rows, sq, pv, pf, q, k, scales=scales)
    assert torch.equal(out[0], vals) and torch.equal(out[1], ids)
    idx = ids.long()
    assert torch.equal(out[2], _dequant(rows, scales)[idx])
    assert torch.equal(out[3], pv[idx]) and torch.equal(out[4], pf[idx])


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("nlist,max_list,b,nprobe,k,d", [
    (16, 40, 5, 4, 10, 64), (64, 136, 70, 16, 320, 128),
    (8, 24, 3, 8, 200, 30), (16, 200, 4, 16, 2048, 64)])
def test_ivf_variants_match_plain(cuda, dtype, nlist, max_list, b, nprobe, k,
                                  d):
    """B5, B6 and B7 on bf16 and int8 slabs (with grouped scales) against
    their plain versions, as ``test_ivf_kernels_match_plain`` holds fp32."""
    g, _, valid, probes, q, pv, pf = (
        tensor(a, cuda) for a in ivf_inputs(nlist, max_list, b, nprobe, d=d))
    flat, scales, sq = _stored(g.reshape(-1, d), dtype)
    grouped = flat.reshape(nlist, max_list, d)
    gsq = sq.reshape(nlist, max_list)
    gsc = None if scales is None else scales.reshape(nlist, max_list)
    uniq, member = ops.dedup_probes(probes, nlist)
    total = nlist * max_list

    def nxt(fn, *args):
        return fn(*args, k + 1, gsc) if k < total else None

    ded = (grouped, gsq, valid, uniq, member, q)
    got = ops.ivf_score_topk_dedup(*ded, k, scales=gsc)
    _ivf_check(got, ref.ref_ivf_score_topk_dedup(*ded, k, gsc),
               nxt(ref.ref_ivf_score_topk_dedup, *ded))
    out = ops.ivf_score_topk_dedup_rows(*ded, pv, pf, k, scales=gsc)
    assert torch.equal(out[0], got[0]) and torch.equal(out[1], got[1])
    dead = torch.isneginf(got[0])[..., None]
    idx = got[1].long()
    assert torch.equal(out[2], torch.where(dead, 0.0, pv.reshape(-1, d)[idx]))
    assert torch.equal(out[3], torch.where(dead, 0.0,
                                           pf.reshape(-1, pf.shape[-1])[idx]))
    bat = (grouped, gsq, valid, probes, q)
    got = ops.ivf_score_topk_batch(*bat, k, scales=gsc)
    _ivf_check(got, ref.ref_ivf_score_topk_batch(*bat, k, gsc),
               nxt(ref.ref_ivf_score_topk_batch, *bat))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_ivf_variant_tie_orders(cuda, dtype):
    """Integer codes with power-of-two scales: exact scores, so B5 and B7
    equal their plain versions bit for bit, tie orders included."""
    g, _, valid, probes, q, _, _ = (
        tensor(a, cuda) for a in ivf_inputs(12, 48, 6, 5, d=16, ints=True))
    probes[0, 4] = probes[0, 1]
    grouped = g.to(torch.int8 if dtype == "int8" else torch.bfloat16)
    gsc = None
    if dtype == "int8":
        gen = torch.Generator(device=cuda).manual_seed(0)
        pick = torch.randint(0, 4, (12, 48), device=cuda, generator=gen)
        gsc = torch.tensor([0.25, 0.5, 1.0, 2.0], device=cuda)[pick]
    gsq = torch.sum(_dequant(grouped, gsc) ** 2, dim=-1)
    uniq, member = ops.dedup_probes(probes, 12)
    for k in (30, 150):
        args = (grouped, gsq, valid, uniq, member, q)
        vals, ids = ops.ivf_score_topk_dedup(*args, k, scales=gsc)
        rv, ri = ref.ref_ivf_score_topk_dedup(*args, k, gsc)
        assert torch.equal(vals, rv) and torch.equal(ids, ri)
        assert (vals[:, 1:] == vals[:, :-1]).any()   # the data really ties
        args = (grouped, gsq, valid, probes, q)
        vals, ids = ops.ivf_score_topk_batch(*args, k, scales=gsc)
        rv, ri = ref.ref_ivf_score_topk_batch(*args, k, gsc)
        assert torch.equal(vals, rv) and torch.equal(ids, ri)


def test_variant_counters_and_refusals(cuda):
    """Each stored dtype counts on its own counter; a dtype the kernels do
    not take raises before a launch, and nothing is cast quietly."""
    x, sq, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(300, 3))
    g, gsq, valid, probes, gq, gpv, gpf = (
        tensor(a, cuda) for a in ivf_inputs(8, 16, 3, 2))
    uniq, member = ops.dedup_probes(probes, 8)
    _build.reset_launch_counts()
    want = {}
    for dtype, suffix in (("bfloat16", "_bf16"), ("int8", "_int8")):
        rows, scales, rsq = _stored(x, dtype)
        ops.score_topk(rows, rsq, q, 10, scales=scales)
        ops.score_topk_rows(rows, rsq, pv, pf, q, 10, scales=scales)
        flat, gs, fsq = _stored(g.reshape(-1, g.shape[-1]), dtype)
        grouped, gsq2 = flat.reshape(g.shape), fsq.reshape(gsq.shape)
        gsc = None if gs is None else gs.reshape(gsq.shape)
        ded = (grouped, gsq2, valid, uniq, member, gq)
        ops.ivf_score_topk_dedup(*ded, 5, scales=gsc)
        ops.ivf_score_topk_dedup_rows(*ded, gpv, gpf, 5, scales=gsc)
        ops.ivf_score_topk_batch(grouped, gsq2, valid, probes, gq, 5,
                                 scales=gsc)
        for name in ("score_topk", "score_topk_rows", "ivf_score_topk_dedup",
                     "ivf_score_topk_dedup_rows", "ivf_score_topk_batch"):
            want[name + suffix] = 1
    assert _build.launch_counts() == want
    rows, scales, rsq = _stored(x, "int8")
    for bad in (lambda: ops.score_topk(x.half(), sq, q, 10),
                lambda: ops.score_topk(rows, rsq, q, 10,
                                       scales=scales.double()),
                lambda: ops.score_topk(rows, rsq, q, 10, scales=scales[:5]),
                lambda: ops.ivf_score_topk_dedup(g.half(), gsq, valid, uniq,
                                                 member, gq, 5),
                lambda: ops.ivf_score_topk_batch(
                    g, gsq, valid, probes, gq, 5, scales=gsq[:2])):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError):
        ops.rescore(*(t.half() for t in (pv[:3, None], pf[:3, None], q,
                                         pf[:3])), 0.5)
    assert _build.launch_counts() == want


def test_rescore_takes_bf16_tiles(cuda):
    rng = np.random.default_rng(3)
    args = [tensor(a, cuda) for a in (normal(rng, 5, 80, 64),
                                      normal(rng, 5, 80, 8),
                                      normal(rng, 5, 64), normal(rng, 5, 8))]
    half = [a.to(torch.bfloat16) for a in args]
    got = ops.rescore(*half, 0.6)
    assert got.dtype == torch.float32
    assert torch.equal(got, ops.rescore(*(a.float() for a in half), 0.6))
    torch.testing.assert_close(got, ref.ref_rescore(*half, 0.6), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_int8_engine_on_card_matches_cpu_engine(cuda, backend):
    """An int8 index served through the scaled kernels (B2/B3, or B2 and
    B5/B6) with its int8 delta tier, against a CPU engine on the same
    state; then compaction, which re-quantizes the grown corpus. Flat
    compacts the same way on both devices and is compared again; IVF
    re-trains its k-means from generators that differ across devices, so
    only its card engine's results are checked for range."""
    corpus = make_corpus(CorpusSpec(n=4000, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 100, seed=3)
    extra = dict(backend="ivf", nlist=32, nprobe=6) if backend == "ivf" else {}
    fcfg = fcvi.FCVIConfig(storage_dtype="int8", **extra)
    gpu_ix = fcvi.build(corpus.vectors, corpus.filters, fcfg, device=cuda)
    assert gpu_ix.backend.vectors.dtype == torch.int8
    cpu_ix = fcvi.index_from_state(fcfg, fcvi.index_state(gpu_ix),
                                   device="cpu")
    cfg = EngineConfig(k=10, batch_size=32, escalate_margin=0.05,
                       compact_threshold=600)
    engines = [FCVIEngine(gpu_ix, cfg, device=cuda),
               FCVIEngine(cpu_ix, EngineConfig(**vars(cfg)), device="cpu")]
    _build.reset_launch_counts()
    rng = np.random.default_rng(4)
    new_v, new_f = normal(rng, 700, 64), corpus.filters[:700]
    for step in range(2):
        for e in engines:
            e.insert(new_v[step * 300:(step + 1) * 300],
                     new_f[step * 300:(step + 1) * 300])
        (gs, gi), (cs, ci) = (e.search(q, fq) for e in engines)
        if step == 0 or backend == "flat":
            assert_topk_match(cs, ci, gs, gi, rtol=0, atol=1e-5)
            assert (engines[0].stats.escalations
                    == engines[1].stats.escalations)
    assert engines[0].stats.compactions == engines[1].stats.compactions == 1
    assert engines[0].index.backend.vectors.dtype == torch.int8
    assert np.isfinite(gs).all() and ((gi >= 0) & (gi < 4600)).all()
    counts = _build.launch_counts()
    scan = ("ivf_score_topk_dedup_rows_int8" if backend == "ivf"
            else "score_topk_rows_int8")
    for name in ("fused_transform", scan, "rescore"):
        assert counts.get(name, 0) > 0, counts


# -- the filter algebra: B2's masked variants, B5's mask=, predicate search --

def _row_mask(n, kind, cuda, seed=0):
    """(n,) float 0/1 row masks: ``sparse`` (about 2% eligible, scattered),
    ``blocks`` (eligible rows in a few 128-row tiles only, so most tiles
    are skipped), ``few`` (3 eligible rows), ``none`` and ``all``."""
    rng = np.random.default_rng(seed)
    m = np.zeros(n, np.float32)
    if kind == "sparse":
        m[rng.random(n) < 0.02] = 1.0
    elif kind == "blocks":
        for t in rng.choice(max(1, n // 128), size=3, replace=False):
            m[t * 128:(t + 1) * 128] = (rng.random(128) < 0.5)
    elif kind == "few":
        m[rng.choice(n, 3, replace=False)] = 1.0
    elif kind == "all":
        m[:] = 1.0
    return tensor(m, cuda)


def _masked_check(got, want, want_next):
    """Live slots as the unmasked scans are held (scores within the L2
    tolerance, ids equal outside near-ties); dead slots exactly (-inf, 0)
    on both sides, at the same places."""
    dead = torch.isneginf(want[0])
    assert torch.equal(torch.isneginf(got[0]), dead)
    assert (got[1][dead] == 0).all() and (want[1][dead] == 0).all()
    nxt = None if want_next is None else want_next[0][:, -1].cpu()
    assert_topk_match(want[0].cpu(), want[1].cpu(), got[0].cpu(),
                      got[1].cpu(), rtol=L2_RTOL, atol=L2_ATOL,
                      next_vals=nxt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,b,k,d,kind", [
    (3000, 5, 18, 64, "sparse"), (3000, 64, 128, 128, "sparse"),
    (5000, 17, 40, 64, "blocks"), (1000, 9, 18, 30, "few"),
    (1000, 5, 18, 64, "none"), (4000, 3, 2048, 64, "all")])
def test_score_topk_masked_matches_plain(cuda, dtype, n, b, k, d, kind):
    """B2 masked (fp32, bf16) and masked+scaled (int8) against the plain
    version: selective masks, tiles with no eligible row (skipped), fewer
    eligible rows than k (dead slots (-inf, 0)), an empty mask, and k at
    the 2048 limit."""
    x, _, q, _, _ = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    if dtype == "float32":
        rows, scales, sq = x, None, torch.sum(x * x, dim=-1)
    else:
        rows, scales, sq = _stored(x, dtype)
    mask = _row_mask(n, kind, cuda)
    got = ops.score_topk(rows, sq, q, k, scales=scales, mask=mask)
    want = ref.ref_score_topk(rows, sq, q, k, scales, mask)
    nxt = (ref.ref_score_topk(rows, sq, q, k + 1, scales, mask)
           if k < n else None)
    _masked_check(got, want, nxt)
    if kind == "all":   # an all-ones mask changes no bit of the scan
        plain = ops.score_topk(rows, sq, q, k, scales=scales)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_score_topk_masked_ties_exact(cuda):
    """Integer rows with duplicates: exact scores, so the masked scan
    equals its plain version bit for bit, tie order included."""
    x, sq, q = (tensor(a, cuda) for a in tie_inputs())
    mask = _row_mask(x.shape[0], "sparse", cuda, seed=1)
    mask[: x.shape[0] // 2] = 1.0
    for k in (18, 200):
        vals, ids = ops.score_topk(x, sq, q, k, mask=mask)
        rv, ri = ref.ref_score_topk(x, sq, q, k, mask=mask)
        assert torch.equal(vals, rv) and torch.equal(ids, ri)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [18, 300])
def test_ivf_dedup_mask_matches_plain(cuda, dtype, k):
    """B5 with ``mask=``: the exhaustive all-lists scan (dense member), as
    the mask plan runs it, and a routed list set whose tail repeats a live
    id with a zero member column."""
    nlist, max_list, b, d = 16, 72, 6, 64
    g, _, valid, _, q, _, _ = (
        tensor(a, cuda) for a in ivf_inputs(nlist, max_list, b, 4, d=d))
    if dtype == "float32":
        grouped, gsc, gsq = g, None, torch.sum(g * g, dim=-1)
    else:
        flat, scales, sq = _stored(g.reshape(-1, d), dtype)
        grouped = flat.reshape(nlist, max_list, d)
        gsq = sq.reshape(nlist, max_list)
        gsc = None if scales is None else scales.reshape(nlist, max_list)
    mask = _row_mask(nlist * max_list, "sparse", cuda, seed=2).reshape(
        nlist, max_list)
    mask[3, :10] = 1.0
    every = torch.arange(nlist, dtype=torch.int32, device=cuda)
    routed = torch.tensor([3, 5, 9, 3], dtype=torch.int32, device=cuda)
    rmember = torch.ones((4, b), device=cuda)
    rmember[3] = 0.0
    for uniq, member in ((every, torch.ones((nlist, b), device=cuda)),
                         (routed, rmember)):
        args = (grouped, gsq, valid, uniq, member, q)
        kk = min(k, uniq.shape[0] * max_list)
        got = ops.ivf_score_topk_dedup(*args, kk, scales=gsc, mask=mask)
        want = ref.ref_ivf_score_topk_dedup(*args, kk, gsc, mask)
        _masked_check(got, want, None)
        plain = ref.ref_ivf_score_topk_dedup(grouped, gsq, valid * mask, uniq,
                                             member, q, kk, gsc)
        assert torch.equal(want[0], plain[0]) and torch.equal(want[1],
                                                              plain[1])


def test_masked_counters_and_refusals(cuda):
    """Masked launches count on their own counters, per stored dtype; a
    mask of the wrong shape or type raises before a launch."""
    x, sq, q, _, _ = (tensor(a, cuda) for a in scan_inputs(300, 3))
    g, gsq, valid, probes, gq, _, _ = (
        tensor(a, cuda) for a in ivf_inputs(8, 16, 3, 2))
    uniq, member = ops.dedup_probes(probes, 8)
    mask, gmask = _row_mask(300, "sparse", cuda), torch.ones_like(valid)
    _build.reset_launch_counts()
    want = {}
    for dtype, suffix in (("float32", ""), ("bfloat16", "_bf16"),
                          ("int8", "_int8")):
        if dtype == "float32":
            rows, scales, rsq = x, None, sq
            grouped, gsq2, gsc = g, gsq, None
        else:
            rows, scales, rsq = _stored(x, dtype)
            flat, gs, fsq = _stored(g.reshape(-1, g.shape[-1]), dtype)
            grouped, gsq2 = flat.reshape(g.shape), fsq.reshape(gsq.shape)
            gsc = None if gs is None else gs.reshape(gsq.shape)
        ops.score_topk(rows, rsq, q, 10, scales=scales, mask=mask)
        ops.ivf_score_topk_dedup(grouped, gsq2, valid, uniq, member, gq, 5,
                                 scales=gsc, mask=gmask)
        want["score_topk_masked" + suffix] = 1
        want["ivf_score_topk_dedup_masked" + suffix] = 1
    assert _build.launch_counts() == want
    for bad in (lambda: ops.score_topk(x, sq, q, 10, mask=mask[:5]),
                lambda: ops.score_topk(x, sq, q, 10, mask=mask.double()),
                lambda: ops.ivf_score_topk_dedup(g, gsq, valid, uniq, member,
                                                 gq, 5, mask=gmask[:2])):
        with pytest.raises(ValueError):
            bad()
    assert _build.launch_counts() == want


def _predicate_case(n=6000, d=64, seed=5):
    corpus = make_corpus(CorpusSpec(n=n, d=d, n_categories=6, n_numeric=2,
                                    seed=seed))
    q, _ = sample_queries(corpus, 40, seed=seed + 1)
    return corpus, q


@pytest.mark.parametrize("backend,storage", [
    ("flat", "float32"), ("flat", "bfloat16"), ("flat", "int8"),
    ("ivf", "float32"), ("ivf", "int8")])
def test_predicate_engine_on_card_matches_cpu_engine(cuda, backend, storage):
    """search(filter=) through the masked kernels on the card against a CPU
    engine on the same state and raw attributes: every plan the index can
    run, forced plans bit-equal on the card, the delta tier, and a
    certified-empty predicate."""
    from repro_torch.core.filters import F

    corpus, q = _predicate_case()
    extra = dict(backend="ivf", nlist=32, nprobe=6) if backend == "ivf" else {}
    fcfg = fcvi.FCVIConfig(storage_dtype=storage, **extra)
    gpu_ix = fcvi.build(corpus.vectors, corpus.filters, fcfg, device=cuda)
    cpu_ix = fcvi.index_from_state(fcfg, fcvi.index_state(gpu_ix),
                                   device="cpu")
    cfg = EngineConfig(k=10, batch_size=16, compact_threshold=10_000)
    engines = [FCVIEngine(ix, EngineConfig(**vars(cfg)), device=dev,
                          attributes=corpus.filters)
               for ix, dev in ((gpu_ix, cuda), (cpu_ix, "cpu"))]
    preds = [F.range("f7", 0.0, 0.6),
             F.eq("f0", 1.0) & F.range("f7", 0.25, 0.75),
             F.eq("f5", 1.0) & F.range("f7", 0.0, 0.1)]
    rng = np.random.default_rng(9)
    new_v = corpus.vectors[:200] + normal(rng, 200, 64)
    _build.reset_launch_counts()
    for step in range(2):
        if step == 1:   # the delta tier joins every plan
            for e in engines:
                e.insert(new_v, corpus.filters[200:400])
        for pred in preds:
            plans = [None, "mask"]   # None: the planner's choice
            if backend == "ivf":
                plans.append("routed")
            elif storage == "float32" and pred is preds[0]:
                plans.append("fold")
            outs = [engines[0].search(q, filter=pred, plan=p) for p in plans]
            for s, i in outs[1:]:
                assert np.array_equal(s, outs[0][0])
                assert np.array_equal(i, outs[0][1])
            cs, ci = engines[1].search(q, filter=pred)
            assert_topk_match(cs, ci, outs[0][0], outs[0][1], rtol=1e-5,
                              atol=1e-4)
    s, i = engines[0].search(q, filter=F.range("f7", 2.0, 3.0))
    assert (i == -1).all() and np.isneginf(s).all()
    counts = _build.launch_counts()
    suffix = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}[storage]
    scan = ("ivf_score_topk_dedup_masked" if backend == "ivf"
            else "score_topk_masked") + suffix
    assert counts.get(scan, 0) > 0, counts


def test_forced_fold_at_kp_4096_equals_mask_on_card(cuda):
    """A forced fold plan on a selective predicate asks for kp=4096
    candidates, past what the scan's buffers hold: the scan takes its
    selection path, and the result equals the mask plan's bit for bit."""
    from repro_torch.core.filters import F, compile_predicate

    corpus, q = _predicate_case(n=9000)
    ix = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(),
                    device=cuda)
    eng = FCVIEngine(ix, EngineConfig(k=10), device=cuda,
                     attributes=corpus.filters)
    pred = F.range("f7", 0.0, 0.01)
    kp = eng.planner.kp_for("fold", compile_predicate(pred, eng._attr_names),
                            10)
    assert kp >= 4096 and scan.plan(9000, 40, kp, 64, 132).select
    _build.reset_launch_counts()
    fs, fi = eng.search(q, filter=pred, plan="fold")
    assert _build.launch_counts().get("score_topk_select", 0) > 0
    ms, mi = eng.search(q, filter=pred, plan="mask")
    assert np.array_equal(fs, ms) and np.array_equal(fi, mi)


# -- shapes past the buffers and wide rows: the selection path, d-chunks ----

def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("d", [384, 960])
@pytest.mark.parametrize("kk", [88, 2056])
def test_wide_rows_and_large_kk_match_plain(cuda, d, kk):
    """B2, B3 and B2 masked at sentence-embedding and GIST widths (several
    column chunks), at the default kk and at EngineConfig(k=64)'s escalated
    kk=2056, against their plain versions; B3 bit-equal to B2."""
    x, sq, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(3000, 9, d=d))
    vals, ids = ops.score_topk(x, sq, q, kk)
    rv, ri = ref.ref_score_topk(x, sq, q, kk + 1)
    assert_topk_match(rv[:, :kk].cpu(), ri[:, :kk].cpu(), vals.cpu(),
                      ids.cpu(), rtol=L2_RTOL, atol=L2_ATOL,
                      next_vals=rv[:, -1].cpu())
    out = ops.score_topk_rows(x, sq, pv, pf, q, kk)
    assert _equal(out[:2], (vals, ids))
    idx = ids.long()
    assert _equal(out[2:], (x[idx], pv[idx], pf[idx]))
    mask = _row_mask(3000, "sparse", cuda)
    mv, mi = ops.score_topk(x, sq, q, kk, mask=mask)
    rv, ri = ref.ref_score_topk(x, sq, q, kk, mask=mask)
    live = ~torch.isneginf(rv)
    assert torch.equal(torch.isneginf(mv), ~live)
    assert_topk_match(torch.where(live, rv, -1e30).cpu(), ri.cpu(),
                      torch.where(live, mv, -1e30).cpu(), mi.cpu(),
                      rtol=L2_RTOL, atol=L2_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,b,kk,d", [(3000, 9, 88, 64), (3000, 64, 2048, 128),
                                      (700, 1, 700, 960), (500, 3, 1, 30),
                                      (6000, 17, 5000, 384)])
def test_select_path_bit_equal_to_buffered(cuda, dtype, n, b, kk, d):
    """The selection path against the buffered path, bit for bit: every
    stored dtype, the rows variant and the mask, one query with kk = n, a
    width that is no multiple of 4, and a kk past the buffers (where only
    the selection path runs, held against the plain version)."""
    x, sq, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    if dtype == "float32":
        rows, scales, rsq = x, None, sq
    else:
        rows, scales, rsq = _stored(x, dtype)
    mask = _row_mask(n, "sparse", cuda)
    et = _build.ELEMENT_TYPES[rows.dtype][0]
    try:   # a kk past the buffers takes the selection path only
        scan.plan(n, b, kk, d, 132, select=False, et=et)
        big = False
    except ValueError:
        big = True
    for kw in (dict(scales=scales), dict(scales=scales, mask=mask)):
        sel = scan.score_topk(rows, rsq, q, kk, **kw, _select=True)
        if big:
            rv, ri = ref.ref_score_topk(rows, rsq, q, kk, **kw)
            live = ~torch.isneginf(rv)
            assert torch.equal(torch.isneginf(sel[0]), ~live)
            assert_topk_match(torch.where(live, rv, -1e30).cpu(), ri.cpu(),
                              torch.where(live, sel[0], -1e30).cpu(),
                              sel[1].cpu(), rtol=L2_RTOL, atol=L2_ATOL)
        else:
            assert _equal(sel, scan.score_topk(rows, rsq, q, kk, **kw,
                                               _select=False))
    out = scan.score_topk_rows(rows, rsq, pv, pf, q, kk, scales,
                               _select=True)
    assert _equal(out[:2], scan.score_topk(rows, rsq, q, kk, scales,
                                           _select=True))
    if not big:
        assert _equal(out, scan.score_topk_rows(rows, rsq, pv, pf, q, kk,
                                                scales, _select=False))


def test_select_path_ties_and_signed_zeros(cuda):
    """Exact ties go to the smaller id on both paths; -0.0 and +0.0 scores
    (zero query, zero int8 rows with scales of either sign) count equal, as
    better() counts them, and keep their bits."""
    x, sq, q = (tensor(a, cuda) for a in tie_inputs())
    for kk in (40, 600):
        a = scan.score_topk(x, sq, q, kk, _select=True)
        assert _equal(a, scan.score_topk(x, sq, q, kk, _select=False))
        assert _equal(a, ref.ref_score_topk(x, sq, q, kk))
    codes = torch.zeros((300, 16), dtype=torch.int8, device=cuda)
    scales = torch.where(torch.arange(300, device=cuda) % 3 == 0, -1.0, 1.0)
    zsq = torch.zeros(300, device=cuda)
    zq = torch.zeros((2, 16), device=cuda)
    a = scan.score_topk(codes, zsq, zq, 100, scales, _select=True)
    b = scan.score_topk(codes, zsq, zq, 100, scales, _select=False)
    assert _equal(a, b) and (a[1] == torch.arange(100, device=cuda)).all()
    assert torch.signbit(a[0][:, 0]).all()       # row 0 scores -0.0


@pytest.mark.parametrize("d", [128, 384, 960])
@pytest.mark.parametrize("k", [18, 300, 3200])
def test_ivf_select_and_wide_rows(cuda, d, k):
    """B5, B6 and B7 at several column chunks and at k'=3200 (IVF at
    EngineConfig(k=100)) against their plain versions; the selection path
    bit-equal to the buffered one, the mask and the int8 rung included."""
    g, gsq, valid, probes, q, pv, pf = (
        tensor(a, cuda) for a in ivf_inputs(24, 200, 7, 6, d=d))
    uniq, member = ops.dedup_probes(probes, 24)
    ded = (g, gsq, valid, uniq, member, q)
    got = ops.ivf_score_topk_dedup(*ded, k)
    _ivf_check(got, ref.ref_ivf_score_topk_dedup(*ded, k),
               ref.ref_ivf_score_topk_dedup(*ded, k + 1))
    sel = ivf_score.ivf_score_topk_dedup(*ded, k, _select=True)
    assert _equal(sel, got)
    rows = ivf_score.ivf_score_topk_dedup_rows(*ded, pv, pf, k)
    assert _equal(rows, ivf_score.ivf_score_topk_dedup_rows(
        *ded, pv, pf, k, _select=True))
    bat = (g, gsq, valid, probes, q)
    got = ops.ivf_score_topk_batch(*bat, k)
    _ivf_check(got, ref.ref_ivf_score_topk_batch(*bat, k),
               ref.ref_ivf_score_topk_batch(*bat, k + 1))
    assert _equal(got, ivf_score.ivf_score_topk_batch(*bat, k, _select=True))
    gmask = (torch.rand(valid.shape, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda) < 0.3).float()
    assert _equal(
        ivf_score.ivf_score_topk_dedup(*ded, k, mask=gmask),
        ivf_score.ivf_score_topk_dedup(*ded, k, mask=gmask, _select=True))
    flat, gs, fsq = _stored(g.reshape(-1, d), "int8")
    i8 = (flat.reshape(g.shape), fsq.reshape(gsq.shape), valid, uniq, member,
          q)
    gsc = gs.reshape(gsq.shape)
    assert _equal(ivf_score.ivf_score_topk_dedup(*i8, k, gsc),
                  ivf_score.ivf_score_topk_dedup(*i8, k, gsc, _select=True))


def test_ivf_select_ties_dense_member_and_routed_tail(cuda):
    """Exact ties on integer data: the selection path keeps the smaller
    flat id (dedup) and the earlier probe position (batch), as the buffered
    path does; a dense member matrix; a uniq whose tail repeats a live list
    with an empty member column (the routed plan's layout); a k past the
    buffers against the plain version."""
    g, gsq, valid, probes, q, _, _ = (
        tensor(a, cuda) for a in ivf_inputs(12, 48, 6, 5, d=16, ints=True))
    probes[0, 4] = probes[0, 1]
    uniq, member = ops.dedup_probes(probes, 12)
    for k in (30, 150):
        args = (g, gsq, valid, uniq, member, q)
        assert _equal(ivf_score.ivf_score_topk_dedup(*args, k, _select=True),
                      ref.ref_ivf_score_topk_dedup(*args, k))
        bat = (g, gsq, valid, probes, q)
        assert _equal(ivf_score.ivf_score_topk_batch(*bat, k, _select=True),
                      ref.ref_ivf_score_topk_batch(*bat, k))
    tail = torch.tensor([3, 7, 3, 3], dtype=torch.int32, device=cuda)
    mem = torch.zeros((4, 6), device=cuda)
    mem[:2] = 1.0
    args = (g, gsq, valid, tail, mem, q)
    for k in (20, 5000):
        want = ref.ref_ivf_score_topk_dedup(*args, k)
        assert _equal(ivf_score.ivf_score_topk_dedup(*args, k, _select=True),
                      want)
        assert _equal(ops.ivf_score_topk_dedup(*args, k), want)


def _list_case(case, dev):
    """(grouped fp32, valid, uniq, member, probes, q, pv, pf, k) of a shape
    that breaks the list scan's mapping: a list that all 64 queries probe
    (eight passes of Q_MAX), sources with no member between live ones,
    ragged and empty lists (a tile with no valid row; a max_list that is no
    multiple of 4), k past every query's live rows, and wide rows (a ring of
    many column chunks)."""
    rng = np.random.default_rng(7)
    nlist, L, b, nprobe, d, k = {
        "all_probe": (6, 300, 64, 3, 64, 80),
        "no_member": (40, 100, 5, 2, 64, 40),
        "ragged": (9, 650, 7, 4, 32, 60),
        "k_past_live": (10, 64, 4, 2, 64, 500),
        "wide960": (8, 300, 5, 3, 960, 50),
        "wide1536": (8, 300, 5, 3, 1536, 50)}[case]
    grouped = normal(rng, nlist, L, d)
    valid = (rng.random((nlist, L)) > 0.2).astype(np.float32)
    probes = np.stack([rng.permutation(nlist)[:nprobe]
                       for _ in range(b)]).astype(np.int32)
    if case == "all_probe":
        others = np.array([0, 1, 3, 4, 5])
        probes = np.stack([[2, *rng.choice(others, nprobe - 1, False)]
                           for _ in range(b)]).astype(np.int32)
    elif case == "ragged":
        valid[:] = 0.0
        for i, n in enumerate((0, 1, 31, 32, 33, 255, 256, 257, 600)):
            valid[i, :n] = 1.0
        valid[8, 256:512] = 0.0   # a whole tile with no valid row
    elif case == "k_past_live":
        valid[:, 20:] = 0.0
    pv, pf = normal(rng, nlist, L, d), normal(rng, nlist, L, 8)
    g, v, p, qq, pv_t, pf_t = (tensor(a, dev) for a in
                               (grouped, valid, probes,
                                normal(rng, b, d), pv, pf))
    if case == "no_member":   # every list a source, most with no member
        uniq = torch.arange(nlist, dtype=torch.int32, device=dev)
        member = torch.zeros((nlist, b), device=dev)
        member[p.long(), torch.arange(b, device=dev)[:, None]] = 1.0
    else:
        uniq, member = ops.dedup_probes(p, nlist)
    return g, v, uniq, member, p, qq, pv_t, pf_t, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", ["all_probe", "no_member", "ragged",
                                  "k_past_live", "wide960", "wide1536"])
def test_ivf_list_scan_edges(cuda, case, dtype):
    """B5, B6 and B7 against their plain versions where the list scan's
    items, passes, tiles and ring meet their edges; B6's (vals, ids)
    bit-equal to B5's and its rows to the gathered rows; the selection
    path bit-equal to the buffered one for all three."""
    g, valid, uniq, member, probes, q, pv, pf, k = _list_case(case, cuda)
    nlist, L, d = g.shape
    gsc = None
    if dtype == "float32":
        grouped, gsq = g, torch.sum(g * g, dim=-1)
    else:
        flat, scales, sq = _stored(g.reshape(-1, d), dtype)
        grouped, gsq = flat.reshape(g.shape), sq.reshape(nlist, L)
        gsc = None if scales is None else scales.reshape(nlist, L)
    assert not ivf_score.plan(k, d, grouped.dtype).select
    total = nlist * L
    ded = (grouped, gsq, valid, uniq, member, q)
    got = ops.ivf_score_topk_dedup(*ded, k, scales=gsc)
    _ivf_check(got, ref.ref_ivf_score_topk_dedup(*ded, k, gsc),
               ref.ref_ivf_score_topk_dedup(*ded, k + 1, gsc)
               if k < total else None)
    assert _equal(got, ivf_score.ivf_score_topk_dedup(*ded, k, gsc,
                                                      _select=True))
    rows = ops.ivf_score_topk_dedup_rows(*ded, pv, pf, k, scales=gsc)
    assert _equal(rows[:2], got)
    dead = torch.isneginf(got[0])[..., None]
    idx = got[1].long()
    assert torch.equal(rows[2], torch.where(dead, 0.0, pv.reshape(-1, d)[idx]))
    assert torch.equal(rows[3], torch.where(dead, 0.0, pf.reshape(-1, 8)[idx]))
    assert _equal(rows, ivf_score.ivf_score_topk_dedup_rows(
        *ded, pv, pf, k, gsc, _select=True))
    bat = (grouped, gsq, valid, probes, q)
    got = ops.ivf_score_topk_batch(*bat, k, scales=gsc)
    _ivf_check(got, ref.ref_ivf_score_topk_batch(*bat, k, gsc),
               ref.ref_ivf_score_topk_batch(*bat, k + 1, gsc)
               if k < total else None)
    assert _equal(got, ivf_score.ivf_score_topk_batch(*bat, k, gsc,
                                                      _select=True))
    if case == "k_past_live":   # every query's tail slots are dead
        assert torch.isneginf(got[0][:, 40:]).all()
        assert (got[1][:, 40:] == 0).all()


@pytest.mark.parametrize("case", ["all_probe", "ragged", "no_member"])
def test_ivf_scan_profile_counts_tiles_and_passes(cuda, case):
    """The list scan reads a list once per pass of at most Q_MAX member
    queries (none for a source with no member; one a probe for B7), and in
    each pass only the tiles with a valid row: its profile's pass and tile
    counts against counts from the inputs, on both paths."""
    g, valid, uniq, member, probes, q, _, _, k = _list_case(case, cuda)
    nlist, L, _ = g.shape
    gsq = torch.sum(g * g, dim=-1)
    t = ivf_score.TILE_ROWS
    v = valid.cpu().numpy() > 0.5
    tiles = np.array([sum(v[i, t0:t0 + t].any() for t0 in range(0, L, t))
                      for i in range(nlist)])
    passes = ivf_score.list_passes(member).cpu().numpy()
    lists = uniq.long().cpu().numpy()
    probed = probes.long().cpu().numpy().ravel()
    for select in (False, True):
        stats = torch.zeros(ivf_score.STATS, dtype=torch.int64, device=cuda)
        ivf_score.ivf_score_topk_dedup(g, gsq, valid, uniq, member, q, k,
                                       _select=select, _stats=stats)
        st = dict(zip(ivf_score.STAT_NAMES, stats.tolist()))
        assert st["tiles"] == int((passes * tiles[lists]).sum())
        assert st["passes"] == (0 if select else int(passes.sum()))
        assert st["compute"] > 0 and st["producer_item"] > 0
        stats.zero_()
        ivf_score.ivf_score_topk_batch(g, gsq, valid, probes, q, k,
                                       _select=select, _stats=stats)
        st = dict(zip(ivf_score.STAT_NAMES, stats.tolist()))
        assert st["tiles"] == int(tiles[probed].sum())
        assert st["passes"] == (0 if select else probed.size)
    if case == "all_probe":   # list 2 has 64 members: eight passes
        assert passes[lists == 2].tolist() == [64 // ivf_score.Q_MAX]


def _pq_case(n, m, ksub, ncoarse, b, dtype, dev, seed=0,
             signed_zeros=False):
    """(combined codes, grouped layout, luts) of a random PQ corpus on
    ``dev``: quarter-integer LUTs (equal sums are common), or with
    ``signed_zeros`` LUT entries of +0.0 and -0.0 and a few 0.5s, so sums
    tie and -0.0 sums occur."""
    rng = np.random.default_rng(seed)
    codes = tensor(rng.integers(0, ksub, (n, m)), dev).to(dtype)
    coarse = tensor(rng.integers(0, ncoarse, n), dev).to(torch.int32)
    if signed_zeros:
        luts = np.where(rng.random((b, m, ncoarse * ksub)) < 0.5, -0.0,
                        0.0).astype(np.float32)
        luts[:, :, ::7] = 0.5
    else:
        luts = rng.integers(0, 40, (b, m, ncoarse * ksub)).astype(
            np.float32) * 0.25
    layout = pq.grouped_layout(codes, coarse, ncoarse)
    ccodes = coarse[:, None] * ksub + codes.to(torch.int32)
    return ccodes, layout, tensor(luts, dev)


def _pq_bits(a, b):
    """(vals, ids) pairs equal bit for bit (-0.0 apart from +0.0)."""
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


@pytest.mark.parametrize("m", [8, 16, 64, 128])
@pytest.mark.parametrize("kk", [80, 320, 2048])
def test_pq_score_topk_bit_equal_to_plain(cuda, m, kk):
    """The fused ADC scan + top-k bit for bit against ``ref_pq_score_topk``
    at M in {8, 16, 64, 128} (query tiles 16 down to 1, slices staged or
    read from L2) and the serving kk's, on quarter-integer LUTs (many equal
    scores), b of one query, of a ragged tile (3), of one and of several
    tiles, uint8 codes; both paths forced bit-equal too; one launch counted
    under the planned path's name; B9 stays off this path."""
    for b in (1, 3, 16, 64):
        ccodes, layout, luts = _pq_case(5000, m, 256, 32, b, torch.uint8,
                                        cuda, seed=m + b)
        want = ref.ref_pq_score_topk(ccodes, luts, kk)
        _build.reset_launch_counts()
        got = ops.pq_score_topk(ccodes, luts, kk, layout)
        sel = pq_lut.topk_plan(5000, b, kk, m, 256, 132).select
        counts = {"pq_score_topk" + ("_select" if sel else ""): 1}
        if sel:   # the select's kernels, counted where they run
            counts[_build.SELECT_NAME] = 1
        assert _build.launch_counts() == counts
        assert _pq_bits(got, want)
        for forced in (True, False):
            assert _pq_bits(pq_lut.pq_score_topk(*layout, luts, kk,
                                              _select=forced), want)


def test_pq_score_topk_signed_zeros_ties_and_layouts(cuda):
    """-0.0 ranks below +0.0 and equal scores go to the smaller row, as
    ``lax.top_k`` ranks them, on both paths; every LUT entry equal (every
    score ties: ids decide); int32 codes, ragged groups with an empty one,
    one coarse group, kk = n, n below 8 kk (no sample), a (M, ksub) slice
    too wide for shared memory (read from L2), and a kk past the buffers
    (the selection path)."""
    ccodes, layout, luts = _pq_case(3000, 8, 64, 8, 5, torch.int32, cuda,
                                    signed_zeros=True)
    for kk in (1, 300, 3000):
        want = ref.ref_pq_score_topk(ccodes, luts, kk)
        for forced in (None, True, False):
            assert _pq_bits(pq_lut.pq_score_topk(*layout, luts, kk,
                                              _select=forced), want)
        if kk == 300:   # +0.0 (d2 = -0.0) above -0.0, the data really ties
            assert (want[0] == 0).all() and torch.signbit(want[0]).any()
            assert not torch.signbit(want[0][:, 0]).all()
    # every entry equal: every score ties and the smaller row wins
    flat = torch.full_like(luts, 1.25)
    for kk in (40, 700):
        want = ref.ref_pq_score_topk(ccodes, flat, kk)
        assert torch.equal(torch.sort(want[1], dim=1).values, want[1])
        for forced in (True, False):
            assert _pq_bits(pq_lut.pq_score_topk(*layout, flat, kk,
                                              _select=forced), want)
    rng = np.random.default_rng(3)
    codes = tensor(rng.integers(0, 16, (2000, 4)), cuda).to(torch.uint8)
    coarse = tensor(rng.permutation(np.repeat([0, 2, 3], [700, 1000, 300])),
                    cuda).to(torch.int32)
    layout = pq.grouped_layout(codes, coarse, 4)
    assert layout[3] == (0, 700, 700, 1700, 2000)
    luts = tensor(rng.random((3, 4, 64)).astype(np.float32), cuda)
    ccodes = coarse[:, None] * 16 + codes.to(torch.int32)
    for kk in (50, 400, 2000):
        want = ref.ref_pq_score_topk(ccodes, luts, kk)
        assert _pq_bits(ops.pq_score_topk(ccodes, luts, kk, layout), want)
        assert _pq_bits(pq_lut.pq_score_topk(*layout, luts, kk, _select=True),
                     want)
    one = pq.grouped_layout(codes, torch.zeros_like(coarse), 1)
    luts1 = tensor(rng.random((7, 4, 16)).astype(np.float32), cuda)
    for kk in (30, 2000):
        assert _pq_bits(ops.pq_score_topk(codes.to(torch.int32), luts1, kk, one),
                     ref.ref_pq_score_topk(codes.to(torch.int32), luts1, kk))
    ccodes, layout, luts = _pq_case(4000, 256, 256, 2, 3, torch.uint8, cuda)
    assert not pq_lut.topk_plan(4000, 3, 100, 256, 256, 132).staged
    assert _pq_bits(ops.pq_score_topk(ccodes, luts, 100, layout),
                 ref.ref_pq_score_topk(ccodes, luts, 100))
    ccodes, layout, luts = _pq_case(30000, 8, 256, 4, 2, torch.uint8, cuda)
    assert pq_lut.topk_plan(30000, 2, 20000, 8, 256, 132).select
    _build.reset_launch_counts()
    assert _pq_bits(ops.pq_score_topk(ccodes, luts, 20000, layout),
                 ref.ref_pq_score_topk(ccodes, luts, 20000))
    assert _build.launch_counts() == {"pq_score_topk_select": 1,
                                      _build.SELECT_NAME: 1}


@pytest.mark.parametrize("b", [1, 3, 16, 64])
def test_pq_score_topk_admissions_pile_up_in_one_chunk(cuda, b):
    """A clustered corpus where every query is nearest one coarse group, so
    nearly every admission falls in that group's chunks: bit-equal on both
    paths at kk 80, 320 and 2048; with the planned buffers and with small
    ones (kk + a 16-word margin + 8 words, looked at every 64 rows, one
    chunk a query tile), whose cuts run after many tiles and whose appends
    spill past the buffers. The profile counts every (query, chunk) once and
    at least kk words a query admitted; the sample cuts the admissions."""
    rng = np.random.default_rng(b)
    n, m, ksub, ncoarse = 60_000, 8, 256, 16
    codes = tensor(rng.integers(0, ksub, (n, m)), cuda).to(torch.uint8)
    coarse = tensor(rng.integers(0, ncoarse, n), cuda).to(torch.int32)
    layout = pq.grouped_layout(codes, coarse, ncoarse)
    luts = rng.random((b, m, ncoarse * ksub)).astype(np.float32) + 4.0
    luts.reshape(b, m, ncoarse, ksub)[:, :, 5, :] -= 3.5   # group 5 nearest
    luts = tensor(luts, cuda)
    ccodes = coarse[:, None] * ksub + codes.to(torch.int32)
    for kk in (80, 320, 2048):
        want = ref.ref_pq_score_topk(ccodes, luts, kk)
        assert (coarse[want[1].long()] == 5).all()
        for forced in (True, False):
            assert _pq_bits(pq_lut.pq_score_topk(*layout, luts, kk,
                                              _select=forced), want)
        plan = pq_lut.topk_plan(n, b, kk, m, ksub, 132, select=False)
        small = dataclasses.replace(plan, tile=64, margin=16,
                                    cap=kk + 16 + 8, nchunks=1, chunk_rows=n)
        stats = torch.zeros(pq_lut.STATS, dtype=torch.int64, device=cuda)
        assert _pq_bits(pq_lut.pq_score_topk(*layout, luts, kk, _plan=small,
                                          _stats=stats), want)
        st = dict(zip(pq_lut.STAT_NAMES, stats.tolist()))
        assert st["query_chunks"] == b and st["cuts"] >= b
        assert st["admitted"] >= kk * b and st["cut_words"] > kk * st["cuts"]
        stats.zero_()
        pq_lut.pq_score_topk(*layout, luts, kk, _select=False, _stats=stats)
        st = dict(zip(pq_lut.STAT_NAMES, stats.tolist()))
        assert st["query_chunks"] == b * plan.nchunks
        assert kk * b <= st["admitted"] < n * b // 2


def test_fused_transform_fold_matrix_past_shared_memory(cuda):
    """B1 with an (m, d) fold matrix too large for shared memory (read
    through L2): the same results as the plain version."""
    v, f, proj, norms = transform_inputs(500, 960, 64, True)
    args = [tensor(a, cuda) for a in (v, f, proj)]
    nargs = [tensor(a, cuda) for a in norms]
    torch.testing.assert_close(ops.fused_transform(*args, 1.5, *nargs),
                               ref.ref_fused_transform(*args, 1.5, *nargs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["flat", "ivf", "pq"])
def test_k64_and_wide_rows_engine_on_card_matches_cpu_engine(cuda, backend):
    """EngineConfig(k=64) (every query escalated to k'=2048, 2056 on flat)
    at d=384, served on the card through the kernels, against the plain
    path on the same state."""
    corpus = make_corpus(CorpusSpec(n=5000, d=384, n_categories=5,
                                    n_numeric=3, seed=7))
    q, fq = sample_queries(corpus, 64, seed=8)
    extra = dict(ivf=dict(nlist=16, nprobe=4), pq=dict(pq_ksub=64,
                                                       pq_coarse=8))
    fcfg = fcvi.FCVIConfig(backend=backend, **extra.get(backend, {}))
    gpu_ix = fcvi.build(corpus.vectors, corpus.filters, fcfg, device=cuda)
    cpu_ix = fcvi.index_from_state(fcfg, fcvi.index_state(gpu_ix),
                                   device="cpu")
    keep = np.ones(len(q), bool)
    if backend == "pq":   # candidate near-ties may differ by one row
        qn, fqn = cpu_ix.transform.normalize(tensor(q), tensor(fq))
        q_t = cpu_ix.transform.apply_normalized(qn, fqn)
        for kp in (512, 2048):
            vals = pq.search(cpu_ix.backend, q_t, kp + 1)[0]
            keep &= ~candidate_ties(vals, kp)
    cfg = EngineConfig(k=64, escalate_margin=10.0)   # every query escalates
    engines = [FCVIEngine(gpu_ix, cfg, device=cuda),
               FCVIEngine(cpu_ix, EngineConfig(**vars(cfg)), device="cpu")]
    _build.reset_launch_counts()
    (gs, gi), (cs, ci) = (e.search(q, fq) for e in engines)
    assert engines[0].stats.escalations == engines[1].stats.escalations == 64
    assert _build.launch_counts()
    assert_topk_match(cs[keep], ci[keep], gs[keep], gi[keep], rtol=0,
                      atol=1e-5)


# -- the flat scan on the tensor cores: cuts, chunk edges, masks, alignment --

def _largest_buffered_kk(n, b, d, et):
    """The largest kk the buffered path takes for this batch (bisection)."""
    lo, hi = 1, n
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if scan.plan(n, b, mid, d, 132, et=et).select:
            hi = mid - 1
        else:
            lo = mid
    return lo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("which", ["88", "328", "largest"])
def test_flat_scan_every_dtype_and_width(cuda, dtype, which):
    """Every stored type at kk 88, 328 and the largest kk the buffers take,
    a ragged corpus (n no multiple of a 128-row tile or a chunk) and a
    ragged query batch (70: a full 64-query tile and 6): against the plain
    version; B3's (vals, ids) equal B2's and the selection path's equal the
    buffered path's, bit for bit."""
    n, b, d = 20011, 70, 128
    x, _, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    rows, scales, sq = (x, None, torch.sum(x * x, dim=-1)) \
        if dtype == "float32" else _stored(x, dtype)
    et = _build.ELEMENT_TYPES[rows.dtype][0]
    kk = {"88": 88, "328": 328}.get(which) or _largest_buffered_kk(
        n, b, d, et)
    assert not scan.plan(n, b, kk, d, 132, et=et).select
    buf = scan.score_topk(rows, sq, q, kk, scales, _select=False)
    rv, ri = ref.ref_score_topk(rows, sq, q, kk + 1, scales)
    assert_topk_match(rv[:, :kk].cpu(), ri[:, :kk].cpu(), buf[0].cpu(),
                      buf[1].cpu(), rtol=L2_RTOL, atol=L2_ATOL,
                      next_vals=rv[:, -1].cpu())
    assert _equal(buf, scan.score_topk(rows, sq, q, kk, scales,
                                       _select=True))
    out = scan.score_topk_rows(rows, sq, pv, pf, q, kk, scales,
                               _select=False)
    assert _equal(out[:2], buf)
    idx = buf[1].long()
    assert _equal(out[2:], (_dequant(rows, scales)[idx], pv[idx], pf[idx]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flat_scan_ties_across_cuts_and_chunks(cuda, dtype):
    """Duplicate integer rows (exact scores, every score tied several
    times), ordered so that the best rows come last: the sample's threshold
    lets many through in the last chunks, whose buffers fill, spill and are
    cut (the profile counts the cuts). Ties go to the smaller id across
    cuts and chunk edges: bit for bit the plain version's, on both paths."""
    rng = np.random.default_rng(11)
    base = rng.integers(-2, 3, (5000, 16)).astype(np.float32)
    x = np.concatenate([base] * 40)           # 200,000 rows, 40 copies each
    q = rng.integers(-2, 3, (6, 16)).astype(np.float32)
    order = np.argsort((x @ q[0]) - 0.5 * (x * x).sum(-1), kind="stable")
    x = tensor(x[order], cuda)
    q = tensor(q, cuda)
    rows = x if dtype == "float32" else x.to(
        torch.bfloat16 if dtype == "bfloat16" else torch.int8)
    sq = torch.sum(x * x, dim=-1)
    stats = torch.zeros(scan.STATS, dtype=torch.int64, device=cuda)
    for kk in (300, 1000):
        buf = scan.score_topk(rows, sq, q, kk, _select=False, _stats=stats)
        want = ref.ref_score_topk(rows, sq, q, kk)
        assert _equal(buf, want)
        assert _equal(buf, scan.score_topk(rows, sq, q, kk, _select=True))
    assert stats[scan.STAT_NAMES.index("cuts")].item() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["none", "ten", "p3"])
def test_flat_scan_masks_read_eligible_rows(cuda, dtype, kind):
    """Masks with no eligible row, 10 eligible rows and a P3-like density
    (1.1%), at kk below and above the eligible count: dead slots exactly
    (-inf, 0), live slots against the plain version, the selection path
    bit-equal to the buffered one."""
    n, b, d = 30011, 64, 128
    x, _, q, _, _ = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    rows, scales, sq = (x, None, torch.sum(x * x, dim=-1)) \
        if dtype == "float32" else _stored(x, dtype)
    rng = np.random.default_rng(12)
    m = np.zeros(n, np.float32)
    if kind == "ten":
        m[rng.choice(n, 10, replace=False)] = 1.0
    elif kind == "p3":
        m[rng.random(n) < 0.011] = 1.0
    mask = tensor(m, cuda)
    for kk in (18, 128):
        got = scan.score_topk(rows, sq, q, kk, scales, mask, _select=False)
        want = ref.ref_score_topk(rows, sq, q, kk, scales, mask)
        nxt = ref.ref_score_topk(rows, sq, q, kk + 1, scales, mask)
        _masked_check(got, want, nxt)
        assert _equal(got, scan.score_topk(rows, sq, q, kk, scales, mask,
                                           _select=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_flat_scan_misaligned_rows_keep_their_bits(cuda, dtype):
    """Rows 8 bytes past a 16-byte boundary take the threads' staging path
    in place of the copy engine's; a score depends on its row and query
    alone, so the results equal the aligned copy's bit for bit."""
    n, b, d = 5000, 17, 128
    x, _, q, _, _ = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    if dtype == "float32":
        rows, scales, sq = x, None, torch.sum(x * x, dim=-1)
        buf = torch.empty(rows.numel() + 2, device=cuda)
        moved = buf[2:].view(rows.shape).copy_(rows)
    else:
        rows, scales, sq = _stored(x, dtype)
        moved, _, _ = _stored(x, dtype, misalign=True)
    assert moved.data_ptr() % 16 == 8
    for kk in (88, 328):
        assert _equal(scan.score_topk(moved, sq, q, kk, scales),
                      scan.score_topk(rows, sq, q, kk, scales))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_scan_rising_scores_cut_every_tile(cuda, dtype):
    """Rows that come nearer every query row by row: the sample's threshold
    lets every row of the last chunks through, so each of their tiles
    appends 128 candidates a query, spills past the buffer and is cut
    before the next tile appends; against the plain version, and the
    selection path bit for bit."""
    n, kk = 200_000, 300
    x = np.zeros((n, 16), np.float32)
    x[:, 0] = (n - np.arange(n, dtype=np.float32)) * 0.01
    q = np.zeros((6, 16), np.float32)
    q[:, 1] = np.arange(6) * 0.1
    x, q = tensor(x, cuda), tensor(q, cuda)
    rows = x if dtype == "float32" else x.to(torch.bfloat16)
    sq = torch.sum(rows.float() ** 2, dim=-1)
    p = scan.plan(n, 6, kk, 16, 132)
    assert p.sample and p.chunk_rows > p.cap
    stats = torch.zeros(scan.STATS, dtype=torch.int64, device=cuda)
    got = scan.score_topk(rows, sq, q, kk, _select=False, _stats=stats)
    assert stats[scan.STAT_NAMES.index("cuts")].item() > 0
    rv, ri = ref.ref_score_topk(rows, sq, q, kk + 1)
    assert_topk_match(rv[:, :kk].cpu(), ri[:, :kk].cpu(), got[0].cpu(),
                      got[1].cpu(), rtol=L2_RTOL, atol=L2_ATOL,
                      next_vals=rv[:, -1].cpu())
    assert _equal(got, scan.score_topk(rows, sq, q, kk, _select=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [1536, 4096])
def test_flat_scan_streamed_query_operand(cuda, dtype, d):
    """Rows wide enough that the planner stages the query operand a column
    chunk at a time (a 64-query tile in place of a narrower one, or the
    only way to fit): against the plain version at kk 88 and 328, B3's
    (vals, ids) equal to B2's and the selection path to the buffered one,
    bit for bit."""
    n, b = 4011, 70
    x, _, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    rows, scales, sq = (x, None, torch.sum(x * x, dim=-1)) \
        if dtype == "float32" else _stored(x, dtype)
    et = _build.ELEMENT_TYPES[rows.dtype][0]
    for kk in (88, 328):
        p = scan.plan(n, b, kk, d, 132, et=et)
        assert p.qstream and not p.select
        buf = scan.score_topk(rows, sq, q, kk, scales, _select=False)
        rv, ri = ref.ref_score_topk(rows, sq, q, kk + 1, scales)
        assert_topk_match(rv[:, :kk].cpu(), ri[:, :kk].cpu(), buf[0].cpu(),
                          buf[1].cpu(), rtol=L2_RTOL, atol=L2_ATOL,
                          next_vals=rv[:, -1].cpu())
        assert _equal(buf, scan.score_topk(rows, sq, q, kk, scales,
                                           _select=True))
        out = scan.score_topk_rows(rows, sq, pv, pf, q, kk, scales,
                                   _select=False)
        assert _equal(out[:2], buf)



def near_cancelling(n, b, d, mag, seed):
    """fp32 rows and queries around b shared centres (||x||^2 about mag,
    a spread of 0.2 a column: scores about -8), so 2 <q, x> and the norms
    cancel and the dot product's error shows whole in the score."""
    rng = np.random.default_rng(seed)
    centre = rng.standard_normal((b, d)) * np.sqrt(mag / d)
    x = centre[np.arange(n) % b] + 0.2 * rng.standard_normal((n, d))
    q = centre + 0.2 * rng.standard_normal((b, d))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mag", [64, 250])
def test_flat_scan_near_cancelling_scores(cuda, dtype, mag):
    """Where 2 <q, x> and the norms cancel, an fp32 sum of the products is
    off by several of the L2 tolerance's atol. The tensor cores'
    accumulation is the larger part of the scan's error, and the CPU
    emulation of the split does not cover it: here the scan's scores are
    held against fp64 scores of the same rows and must be no further from
    them than the same expression through torch's fp32 matrix product.
    One MMA sum over the whole row (in place of groups of kGroup k-steps
    added in fp32) goes past it."""
    n, b, d, kk = 50_000, 64, 128, 88
    x, q = (tensor(a, cuda) for a in near_cancelling(n, b, d, mag, 13))
    rows, scales, sq = (x, None, torch.sum(x * x, dim=-1)) \
        if dtype == "float32" else _stored(x, dtype)
    vals, ids = scan.score_topk(rows, sq, q, kk, scales)
    idx = ids.long()
    deq = _dequant(rows, scales)
    full = 2.0 * (q @ deq.T) if scales is None else \
        2.0 * (q @ rows.float().T) * scales
    plain = torch.gather((full - sq[None, :])
                         - torch.sum(q * q, dim=-1, keepdim=True), 1, idx)
    xd, qd = deq.double()[idx], q.double()[:, None, :]
    exact = (2.0 * (xd * qd).sum(-1) - sq.double()[idx]
             - (qd * qd).sum(-1))
    err, err_plain = ((t.double() - exact).abs().max().item()
                      for t in (vals, plain))
    print(f"near-cancelling {dtype} |x|^2~{mag}: against fp64 the scan "
          f"{err:.3g}, the plain version {err_plain:.3g}")
    assert err <= err_plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_scans_within_each_slots_tolerance(cuda, backend, dtype):
    """Every slot of the flat scan (kk 88, 328, 2056: buffered and
    selection paths) and of the IVF scans B5 and B7 (k 80, 320, 3200)
    within its own L2 tolerance of the plain version, on a transformed
    corpus whose norms (about 250-440) make an fp32 sum of the dot
    product's products err by up to a slot's tolerance: the flat plain
    version rounds its dot product once, and the flat scan sums each
    k-step's products apart; the IVF plain versions' fp32 product sums as
    the list scans do."""
    corpus = make_corpus(CorpusSpec(n=200_000, d=128, n_categories=6,
                                    n_numeric=2, seed=0))
    qv, qf = sample_queries(corpus, 64, seed=1)
    cfg = fcvi.FCVIConfig(backend=backend, storage_dtype=dtype, nlist=256,
                          nprobe=16)
    ix = fcvi.build(corpus.vectors, corpus.filters, cfg, device=cuda)
    be = ix.backend
    q = ix.transform.apply(tensor(qv, cuda), tensor(qf, cuda)).contiguous()
    runs = []
    if backend == "flat":
        for kk in (88, 328, 2056):
            runs.append((f"score_topk kk={kk}",
                         ops.score_topk(be.vectors, be.sq_norms, q, kk,
                                        scales=be.scales),
                         ref.ref_score_topk(be.vectors, be.sq_norms, q, kk,
                                            be.scales)))
    else:
        c2 = torch.sum(be.centroids * be.centroids, dim=-1)
        probes = ops.score_topk(be.centroids, c2, q, 16)[1]
        uniq, member = ops.dedup_probes(probes, 256)
        grp, sc = (be.grouped, be.grouped_sq, be.valid), be.grouped_scales
        for k in (80, 320, 3200):
            runs.append((f"B5 k={k}", ops.ivf_score_topk_dedup(
                *grp, uniq, member, q, k, scales=sc),
                ref.ref_ivf_score_topk_dedup(*grp, uniq, member, q, k, sc)))
            runs.append((f"B7 k={k}", ops.ivf_score_topk_batch(
                *grp, probes, q, k, scales=sc),
                ref.ref_ivf_score_topk_batch(*grp, probes, q, k, sc)))
    for what, (gv, _), (wv, _) in runs:
        live = torch.isfinite(wv)
        assert torch.equal(torch.isfinite(gv), live), what
        share = ((gv - wv).abs() / (L2_ATOL + L2_RTOL * wv.abs()))[live]
        assert share.max().item() <= 1.0, (
            f"{backend} {dtype} {what}: {share.max().item():.3f} of a "
            "slot's tolerance")


# -- the multi-block select and B5 mask= on the tensor cores ---------------

def _modes(stats, launch):
    """The modes (bit 1 << mode: 1 histogram, 2 compaction) the blocks of
    one select launch ran, from ``_build.select_stats``."""
    return int(stats[3 * launch + 2].item())


def _bits_equal(a, b):
    return (torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
            and torch.equal(a[1], b[1]))


@pytest.mark.parametrize("case", ["spread", "ties", "forced_cap",
                                  "zeros_nan_inf", "few_live", "kk_n",
                                  "kk_past_n"])
def test_select_topk_matches_plain_bit_for_bit(cuda, case):
    """The select alone against its plain version, bit for bit: spread
    scores (one histogram), every score equal past the buffer (the full-row
    passes under the prefix: four histograms), a buffer forced to kk, -0.0
    with +0.0, NaN and -inf, fewer live entries than kk, kk = n, kk past
    n."""
    from repro_torch.kernels import topk_select

    g = torch.Generator(device=cuda).manual_seed(3)
    b, n, kks, cap = 5, 100_000, (1, 88, 2056, 20_000), None
    s = torch.randn((b, n), generator=g, device=cuda) - 3.0
    if case == "ties":
        s = torch.full((3, 70_000), -1.25, device=cuda)
        kks = (100, 16_000)
    elif case == "forced_cap":
        kks, cap = (300,), 300
    elif case == "zeros_nan_inf":
        r = torch.rand((b, n), generator=g, device=cuda)
        s = torch.where(r < 0.45, -0.0, 0.0)
        s = torch.where(r > 0.9, float("-inf"), s)
        s = torch.where((r > 0.85) & (r <= 0.9), float("nan"), s)
    elif case == "few_live":
        s = torch.where(torch.rand((b, n), generator=g, device=cuda) < 1e-3,
                        s, float("-inf"))
        kks = (88, 2056)
    elif case == "kk_n":
        s, kks = s[:, :3000].contiguous(), (3000,)
    elif case == "kk_past_n":
        s, kks = s[:, :100].contiguous(), (300,)
    for kk in kks:
        stats = _build.select_stats(cuda)
        _build.reset_launch_counts()
        got = topk_select.select_topk(s, kk, _cap=cap, _stats=stats)
        assert _build.launch_counts() == {_build.SELECT_NAME: 1}
        assert _bits_equal(got, ref.ref_select_topk(s, kk))
        hists = sum(_modes(stats, p) & 1 for p in range(_build.SELECT_PASSES))
        if case == "ties":
            assert hists == 4, stats.tolist()   # every full-row pass ran
        elif case == "spread":
            assert hists == 1, stats.tolist()
        elif case == "forced_cap":
            assert hists >= 2, stats.tolist()


def _ties_flat(n, d, cuda):
    """Zero rows and a zero query: every score +0.0 (int8 codes with
    negative scales score -0.0), so the select's histograms see one bin
    past the buffer."""
    x = torch.zeros((n, d), device=cuda)
    return x, torch.zeros(n, device=cuda), torch.zeros((3, d), device=cuda)


def test_select_path_adversarial_flat(cuda):
    """Flat B2 (plain and masked) and B3 selection bit-equal to buffered
    on adversarial scratch: every score equal past the candidate buffer
    (the full-row passes run), -0.0 and +0.0 with -inf and NaN scores,
    fewer eligible rows than kk, no eligible row; kk = n against the plain
    version on exact scores."""
    n, d, kk = 40_000, 16, 100
    x, sq, q = _ties_flat(n, d, cuda)
    pv = torch.randn((n, 8), device=cuda)
    pf = torch.randn((n, 3), device=cuda)
    stats = _build.select_stats(cuda)
    sel = scan.score_topk(x, sq, q, kk, _select=True, _sel_stats=stats)
    assert _modes(stats, 3) & 1, stats.tolist()   # the fourth histogram
    assert _equal(sel, scan.score_topk(x, sq, q, kk, _select=False))
    assert _equal(sel, ref.ref_score_topk(x, sq, q, kk))
    rows = scan.score_topk_rows(x, sq, pv, pf, q, kk, _select=True)
    assert _equal(rows, scan.score_topk_rows(x, sq, pv, pf, q, kk,
                                             _select=False))
    g = torch.Generator(device=cuda).manual_seed(4)
    r = torch.rand(n, generator=g, device=cuda)
    codes = torch.zeros((n, d), dtype=torch.int8, device=cuda)
    scales = torch.where(r < 0.5, -1.0, 1.0)
    wild = torch.where(r > 0.9, float("inf"), 0.0)
    wild = torch.where((r > 0.8) & (r <= 0.9), float("nan"), wild)
    for kw in (dict(), dict(mask=(r < 0.6).float()),
               dict(mask=(r < 2e-4).float()),
               dict(mask=torch.zeros(n, device=cuda))):
        a = scan.score_topk(codes, wild, q, kk, scales, _select=True, **kw)
        assert _equal(a, scan.score_topk(codes, wild, q, kk, scales,
                                         _select=False, **kw))
        if "mask" in kw and int(kw["mask"].sum()) < kk:
            live = int((kw["mask"] * (r <= 0.8)).sum())
            assert (~torch.isneginf(a[0])).sum(dim=1).eq(live).all()
            assert (a[1][torch.isneginf(a[0])] == 0).all()
    xs, sqs, qs = (tensor(a, cuda) for a in tie_inputs())   # exact scores
    assert _equal(scan.score_topk(xs, sqs, qs, xs.shape[0], _select=True),
                  ref.ref_score_topk(xs, sqs, qs, xs.shape[0]))


def test_select_path_adversarial_ivf_and_pq(cuda):
    """IVF B5 (dedup), B6 (rows) and B7 (batch) and the fused PQ scan:
    selection bit-equal to buffered (and to plain where scores are exact)
    when every score is equal past the candidate buffer, so the full-row
    passes run; -inf slots and a segment no query is a member of."""
    nlist, L, b, d, k = 64, 1024, 3, 16, 100
    g = torch.zeros((nlist, L, d), device=cuda)
    gsq = torch.zeros((nlist, L), device=cuda)
    valid = torch.ones((nlist, L), device=cuda)
    valid[5, ::3] = 0.0                         # -inf slots
    q = torch.zeros((b, d), device=cuda)
    uniq = torch.arange(nlist, dtype=torch.int32, device=cuda)
    member = torch.ones((nlist, b), device=cuda)
    member[7, 1] = 0.0                          # a non-member segment
    pv = torch.randn((nlist, L, 5), device=cuda)
    pf = torch.randn((nlist, L, 2), device=cuda)
    ded = (g, gsq, valid, uniq, member, q)
    stats = _build.select_stats(cuda)
    sel = ivf_score.ivf_score_topk_dedup(*ded, k, _select=True,
                                         _sel_stats=stats)
    assert _modes(stats, 1) & 1, stats.tolist()   # a second histogram
    assert _equal(sel, ivf_score.ivf_score_topk_dedup(*ded, k,
                                                      _select=False))
    assert _equal(sel, ref.ref_ivf_score_topk_dedup(*ded, k))
    assert _equal(ivf_score.ivf_score_topk_dedup_rows(*ded, pv, pf, k,
                                                      _select=True),
                  ivf_score.ivf_score_topk_dedup_rows(*ded, pv, pf, k,
                                                      _select=False))
    probes = torch.stack([torch.randperm(nlist, device=cuda)[:32]
                          for _ in range(b)]).to(torch.int32)
    bat = (g, gsq, valid, probes, q)
    assert _equal(ivf_score.ivf_score_topk_batch(*bat, k, _select=True),
                  ivf_score.ivf_score_topk_batch(*bat, k, _select=False))
    assert _equal(ivf_score.ivf_score_topk_batch(*bat, k, _select=True),
                  ref.ref_ivf_score_topk_batch(*bat, k))
    ccodes, layout, luts = _pq_case(40_000, 8, 16, 4, 3, torch.uint8, cuda)
    luts = torch.zeros_like(luts)               # every -d2 is -0.0
    for kk in (100, 40_000):
        want = ref.ref_pq_score_topk(ccodes, luts, kk)
        assert _equal(pq_lut.pq_score_topk(*layout, luts, kk, _select=True),
                      want)
    assert _equal(pq_lut.pq_score_topk(*layout, luts, 100, _select=False),
                  ref.ref_pq_score_topk(ccodes, luts, 100))


def _ivf_case(nlist, max_list, b, d, dtype, cuda, seed=0):
    g, gsq, valid, _, q, _, _ = (tensor(a, cuda) for a in ivf_inputs(
        nlist, max_list, b, 4, d=d, seed=seed))
    if dtype == "float32":
        return g, gsq, None, valid, q
    flat, scales, sq = _stored(g.reshape(-1, d), dtype)
    return (flat.reshape(nlist, max_list, d), sq.reshape(nlist, max_list),
            None if scales is None else scales.reshape(nlist, max_list),
            valid, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("sel", [0.6, 0.166, 0.011])
def test_ivf_mask_on_tensor_cores_matches_plain(cuda, dtype, sel):
    """B5 ``mask=`` (the flat tensor-core scan over the eligible slots,
    B5's epilogue) at P1/P2/P3 selectivities, as the mask plan runs it
    (every list, an all-ones member), the routed plan (the lists holding
    an eligible row, the tail repeating a live id under an empty member
    row) and under a sparse member, against its plain version; the
    selection path bit-equal to the buffered one; its launches on the
    masked counters; its operand builder (eligible slots, the lists'
    member bits) equal to the plain version."""
    from repro_torch.index import ivf

    nlist, max_list, b, d = 48, 200, 64, 128
    g, gsq, gsc, valid, q = _ivf_case(nlist, max_list, b, d, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(int(sel * 1000))
    mask = (torch.rand((nlist, max_list), generator=gen, device=cuda)
            < sel).float()
    lists = torch.where(valid > 0.5, torch.arange(
        nlist * max_list, dtype=torch.int32, device=cuda).view(
            nlist, max_list), -1)
    uniq, n_live = ivf.eligible_lists(lists, (mask > 0.5).view(-1))
    rmember = (torch.arange(uniq.numel(), device=cuda) < n_live)[:, None] \
        .float().expand(uniq.numel(), b).contiguous()
    every = torch.arange(nlist, dtype=torch.int32, device=cuda)
    sparse = (torch.rand((nlist, b), generator=gen, device=cuda)
              < 0.25).float()
    suffix = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}[dtype]
    for uniq_, member in ((every, torch.ones((nlist, b), device=cuda)),
                          (uniq, rmember), (every, sparse)):
        # the operand builder against its plain version
        code, elig, count, lbits = ivf_score.masked_slots(valid, mask, uniq_,
                                                          member)
        want_ids, want_bits = ref.ref_ivf_masked_slots(valid, mask, uniq_,
                                                       member)
        assert code == 0 and int(count.item()) == want_ids.numel()
        assert torch.equal(elig[:want_ids.numel()], want_ids)
        assert torch.equal(lbits, want_bits)
        for k in (18, 128):
            args = (g, gsq, valid, uniq_, member, q)
            _build.reset_launch_counts()
            got = ops.ivf_score_topk_dedup(*args, k, scales=gsc, mask=mask)
            counts = _build.launch_counts()
            assert counts.get("ivf_score_topk_dedup_masked" + suffix,
                              0) == 1, counts
            want = ref.ref_ivf_score_topk_dedup(*args, k, gsc, mask)
            nxt = ref.ref_ivf_score_topk_dedup(*args, k + 1, gsc, mask)
            _masked_check(got, want, nxt)
            sel_path = ivf_score.ivf_score_topk_dedup(*args, k, gsc, mask,
                                                      _select=True)
            assert _equal(sel_path, got)
    # the mask plan's all-lists scan and the routed plan's agree bit for bit
    a = ivf_score.ivf_score_topk_dedup(g, gsq, valid, every, torch.ones(
        (nlist, b), device=cuda), q, 18, gsc, mask)
    r = ivf_score.ivf_score_topk_dedup(g, gsq, valid, uniq, rmember, q, 18,
                                       gsc, mask)
    assert _equal(a, r)


def test_ivf_mask_and_routed_plans_equal_flat_on_card(cuda):
    """Phase 3f in small: the IVF mask and routed plans (both on B5
    ``mask=``'s tensor-core scan) give the same bits as each other and as
    the flat index's plans after ``filtered_refine``, at P1/P2/P3-shaped
    predicates; every plan against a CPU engine."""
    from repro_torch.core.filters import F

    corpus, q = _predicate_case(n=8000)
    ixs = {name: fcvi.build(corpus.vectors, corpus.filters,
                            fcvi.FCVIConfig(**cfg), device=cuda)
           for name, cfg in (("flat", {}),
                             ("ivf", dict(backend="ivf", nlist=32,
                                          nprobe=6)))}
    engines = {name: FCVIEngine(ix, EngineConfig(k=10), device=cuda,
                                attributes=corpus.filters)
               for name, ix in ixs.items()}
    cpu = FCVIEngine(fcvi.index_from_state(
        ixs["flat"].config, fcvi.index_state(ixs["flat"]), device="cpu"),
        EngineConfig(k=10), device="cpu", attributes=corpus.filters)
    preds = [F.range("f7", 0.0, 0.6),
             F.eq("f0", 1.0) & F.range("f7", 0.25, 0.75),
             F.eq("f5", 1.0) & F.range("f7", 0.0, 0.1)]
    for pred in preds:
        fs, fi = engines["flat"].search(q, filter=pred, plan="mask")
        for plan in ("mask", "routed"):
            s, i = engines["ivf"].search(q, filter=pred, plan=plan)
            assert np.array_equal(s, fs) and np.array_equal(i, fi), plan
        cs, ci = cpu.search(q, filter=pred)
        assert_topk_match(cs, ci, fs, fi, rtol=1e-5, atol=1e-4)


# -- B9/B10 over the query-innermost LUT; B4's re-rank as one launch ---------

def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("b", [1, 2, 16, 33, 64, 65, 130])
def test_pq_adc_bit_equal_every_width(cuda, b, dtype, m):
    """B9 (and B10 at b = 1) bit for bit against the plain version: n not a
    multiple of any row tile, a tail query group past 64, K past 2^16 for
    int32 codes, codes at a base that is not 16-byte aligned, and rows
    whose LUT entries are all -0.0 (their sums stay -0.0)."""
    rng = np.random.default_rng(b * m)
    k = 70001 if dtype == torch.int32 and b <= 33 else 256
    n = 3001
    raw = rng.integers(0, min(k, 256) if dtype == torch.uint8 else k,
                       n * m + 1)
    raw[1 + 4 * m:1 + 8 * m] = 0       # rows 4..7 of the unaligned view
    flat = tensor(raw, cuda).to(dtype)
    luts = tensor(rng.standard_normal((b, m, k)).astype(np.float32), cuda)
    luts[:, :, 0] = -0.0
    for codes in (flat[1:].view(n, m), flat[:-1].view(n, m)):
        want = ref.ref_pq_score_batch(codes, luts)
        _build.reset_launch_counts()
        assert torch.equal(_bits(ops.pq_score_batch(codes, luts)),
                           _bits(want))
        assert _build.launch_counts() == {"pq_score_batch": 1}
        if b == 1:
            assert torch.equal(_bits(ops.pq_score(codes, luts[0])),
                               _bits(want[0]))
    neg0 = _bits(torch.tensor([-0.0], device=cuda))
    unaligned = flat[1:].view(n, m)
    assert unaligned.data_ptr() % 16
    zero_rows = ref.ref_pq_score_batch(unaligned, luts)[:, 4:8]
    assert bool((_bits(zero_rows) == neg0).all())


def test_pq_adc_equals_a_plain_sum_over_the_query_major_layout(cuda):
    """B9 at a b whose relayout pads (37 queries in rows of 40) equals the
    in-order sum read from ``ref.ref_pq_lut_query_major``'s layout, the
    one the kernel reads."""
    rng = np.random.default_rng(1)
    codes = tensor(rng.integers(0, 300, (777, 8)).astype(np.int32), cuda)
    luts = tensor(rng.random((37, 8, 300)).astype(np.float32), cuda)
    lq = ref.ref_pq_lut_query_major(luts)
    assert lq.shape == (8, 300, 40)
    idx = codes.long()
    total = lq[0][idx[:, 0]]
    for j in range(1, 8):
        total = total + lq[j][idx[:, j]]
    assert torch.equal(total[:, :37].T, ops.pq_score_batch(codes, luts))


def _rerank_case(b, kp, d, m, kind, seed=0, dev="cpu"):
    """Candidate tiles (b, kp, d) / (b, kp, m), queries, lam and int32 ids:
    ``plain`` normal rows; ``ties`` every row repeated in fours (equal
    scores, broken by position); ``zeros`` lam = 1 with rows whose scores
    underflow to -0.0 and +0.0 beside normal ones; ``nan`` NaN columns in
    some rows (their scores are NaN, above every other)."""
    rng = np.random.default_rng(seed)
    cv, cf = normal(rng, b, kp, d), normal(rng, b, kp, m)
    qn, fqn = normal(rng, b, d), normal(rng, b, m)
    lam = 0.6
    if kind == "ties":
        cv = np.repeat(cv[:, ::4], 4, axis=1)[:, :kp]
        cf = np.repeat(cf[:, ::4], 4, axis=1)[:, :kp]
    elif kind == "zeros":
        lam = 1.0
        qn[0] = -1e-30
        sign = np.where(np.arange(kp) % 3 == 0, 1.0, -1.0)[:, None]
        tiny = np.arange(kp) % 2 == 0
        cv[0] = np.abs(cv[0])           # the other rows score below 0
        cv[0, tiny] = (1e-30 * sign[tiny]).astype(np.float32)
        cf[0] = -fqn[0]
    elif kind == "nan":
        cv[:, 3::7, 1] = np.nan
    ids = rng.permutation(10 * kp * b)[:b * kp].reshape(b, kp)
    return ([tensor(a, dev) for a in (cv, cf, qn, fqn)], lam,
            tensor(ids.astype(np.int32), dev))


def _sequence(args, lam, ids, k):
    """What the fused re-rank replaces: ops.rescore, topk_first, gather."""
    vals, pos = ref.topk_first(ops.rescore(*args, lam), k)
    return vals, torch.gather(ids, -1, pos)


@pytest.mark.parametrize("kind", ["plain", "ties", "zeros", "nan"])
@pytest.mark.parametrize("kp", [1, 10, 80, 328, 513, 2056, 12000, 20000])
def test_rescore_topk_bit_equal_to_sequence(cuda, kp, kind):
    """The fused re-rank against ops.rescore + topk_first + gather, bit for
    bit (the sort on the card and on the host agree): every candidate
    ranked against all (kp <= 512), the radix-selected k-th key first
    (past it), and past the capacity (kp = 20000 at d = 64, m = 8) the
    wide route, counted apart."""
    b, d, m, k = (3, 64, 8, 10) if kp > 4096 else (6, 64, 8, 10)
    args, lam, ids = _rerank_case(b, kp, d, m, kind, seed=kp, dev=cuda)
    want = _sequence(args, lam, ids, k)
    host = ref.topk_first(ops.rescore(*args, lam).cpu(), k)
    assert torch.equal(_bits(want[0]).cpu(), _bits(host[0]))
    assert torch.equal(want[1].cpu(), torch.gather(ids.cpu(), -1, host[1]))
    _build.reset_launch_counts()
    got = ops.rescore_topk(*args, lam, ids, k)
    wide = not rescore_kern.fits(kp, d, m)
    assert _build.launch_counts() == {
        "rescore_wide" if wide else "rescore": 1}
    assert got[1].dtype == torch.int32
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])
    if kind == "zeros" and kp >= 10:   # both zeros among query 0's top k
        z = _bits(got[0][0])
        assert bool((z == _bits(torch.tensor([-0.0], device=cuda))).any())
        assert bool((z == 0).any())


@pytest.mark.parametrize("kp", [10, 80, 2056])
def test_rescore_topk_k_equal_kp_bf16_and_int64_ids(cuda, kp):
    """k = kp (the whole sort), bf16 tiles (cast up as ops.rescore casts
    them) and int64 ids, each bit-equal to the sequence."""
    args, lam, ids = _rerank_case(5, kp, 40, 6, "ties", seed=3, dev=cuda)
    for k in (kp, kp + 3):
        got = ops.rescore_topk(*args, lam, ids, k)
        assert got[0].shape == (5, kp)
        assert torch.equal(_bits(got[0]), _bits(_sequence(args, lam, ids,
                                                          k)[0]))
    half = [a.to(torch.bfloat16) for a in args]
    ids64 = ids.long()
    got = ops.rescore_topk(*half, lam, ids64, 7)
    want = _sequence([a.float() for a in half], lam, ids64, 7)
    assert got[1].dtype == torch.int64
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1])


def test_rescore_topk_refuses_and_counts(cuda):
    args, lam, ids = _rerank_case(4, 30, 16, 4, "plain", dev=cuda)
    _build.reset_launch_counts()
    ops.rescore_topk(*args, lam, ids, 5)
    ops.rescore_topk(*args, lam, ids.t().contiguous().t(), 5)
    assert _build.launch_counts() == {"rescore": 2}
    for bad in (lambda: ops.rescore_topk(*args, lam, ids.float(), 5),
                lambda: ops.rescore_topk(*args, lam, ids[:, :5], 5),
                lambda: ops.rescore_topk(args[0].double(), *args[1:], lam,
                                         ids, 5),
                lambda: ops.rescore_topk(args[0], args[1][:, :3], *args[2:],
                                         lam, ids, 5)):
        with pytest.raises(ValueError):
            bad()
    assert _build.launch_counts() == {"rescore": 2}


# -- multi-probe (B4 at d = m) and checkpoints on the card -------------------

@pytest.mark.parametrize("dm", [4, 8, 12])
@pytest.mark.parametrize("cands", [4 * 80, 4 * 328, 4 * 2056])
def test_rescore_at_filter_width_matches_plain(cuda, dm, cands):
    """B4 scores-only as ``multi_probe_query`` calls it: the (b, r * k', m)
    filter tile standing in for both operands at lam = 0, d = m, and the
    vectors at lam = 1; every slot within atol 1e-5 of the plain version."""
    rng = np.random.default_rng(dm + cands)
    cf = tensor(normal(rng, 8, cands, dm), cuda)
    cv = tensor(normal(rng, 8, cands, 32), cuda)
    qn, probe = tensor(normal(rng, 8, 32), cuda), tensor(normal(rng, 8, dm),
                                                         cuda)
    _build.reset_launch_counts()
    got = ops.rescore(cf, cf, probe, probe, 0.0)
    torch.testing.assert_close(got, ref.ref_rescore(cf, cf, probe, probe,
                                                    0.0), rtol=0, atol=1e-5)
    got = ops.rescore(cv, cf, qn, probe, 1.0)
    torch.testing.assert_close(got, ref.ref_rescore(cv, cf, qn, probe, 1.0),
                               rtol=0, atol=1e-5)
    assert _build.launch_counts() == {"rescore": 2}


def _probe_case(dev, backend="flat"):
    corpus = make_corpus(CorpusSpec(n=6000, d=64, n_categories=4,
                                    n_numeric=4, seed=21))
    cfg = fcvi.FCVIConfig(alpha=2.0, lam=0.4, c=16.0) if backend == "flat" \
        else fcvi.FCVIConfig(backend="ivf", nlist=32, nprobe=8)
    cpu_ix = fcvi.build(corpus.vectors, corpus.filters, cfg, device="cpu")
    ix = fcvi.index_from_state(cfg, fcvi.index_state(cpu_ix), device=dev)
    q, _ = sample_queries(corpus, 16, seed=22)
    return corpus, cpu_ix, ix, q


@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_multi_probe_query_on_card_matches_cpu(cuda, backend):
    from repro_torch.core.baselines import BoxPredicate

    corpus, cpu_ix, ix, q = _probe_case(cuda, backend)
    low = torch.full((8,), -float("inf"))
    high = torch.full((8,), float("inf"))
    low[4], high[4] = 0.3, 0.7
    probes = BoxPredicate(low=low, high=high).probes(4)
    fp = probes[None].expand(16, 4, 8).contiguous()
    want = fcvi.multi_probe_query(cpu_ix, tensor(q), fp, 10)
    _build.reset_launch_counts()
    got = fcvi.multi_probe_query(ix, tensor(q, cuda), fp.to(cuda), 10)
    counts = _build.launch_counts()
    assert counts["rescore"] == 5 and counts["fused_transform"] == 1, counts
    ties = np.zeros(16, bool)
    if backend == "ivf":
        from test_torch_support import probe_ties
        tfm = cpu_ix.transform
        qn = tfm.vec_norm.apply(tensor(q))
        q_t = tfm.apply_normalized(qn[:, None].expand(16, 4, 64),
                                   tfm.filt_norm.apply(fp)).reshape(64, -1)
        ties = probe_ties(cpu_ix.backend.centroids.numpy(), q_t.numpy(),
                          8).reshape(16, 4).any(-1)
    keep = ~ties
    assert_topk_match(want[0].numpy()[keep], want[1].numpy()[keep],
                      got[0].cpu().numpy()[keep], got[1].cpu().numpy()[keep],
                      rtol=0.0, atol=1e-5)


def test_bf16_engine_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A bf16 flat engine with pending rows, saved and restored on the
    card: the restored engine's answers, similarity and multi-probe, are
    the saved engine's bits."""
    from repro_torch.core.baselines import BoxPredicate

    corpus = make_corpus(CorpusSpec(n=5000, d=64, n_categories=4,
                                    n_numeric=4, seed=5))
    q, fq = sample_queries(corpus, 64, seed=6)
    index = fcvi.build(corpus.vectors, corpus.filters,
                       fcvi.FCVIConfig(storage_dtype="bfloat16"),
                       device=cuda)
    eng = FCVIEngine(index, EngineConfig(), device=cuda)
    eng.insert(corpus.vectors[:40] + 0.01, corpus.filters[:40])
    eng.save(str(tmp_path))
    again = FCVIEngine.restore(str(tmp_path), device=cuda)
    assert again.index.backend.vectors.dtype == torch.bfloat16
    assert torch.equal(again.index.backend.vectors.view(torch.int16),
                       index.backend.vectors.view(torch.int16))
    s, i = eng.search(q, fq)
    s2, i2 = again.search(q, fq)
    assert np.array_equal(s, s2) and np.array_equal(i, i2)
    assert (i >= 5000).any()
    low = torch.full((8,), -float("inf"))
    high = torch.full((8,), float("inf"))
    low[4], high[4] = 0.3, 0.7
    pred = BoxPredicate(low=low, high=high)
    a, b = eng.search_predicate(q, pred), again.search_predicate(q, pred)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# -- sharded serving (8 shards on one card) and +inf norms -------------------

_DEAD_FRACTIONS = {"eighth": 8, "seven_eighths": 8 / 7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("dead", sorted(_DEAD_FRACTIONS))
@pytest.mark.parametrize("path", ["buffered", "select", "rows", "masked"])
def test_inf_norms_never_compete_on_every_flat_path(cuda, dtype, dead, path):
    """A +inf squared norm (the surviving reference's dead row) scores -inf
    on every flat path: the tensor-core scan with its sample threshold
    (buffered, B3's rows), the selection path's histogram, and the masked
    scan; no dead row is returned while live rows remain, and the results
    equal the plain version's."""
    n, b, kk = 20000, 16, 328
    x, _, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(n, b))
    from repro_torch.index import flat as flat_mod
    fl = flat_mod.build(x, storage_dtype=fcvi.STORAGE_DTYPES[dtype])
    step = _DEAD_FRACTIONS[dead]
    alive = (torch.arange(n, device=cuda) % 8) < (8 - 8 / step)
    alive[:1000] = False                      # and one contiguous block
    sq = torch.where(alive, fl.sq_norms, float("inf"))
    mask = None
    if path == "masked":
        mask = (torch.arange(n, device=cuda) % 3 != 0).to(torch.float32)
    if path == "rows":
        vals, ids, _, rv, _ = ops.score_topk_rows(fl.vectors, sq, pv, pf, q,
                                                  kk, scales=fl.scales)
        assert torch.equal(rv, pv[ids.long()])
    else:
        vals, ids = scan.score_topk(fl.vectors, sq, q, kk, fl.scales, mask,
                                    _select=(path == "select"))
    want_v, want_i = ref.ref_score_topk(fl.vectors, sq, q, kk, fl.scales,
                                        mask)
    assert torch.isfinite(vals).all()
    assert alive[ids.long()].all()
    assert_topk_match(want_v.cpu(), want_i.cpu(), vals.cpu(), ids.cpu(),
                      rtol=L2_RTOL, atol=L2_ATOL)


def _shard_data(cuda, n=20000, d=64):
    corpus = make_corpus(CorpusSpec(n=n, d=d, n_categories=5, n_numeric=3,
                                    seed=21))
    q, fq = sample_queries(corpus, 96, seed=22)
    rng = np.random.default_rng(23)
    rows = rng.integers(0, n, 150)
    new_v = (corpus.vectors[rows]
             + 0.05 * rng.normal(size=(150, d))).astype(np.float32)
    return corpus, q, fq, new_v, corpus.filters[rows]


def _card_mesh(cuda, n=8):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n, 1), ("data", "model"), device=cuda)


@pytest.mark.parametrize("gather_free", [True, False])
@pytest.mark.parametrize("backend,placement,storage", [
    ("flat", "contiguous", "float32"), ("flat", "cluster", "bfloat16"),
    ("flat", "cluster", "int8"), ("ivf", "balanced", "float32"),
    ("ivf", "affinity", "int8"), ("pq", "contiguous", "float32")])
def test_eight_shards_on_one_card_bit_equal_to_meshless(cuda, backend,
                                                        placement, storage,
                                                        gather_free):
    """8 shards on cuda:0: each launches its own scan (the launch counts
    move by 8 a batch), the results equal the meshless engine's bit for
    bit, with escalations and a delta tier the shards scan; routed (flat
    cluster, IVF) equals them too."""
    corpus, q, fq, new_v, new_f = _shard_data(cuda)
    kw = {"flat": {}, "ivf": dict(backend="ivf", nlist=64, nprobe=8),
          "pq": dict(backend="pq", pq_ksub=64, pq_coarse=8)}[backend]
    idx = fcvi.build(corpus.vectors, corpus.filters,
                     fcvi.FCVIConfig(storage_dtype=storage, **kw),
                     device=cuda)
    ek = dict(gather_free=gather_free, escalate_margin=0.1)
    e0 = FCVIEngine(idx, EngineConfig(**ek), device=cuda)
    e1 = FCVIEngine(idx, EngineConfig(**ek), device=cuda,
                    mesh=_card_mesh(cuda), placement=placement)
    want = e0.search(q, fq)
    _build.reset_launch_counts()
    got = e1.search(q, fq)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    scans = sum(v for name, v in _build.launch_counts().items()
                if name.startswith(("score_topk", "ivf_score_topk",
                                    "pq_score_topk")))
    assert scans >= 8 * 2                 # two batches of 64, 8 shards each
    for e in (e0, e1):
        e.insert(new_v, new_f)
    got = e1.search(q, fq)
    want = e0.search(q, fq)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    if backend != "pq" and (backend == "ivf" or placement == "cluster"):
        er = FCVIEngine(idx, EngineConfig(**ek), device=cuda,
                        mesh=_card_mesh(cuda), placement=placement,
                        routing="routed")
        er.insert(new_v, new_f)
        got = er.search(q, fq)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert er.stats.routed_batches > 0


@pytest.mark.parametrize("backend,placement,routing", [
    ("flat", "cluster", "routed"), ("flat", "contiguous", "dense"),
    ("ivf", "balanced", "routed")])
def test_dead_shards_on_the_card_equal_surviving_reference(
        cuda, backend, placement, routing, tmp_path):
    """Shard 3 dead, then 3 and 6: bit-equal to the surviving reference on
    the card (flat: +inf norms through the scan), coverage never
    under-flagged; heal back to a meshless restore's bits."""
    from repro_torch.serve import faultinject as fi

    corpus, q, fq, new_v, new_f = _shard_data(cuda)
    kw = dict(backend="ivf", nlist=64, nprobe=8) if backend == "ivf" else {}
    idx = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(**kw),
                     device=cuda)
    eng = FCVIEngine(idx, EngineConfig(escalate_margin=0.1), device=cuda,
                     mesh=_card_mesh(cuda), placement=placement,
                     routing=routing)
    eng.insert(new_v, new_f)
    healthy = eng.search(q, fq)[1]
    for dead in ([3], [6]):
        eng.health.mark_dead(dead)
        got = eng.search(q, fq)
        want = fi.surviving_reference(eng).search(q, fq)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        mask = fi.surviving_row_mask(eng)
        n = eng.index.size
        affected = np.array([(~mask[r[r < n]]).any() for r in healthy])
        assert not (affected & eng.stats.last_coverage).any()
    assert eng.heal(str(tmp_path), q, fq) is True
    assert eng._sharded.n_shards == 6
    got = eng.search(q, fq)
    assert eng.stats.last_coverage.all()
    ref_eng = FCVIEngine.restore(str(tmp_path), device=cuda)
    want = ref_eng.search(q, fq)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("backend", ["flat", "ivf"])
def test_predicates_over_shards_on_the_card(cuda, backend):
    """The mask and routed plans over 8 shards (B2 masked per shard, B5
    ``mask=`` per shard) equal the meshless engine's bits."""
    from repro_torch.core.filters import F

    corpus, q, _, _, _ = _shard_data(cuda)
    kw = dict(backend="ivf", nlist=64, nprobe=8) if backend == "ivf" else {}
    idx = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(**kw),
                     device=cuda)
    e0 = FCVIEngine(idx, EngineConfig(), device=cuda)
    e1 = FCVIEngine(idx, EngineConfig(), device=cuda, mesh=_card_mesh(cuda),
                    placement="cluster")
    for pred in (F.range("f5", 0.1, 0.9),
                 F.eq("f1", 1.0) & F.range("f6", 0.0, 0.5),
                 F.eq("f0", 1.0) & F.range("f5", 0.0, 0.03)):
        want = e0.search(q, filter=pred)
        for plan in ("mask", "routed"):
            got = e1.search(q, filter=pred, plan=plan)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


# -- the LM embedder's serving path (plain PyTorch on the card) ---------------

LM_DENSE = ["gemma3-1b", "gemma2-27b", "mistral-nemo-12b", "starcoder2-7b",
            "internvl2-26b", "granite-moe-3b-a800m", "dbrx-132b",
            "recurrentgemma-2b", "xlstm-125m", "whisper-large-v3"]
NEAR_TIE = 0.01     # router probabilities k-th and (k+1)-th within 1%


def _lm_case(arch, dev, seed=0, serve=False):
    """A reduced arch with weights from ``seed`` on the CPU and the same
    weights on ``dev``, and a batch of 143 tokens (past the local caches'
    128 slots) with the vision stub's patches or the encoder-decoder's 16
    frames where it has them. ``serve``: MoE at capacity 8.0 (the
    reference's serving check; nothing dropped)."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as lm

    cfg = reduced(get_config(arch))
    if serve and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    cpu = lm.init_params(seed, cfg, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    r = np.random.default_rng(seed)
    batch = {"tokens": torch.tensor(r.integers(0, cfg.vocab_size, (2, 143))
                                    .astype(np.int32))}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.tensor(
            r.normal(size=(2, cfg.n_prefix, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        batch["frames"] = torch.tensor(
            r.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    return cfg, cpu, card, batch


def _routes(model, batch):
    """(final hidden states, each MoE layer's (probs, experts, keep) on the
    CPU) of a forward on ``model``'s device."""
    from repro_torch.models import model as lm
    from repro_torch.models import moe

    routes, route = [], moe.route

    def record(*a):
        out = route(*a)
        routes.append(tuple(out[i].cpu() for i in (0, 2, 4)))
        return out

    moe.route = record
    try:
        h = lm.forward_hidden(model, {k: v.to(model.device)
                                      for k, v in batch.items()})
    finally:
        moe.route = route
    return h, routes


def _rel(a, b):
    """The largest row-relative error of ``a`` against ``b``."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


@pytest.mark.parametrize("arch", LM_DENSE)
def test_lm_forward_on_the_card_matches_the_cpu(cuda, arch, monkeypatch):
    """The same weights on the card and on the CPU (the plain path): the two
    sum each bf16 matmul's fp32 products in their own order, so the card's
    final hidden states are held as the CPU test holds the port to the
    reference: within 1.5 times the CPU's distance from the same function
    without bf16 rounding, the mean-pooled embeddings to cosine >= 0.9999,
    the logits to 0.15. An MoE arch (at the default capacity 1.25) keeps
    the CPU's (token, expert) set outside router near-ties: a token's first
    layer routed otherwise is a near-tie on the CPU (its k-th and (k+1)-th
    probabilities within 1%), and such tokens are left out of the logits'
    bound (a flip moves them by an expert's whole share)."""
    import copy

    from repro_torch.models import layers
    from repro_torch.models import model as lm

    cfg, cpu, card, batch = _lm_case(arch, cuda)
    want, host_routes = _routes(cpu, batch)
    got, card_routes = _routes(card, batch)
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    # MoE at the default capacity 1.25: the same kept (token, expert) set,
    # outside tokens whose top-k sits at a router near-tie on the CPU
    assert len(card_routes) == len(host_routes) == (
        cfg.n_layers if cfg.is_moe else 0)
    flipped = torch.zeros(got.shape[:2], dtype=torch.bool)
    for (_, e_c, k_c), (p_h, e_h, k_h) in zip(card_routes, host_routes):
        srt = torch.sort(p_h, dim=-1, descending=True).values
        k = cfg.moe_top_k
        tie = (srt[:, k - 1] - srt[:, k]) <= NEAR_TIE * srt[:, k - 1]
        same = (torch.sort(e_c, -1).values == torch.sort(e_h, -1).values
                ).all(-1)
        assert bool((same | tie | flipped.reshape(-1)).all())
        if bool(same.all()):
            assert torch.equal(k_c, k_h)
        flipped |= ~same.reshape(flipped.shape)
    hi = copy.deepcopy(cpu).double()
    with monkeypatch.context() as m:
        m.setattr(layers, "COMPUTE_DTYPE", torch.float64)
        exact = lm.forward_hidden(hi, batch)
    assert _rel(got, want) <= 1.5 * _rel(want, exact)
    cos = torch.nn.functional.cosine_similarity(
        got.float().mean(1).cpu(), want.float().mean(1), dim=-1)
    assert float(cos.min()) >= 0.9999
    # a token routed otherwise at a near-tie differs by an expert's share
    lg = lm._logits(card, got).cpu()[~flipped]
    assert float((lg - lm._logits(cpu, want)[~flipped]).abs().max()) <= 0.15
    # the same hidden state on both: the logits agree to fp32 sums
    same = lm._logits(card, want.to(cuda)).cpu()
    assert float((same - lm._logits(cpu, want)).abs().max()) <= 0.05


@pytest.mark.parametrize("arch", LM_DENSE)
def test_lm_prefill_and_decode_on_the_card(cuda, arch):
    """Prefill past the local caches (they roll), then decode: the caches'
    integer state equals the CPU's at every step, each step's logits lie
    within 0.15 of the CPU's and of the card's own teacher-forced forward
    (the reference test's drift bound)."""
    from repro_torch.models import model as lm

    cfg, cpu, card, batch = _lm_case(arch, cuda, seed=1, serve=True)
    prefix = cfg.n_prefix if cfg.frontend == "vision_stub" else 0
    n, steps = 136, 7
    max_len = prefix + n + steps
    tokens = batch["tokens"]
    pb = dict(batch, tokens=tokens[:, :n])
    lp_c, cache_c = lm.prefill(cpu, pb, max_len)
    lp_g, cache_g = lm.prefill(card, {k: v.to(cuda) for k, v in pb.items()},
                               max_len)
    full = lm.forward(card, {k: v.to(cuda) for k, v in batch.items()})
    mine, ref = [lp_g[:, 0]], [lp_c[:, 0]]
    for t in range(n, n + steps - 1):
        for a, b in zip(cache_g["self"], cache_c["self"]):
            if "slot_pos" in b:
                assert torch.equal(a["slot_pos"].cpu(), b["slot_pos"])
                assert int(a["pos"]) == int(b["pos"])
            else:
                assert {name: x.dtype for name, x in a.items()} == {
                    name: x.dtype for name, x in b.items()}
        lg, cache_c = lm.decode_step(cpu, tokens[:, t:t + 1], cache_c)
        ref.append(lg[:, 0])
        lg, cache_g = lm.decode_step(card, tokens[:, t:t + 1].to(cuda),
                                     cache_g)
        mine.append(lg[:, 0])
    for i, (m, r) in enumerate(zip(mine, ref)):
        assert m.device.type == "cuda" and bool(torch.isfinite(m).all())
        assert float((m.cpu() - r).abs().max()) <= 0.15
        drift = float((m - full[:, prefix + n - 1 + i]).abs().max())
        assert drift < 0.15, f"decode drift {drift} at step {i}"


# -- the model's shardings on logical positions of the card -------------------

def _shard_parts(dev):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(4, 6, generator=g).to(dev).requires_grad_()
            for _ in range(3)]


def test_shard_collectives_on_the_card_match_the_host(cuda):
    """Each collective of the mesh layer, forward and backward, on three
    logical positions of the card against the same on the host: bit for
    bit (fp32 sums in one order, copies and cuts); the same bytes
    counted."""
    from repro_torch.distributed import sharding as S

    out = []
    for dev in (torch.device("cpu"), cuda):
        stats = S.CollectiveStats()
        grp = S.AxisGroup([dev] * 3, "model", stats)
        parts = _shard_parts(dev)
        x = parts[0].detach().clone().requires_grad_()
        with torch.enable_grad():
            res = [grp.psum(parts), *grp.broadcast(x),
                   *grp.all_gather(parts, 1), *grp.reduce_scatter(parts, 1),
                   *grp.all_to_all(parts, 1, 0), *grp.split(x, 1)]
            loss = sum((r.float() * (i + 1)).sum()
                       for i, r in enumerate(res))
            grads = torch.autograd.grad(loss, parts + [x])
        out.append(([r.detach().cpu() for r in res],
                    [g.cpu() for g in grads], stats.by_kind))
    (rh, gh, sh), (rc, gc, sc) = out
    assert all(torch.equal(a, b) for a, b in zip(rh, rc))
    assert all(torch.equal(a, b) for a, b in zip(gh, gc))
    assert sh == sc


def _step_case(arch, dev, mesh_shape, axes, rules_fn, unrounded=False):
    """One sharded step of reduced ``arch`` on ``dev``'s logical mesh, from
    the state after one unsharded step on the host; the new params joined
    on the host (float64) and the metrics."""
    import copy

    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    from repro_torch.models import model as lm
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt
    from test_torch_support import fp32_hop_step

    cfg = reduced(get_config(arch))
    adamw = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    r = np.random.default_rng(0)
    b0, b1 = ({"tokens": torch.tensor(r.integers(0, cfg.vocab_size, (8, 32))
                                      .astype(np.int32))} for _ in range(2))
    model = lm.init_params(0, cfg, device="cpu")
    model, state, _ = loop.make_train_step(cfg, adamw)(
        model, opt.init(dict(model.named_parameters())), b0)
    model = copy.deepcopy(model).to(dev)
    if unrounded:
        model = model.double()
    state = opt.AdamWState(step=state.step.to(dev), **{
        f: {k: v.to(dev) for k, v in getattr(state, f).items()}
        for f in ("mu", "nu", "master")})
    rules = rules_fn(make_mesh(mesh_shape, axes, device=dev))
    params, st, zspecs = loop.place_train_state(model, state, rules)
    keep = layers.COMPUTE_DTYPE
    if unrounded:
        layers.COMPUTE_DTYPE = torch.float64
    try:
        with S.use_rules(rules):
            new, _, m = fp32_hop_step(cfg, adamw, grad_shardings=zspecs)(
                params, st, loop.place_batch(b1, rules, dev))
    finally:
        layers.COMPUTE_DTYPE = keep
    flat = torch.cat([S.join(new[k]).double().cpu().reshape(-1)
                      for k in sorted(new)])
    return flat, {k: float(v) for k, v in m.items() if k != "collectives"}


SHARD_CASES = [  # (arch, mesh shape, axes, rules): the two layouts
    ("gemma3-1b", (2, 2, 2), ("pod", "data", "model"), "arch"),
    ("mistral-nemo-12b", (4, 2), ("data", "model"), "default"),
]


@pytest.mark.parametrize("arch,shape,axes,rules", SHARD_CASES,
                         ids=[c[0] for c in SHARD_CASES])
def test_sharded_step_on_the_card_matches_the_host(cuda, arch, shape, axes,
                                                   rules):
    """The sharded step at reduced widths on logical positions of the card
    against the same step on the host: the card's new params no further
    from the host's than 1.5 times the host's distance from its step
    without bf16 rounding (the CPU tests' rule), the loss and gradient
    norm finite and within 1e-3."""
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch.specs import TRAIN_EXTRA_RULES, arch_rules

    def make_rules(mesh):
        if rules == "default":
            return AxisRules(mesh)
        return arch_rules(mesh, arch, TRAIN_EXTRA_RULES.get(arch))

    card, mc = _step_case(arch, cuda, shape, axes, make_rules)
    host, mh = _step_case(arch, torch.device("cpu"), shape, axes, make_rules)
    exact, _ = _step_case(arch, torch.device("cpu"), shape, axes, make_rules,
                          unrounded=True)
    assert bool(torch.isfinite(card).all())
    assert float(torch.linalg.norm(card - host)) <= 1.5 * float(
        torch.linalg.norm(host - exact))
    for k in ("loss", "grad_norm"):
        assert abs(mc[k] - mh[k]) <= 1e-3 * abs(mh[k]), (k, mc[k], mh[k])
