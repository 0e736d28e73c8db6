"""The re-rank in one launch (``ops.rescore_topk``) and the query-innermost
ADC scan (B9/B10) on the CPU, against the JAX package and their planners.

On the CPU ``ops.rescore_topk`` is ``ref.ref_rescore_topk``: the plain
scores, ``topk_first`` and a gather of the ids. It is held against the JAX
package's ``fcvi.rescore`` on handed-over state and, for raw candidate
tiles, against ``repro.kernels.ops.rescore(..., use_pallas=True)`` (the
Pallas kernel in interpret mode) followed by ``lax.top_k`` and
``take_along_axis``: the same numpy inputs from one seed, ids equal outside
near-ties, scores within atol 1e-5 (the two sum the cosines in different
orders). The card's kernels are held bit for bit against these plain
versions in ``tests/test_torch_gpu.py``; here their planners are checked at
every shape they take, and B9's lane mapping is emulated in numpy.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from jax import lax
from repro.core import fcvi as jfcvi
from repro.kernels import ops as jops
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.kernels import ops, pq_lut, ref
from repro_torch.kernels import rescore as rescore_kern
from test_torch_support import (assert_topk_match, normal, tensor,
                                to_numpy_tree)

TOL = dict(rtol=0.0, atol=1e-5)


def _tiles(b, kp, d, m, seed):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(50 * kp)[:b * kp].reshape(b, kp)
    return (normal(rng, b, kp, d), normal(rng, b, kp, m), normal(rng, b, d),
            normal(rng, b, m), ids)


@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kp,k", [(10, 10), (80, 10), (328, 10),
                                  (2056, 64)])
def test_rescore_topk_matches_pallas_rescore_and_top_k(kp, k, id_dtype):
    """Raw tiles: the port's re-rank against the Pallas rescore in
    interpret mode, lax.top_k and take_along_axis."""
    cv, cf, qn, fqn, ids = _tiles(8, kp, 32, 6, seed=kp)
    ids = ids.astype(id_dtype)
    vals, got = ops.rescore_topk(*map(tensor, (cv, cf, qn, fqn)), 0.6,
                                 tensor(ids), k)
    assert got.dtype == tensor(ids).dtype and vals.shape == (8, k)
    score = jops.rescore(*map(jnp.asarray, (cv, cf, qn, fqn)), 0.6,
                         use_pallas=True)
    jv, pos = lax.top_k(score, min(k + 1, kp))
    jv, ji = np.asarray(jv), np.asarray(
        jnp.take_along_axis(jnp.asarray(ids), pos, axis=-1))
    assert_topk_match(jv[:, :k], ji[:, :k], vals, got,
                      next_vals=jv[:, k] if k < kp else None, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fcvi_rescore_matches_jax_on_handed_over_state(use_pallas):
    corpus = make_corpus(CorpusSpec(n=3000, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 16, seed=3)
    jidx = jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters),
                       jfcvi.FCVIConfig(use_pallas=use_pallas))
    idx = fcvi.index_from_state(fcvi.FCVIConfig(),
                                to_numpy_tree(jfcvi.index_state(jidx)),
                                device="cpu")
    qn, fqn = idx.transform.normalize(tensor(q), tensor(fq))
    jqn, jfqn = jidx.transform.normalize(jnp.asarray(q), jnp.asarray(fq))
    cand = np.random.default_rng(1).integers(0, 3000, (16, 80))
    cand = cand.astype(np.int32)
    vals, ids = fcvi.rescore(idx, qn, fqn, tensor(cand), 10)
    jv, ji = jfcvi.rescore(jidx, jqn, jfqn, jnp.asarray(cand), 10)
    assert ids.dtype == torch.int32
    assert_topk_match(jv, ji, vals, ids, **TOL)


def test_rescore_topk_is_the_sequence_it_replaces():
    """On the CPU the re-rank is rescore, topk_first and the gather, k
    clamped to kp as topk_first's slice is; ties go to the smaller
    position."""
    cv, cf, qn, fqn, ids = map(tensor, _tiles(4, 40, 16, 4, seed=5))
    cv[:, 20:] = cv[:, :20]
    cf[:, 20:] = cf[:, :20]
    for k in (1, 10, 40, 45):
        vals, got = ops.rescore_topk(cv, cf, qn, fqn, 0.5, ids, k)
        s = ops.rescore(cv, cf, qn, fqn, 0.5)
        want, pos = ref.topk_first(s, k)
        assert torch.equal(vals, want)
        assert torch.equal(got, torch.gather(ids, -1, pos))
        assert vals.shape == (4, min(k, 40))
        # each tied pair (j, j + 20) comes out smaller position first
        first = {int(p): i for i, p in enumerate(pos[0])}
        assert all(first[j] < first[j + 20] for j in range(20)
                   if j in first and j + 20 in first)


def test_rescore_wide_route_planner_every_kp():
    """The fused re-rank takes kp while its padded sort's words, the kp
    scores and the query's columns fit in a block's shared memory, at
    every kp to 50,000: up to 19,152 at d = 128, m = 8, fewer for wider
    rows, the wide route past it; the boundary is where topk_smem crosses
    the limit."""
    limit = rescore_kern.TOPK_SMEM_LIMIT
    for d, m, last in ((128, 8, 19152), (960, 8, 18876), (20000, 8, 12528)):
        fits = [rescore_kern.fits(kp, d, m) for kp in range(1, 50001)]
        assert fits == [kp <= last for kp in range(1, 50001)]
        assert rescore_kern.topk_smem(last, d, m) <= limit
        assert rescore_kern.topk_smem(last + 1, d, m) > limit
    assert rescore_kern.topk_smem(81, 128, 8) == 4 * (3 * 84 + 136)
    assert limit + 2048 == rescore_kern.SMEM_LIMIT == 232_448


def _check_part(p, b, m, code_bytes, bp):
    assert p.qp & (p.qp - 1) == 0 and 1 <= p.qp <= pq_lut.ADC_GROUP
    assert p.vec == min(4, p.qp) and p.lanes * p.vec == p.qp
    assert 32 % p.lanes == 0
    step = 8 * pq_lut.ADC_UNROLL * (32 // p.lanes)
    assert p.rows & (p.rows - 1) == 0 and p.rows >= pq_lut.ADC_MIN_ROWS
    assert p.smem == pq_lut.adc_smem(p.qp, p.rows, m, code_bytes)
    assert p.smem <= pq_lut.SMEM_LIMIT
    assert p.smem <= pq_lut.ADC_SMEM_TARGET or p.rows == pq_lut.ADC_MIN_ROWS
    # halved only as far as two blocks an SM need
    assert p.rows == max(pq_lut.ADC_ROWS, step) or pq_lut.adc_smem(
        p.qp, 2 * p.rows, m, code_bytes) > pq_lut.ADC_SMEM_TARGET
    # every group's widest load stays in the relayout row, aligned
    assert p.q0 % p.vec == 0 and bp % p.vec == 0
    last = p.q0 + (p.groups - 1) * p.qp
    width = p.nq - (p.groups - 1) * p.qp
    assert 0 < width <= p.qp
    assert last + -(-width // p.vec) * p.vec <= bp
    assert p.groups * p.qp >= p.nq > (p.groups - 1) * p.qp


@pytest.mark.parametrize("code_bytes", [1, 4])
@pytest.mark.parametrize("m", [8, 16, 64, 128])
def test_adc_planner_every_b(m, code_bytes):
    """B9's plan at every b from 1 to 256: the parts cover the queries once
    (groups of 64, then a tail group of its own width), each group's lanes,
    vector width, rows a tile and shared memory agree with the source's
    rules, and the LUT row bp holds every lane's load."""
    n = 1_000_003
    for b in range(1, 257):
        p = pq_lut.adc_plan(n, b, m, 8192, code_bytes)
        assert p.bp >= b and p.relayout == (b > 1)
        covered = []
        for part in p.parts:
            _check_part(part, b, m, code_bytes, p.bp)
            covered += range(part.q0, part.q0 + part.nq)
            assert part.tiles == -(-n // part.rows)
        assert covered == list(range(b))
        assert len(p.parts) == (2 if b > 64 and b % 64 else 1)
        if b <= 64:
            assert p.parts[0].qp == 1 << (b - 1).bit_length()


def test_adc_planner_offsets_past_int32():
    """Output and LUT offsets past 2^31 (the source computes them in 64
    bits); the row tiles still fit the grid; a row of codes too wide for
    shared memory is refused."""
    p = pq_lut.adc_plan(2 ** 26 + 3, 64, 8, 8192, 4)
    assert p.out_span > 2 ** 31 and p.parts[0].tiles < 2 ** 31
    p = pq_lut.adc_plan(1000, 130, 128, 2 ** 22, 4)
    assert p.lut_span == 128 * 2 ** 22 * 132 > 2 ** 31
    with pytest.raises(ValueError):
        pq_lut.adc_plan(1000, 64, 4096, 256, 4)


def emulate_adc(codes: np.ndarray, luts: np.ndarray) -> np.ndarray:
    """B9's scan as the source maps it (tiles, query groups, warps, row
    steps, lanes on query slots then rows), over the plain relayout; every
    (query, row) must be written exactly once."""
    n, m = codes.shape
    b, _, k = luts.shape
    plan = pq_lut.adc_plan(n, b, m, k, 4)
    lq = ref.ref_pq_lut_query_major(torch.from_numpy(luts)).numpy()
    assert lq.shape[-1] == plan.bp
    out = np.full((b, n), np.nan, np.float32)
    hits = np.zeros((b, n), np.int64)
    for p in plan.parts:
        rw = 32 // p.lanes
        step = rw * pq_lut.ADC_UNROLL
        for tile in range(p.tiles):
            row0 = tile * p.rows
            rows = min(p.rows, n - row0)
            for g in range(p.groups):
                qg0 = p.q0 + g * p.qp
                qn = min(p.qp, p.q0 + p.nq - qg0)
                for thread in range(pq_lut.THREADS):
                    warp, lane = divmod(thread, 32)
                    lr, qoff = lane // p.lanes, (lane % p.lanes) * p.vec
                    if qoff >= qn:
                        continue
                    cols = qg0 + qoff + np.arange(p.vec)
                    assert cols[-1] < plan.bp
                    for r0 in range(warp * step, rows, 8 * step):
                        for u in range(pq_lut.ADC_UNROLL):
                            rr = r0 + u * rw + lr
                            if rr >= rows:
                                continue
                            c = codes[row0 + rr]
                            acc = lq[0, c[0], cols]
                            for j in range(1, m):
                                acc = acc + lq[j, c[j], cols]
                            live = qoff + np.arange(p.vec) < qn
                            out[cols[live], row0 + rr] = acc[live]
                            hits[cols[live], row0 + rr] += 1
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize("b", [1, 3, 16, 33, 65, 130])
def test_adc_lane_mapping_covers_and_sums_in_order(b):
    """The emulated scan writes each distance once and equals the plain
    version bit for bit (the in-order fp32 sum started from m = 0)."""
    rng = np.random.default_rng(b)
    n = 700 if b < 100 else 300
    codes = rng.integers(0, 50, (n, 4)).astype(np.int32)
    luts = rng.standard_normal((b, 4, 50)).astype(np.float32)
    luts[:, :, 0] = -0.0
    codes[:3] = 0
    got = emulate_adc(codes, luts)
    want = ref.ref_pq_score_batch(torch.from_numpy(codes),
                                  torch.from_numpy(luts)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:, :3].view(np.int32) == np.float32(-0.0).view(np.int32)).all()


@pytest.mark.parametrize("b", [1, 2, 3, 5, 64, 130])
def test_query_major_relayout_is_a_padded_transpose(b):
    luts = np.random.default_rng(b).random((b, 3, 17)).astype(np.float32)
    got = ref.ref_pq_lut_query_major(torch.from_numpy(luts)).numpy()
    vec = min(4, 1 << (b - 1).bit_length())
    bp = -(-b // vec) * vec
    assert bp == pq_lut.adc_plan(10, b, 3, 17, 4).bp
    want = np.zeros((3, 17, bp), np.float32)
    want[:, :, :b] = np.transpose(luts, (1, 2, 0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,k,b", [(2500, 8, 256, 5), (700, 4, 64, 33),
                                     (300, 8, 256, 65)])
def test_adc_through_the_relayout_matches_pallas(n, m, k, b):
    """B9 over the query-innermost LUT (the emulated scan) against the JAX
    package's pq_score_batch, its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(n + b)
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    luts = rng.random((b, m, k)).astype(np.float32)
    got = emulate_adc(codes, luts)
    want = jops.pq_score_batch(jnp.asarray(codes), jnp.asarray(luts),
                               use_pallas=True)
    np.testing.assert_array_equal(got, np.asarray(want))
