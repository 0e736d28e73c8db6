"""The port's PQ kernel modules (B8, B9, B10) against the JAX package's.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions; they
are held against ``repro.kernels.ops`` with the Pallas kernels in interpret
mode (``use_pallas=True``) and with the jnp references (``False``), on the
same numpy operands, at the JAX tests' PQ shapes (d=32, M=8, ksub=32,
ncoarse=8, so a combined LUT is 8 x 256 wide) and at b = 1 and a ragged n.
Tolerances: rtol = atol = 1e-5 (B8's dot products and the jnp reference's
sum round differently); the ADC sums are left-to-right fp32 sums in both the
port and the Pallas kernel, which adds one LUT value per subspace, so B9 and
B10 match the kernel path to that tolerance and the port's own in-order sum
exactly. uint8 and int32 codes give the same sums bit for bit. Each CUDA
kernel is held against its plain version in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from jax import lax
from repro.kernels import ops as jops
from repro_torch.index import pq
from repro_torch.kernels import _build, ops, pq_lut, ref
from test_torch_support import normal, tensor

TOL = dict(rtol=1e-5, atol=1e-5)


def adc_inputs(n, m, k, b, seed=0):
    """codes (n, m) int32 in [0, k) and luts (b, m, k) float32."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    luts = rng.random((b, m, k)).astype(np.float32)
    return codes, luts


def in_order_sum(codes, lut):
    """The left-to-right fp32 sum over m of lut[m, codes[:, m]] (numpy)."""
    total = np.zeros(codes.shape[0], np.float32)
    for m in range(codes.shape[1]):
        total = total + lut[m][codes[:, m]]
    return total


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("b,m,dsub,ksub", [(64, 8, 4, 32), (1, 8, 4, 32),
                                           (5, 4, 16, 32), (130, 2, 8, 16)])
def test_pq_lut_qdot_matches_jax(use_pallas, b, m, dsub, ksub):
    rng = np.random.default_rng(b + ksub)
    qs, cb = normal(rng, b, m, dsub), normal(rng, m, ksub, dsub)
    got = ops.pq_lut_qdot(tensor(qs), tensor(cb))
    want = jops.pq_lut_qdot(jnp.asarray(qs), jnp.asarray(cb),
                            use_pallas=use_pallas)
    assert got.shape == (b, m, ksub) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,m,k,b", [(2500, 8, 256, 5), (4099, 8, 256, 1),
                                     (500, 4, 32, 3)])
def test_pq_score_batch_matches_jax(use_pallas, n, m, k, b):
    """Combined-code widths (K = ncoarse * ksub = 256), b = 1 and rows that
    are no multiple of the Pallas row block."""
    codes, luts = adc_inputs(n, m, k, b, seed=n + b)
    got = ops.pq_score_batch(tensor(codes), tensor(luts))
    want = jops.pq_score_batch(jnp.asarray(codes), jnp.asarray(luts),
                               use_pallas=use_pallas)
    assert got.shape == (b, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(b):
        np.testing.assert_array_equal(got[i].numpy(),
                                      in_order_sum(codes, luts[i]))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,m,k", [(1024, 8, 32), (512, 4, 256)])
def test_pq_score_matches_jax(use_pallas, n, m, k):
    """n divides the Pallas kernel's 512-row block (it raises otherwise)."""
    codes, luts = adc_inputs(n, m, k, 1, seed=m)
    got = ops.pq_score(tensor(codes), tensor(luts[0]))
    want = jops.pq_score(jnp.asarray(codes), jnp.asarray(luts[0]),
                         use_pallas=use_pallas)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_pq_score_ragged_n_matches_in_order_sum(n):
    """Row counts the JAX kernel refuses: the port takes any n."""
    codes, luts = adc_inputs(n, 8, 256, 1, seed=n)
    got = ops.pq_score(tensor(codes), tensor(luts[0]))
    np.testing.assert_array_equal(got.numpy(), in_order_sum(codes, luts[0]))
    batch = ops.pq_score_batch(tensor(codes), tensor(luts))
    assert torch.equal(batch[0], got)


def test_uint8_and_int32_codes_give_the_same_sums():
    """uint8 codes are widened before every gather: a uint8 index tensor
    would be taken as a boolean mask. n == K makes the shapes line up, the
    case where a mask would index without an error."""
    codes, luts = adc_inputs(256, 8, 256, 3, seed=7)
    c8, c32 = tensor(codes.astype(np.uint8)), tensor(codes)
    assert torch.equal(ops.pq_score_batch(c8, tensor(luts)),
                       ops.pq_score_batch(c32, tensor(luts)))
    assert torch.equal(ops.pq_score(c8, tensor(luts[1])),
                       ops.pq_score(c32, tensor(luts[1])))
    np.testing.assert_array_equal(ops.pq_score(c8, tensor(luts[1])).numpy(),
                                  in_order_sum(codes, luts[1]))


@pytest.mark.parametrize("n,k", [(1000, 1), (1000, 80), (5000, 320),
                                 (64, 64)])
def test_topk_first_packed_equals_stable_sort(n, k):
    """The ADC top-k keeps the first occurrence like ``lax.top_k``: small
    integers tie often. Row 0 holds -0.0 and +0.0, which ``lax.top_k``
    orders by sign and ``topk_first`` counts equal; elsewhere the two
    agree."""
    rng = np.random.default_rng(n + k)
    x = tensor(rng.integers(-6, 6, (5, n)).astype(np.float32) * 0.25)
    x[0, :3] = tensor([0.0, -0.0, 0.0])
    x[1] = tensor(normal(rng, n) * 1e30)
    vals, pos = ref.topk_first_packed(x, k)
    want_v, want_p = ref.topk_first(x[1:], k)
    assert torch.equal(vals[1:], want_v) and torch.equal(pos[1:], want_p)
    jv, jp = lax.top_k(jnp.asarray(x.numpy()), k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))


def test_pq_wrapper_shape_checks_and_cpu_dispatch():
    codes, luts = adc_inputs(300, 8, 64, 2)
    _build.reset_launch_counts()
    ops.pq_score_batch(tensor(codes), tensor(luts))
    ops.pq_score(tensor(codes), tensor(luts[0]))
    ops.pq_lut_qdot(tensor(luts[:, :, :4]).contiguous(),
                    tensor(normal(np.random.default_rng(0), 8, 16, 4)))
    assert _build.launch_counts() == {}
    # B8's shape: the cross term (8, 256), cb_sq, a 16-column chunk of the
    # codewords (an odd stride) and of the queries (16-byte rows)
    assert pq_lut.luts_smem(8, 256, 0, 16) == 4 * (8 * 256 + 256 + 256 * 17
                                                   + 8 * 16)
    with pytest.raises(ValueError, match="uint8 or int32"):
        pq_lut.pq_score_batch(tensor(codes).long(), tensor(luts))
    with pytest.raises(ValueError, match="3-D"):
        pq_lut.pq_lut_qdot(tensor(luts[0]), tensor(luts))
    # a (4096, 64) codebook (1 MB) is no longer refused: its codewords are
    # tiled into chunks whose staged columns fit (held on the card in
    # tests/test_torch_gpu.py)
    p = pq_lut.luts_plan(2, 1, 4096, 64, 0, 132)
    assert p.kc < 4096 and p.kc % 4 == 0 and p.smem <= pq_lut.SMEM_LIMIT
    assert p.blocks == -(-4096 // p.kc)


# -- the serving path's fused ADC scan + top-k (its plain version here; the
# -- kernel is held to it bit for bit in tests/test_torch_gpu.py) ----------

def test_grouped_layout_is_stable_with_count_offsets():
    """The fused scan's layout: rows in a stable order by coarse id (row
    ids ascend inside each group), offsets = the groups' counts summed (an
    empty group included), the ids a permutation, uint8 codes kept and
    int64 codes narrowed to int32, the offsets on the host too."""
    rng = np.random.default_rng(5)
    coarse = rng.choice([0, 1, 3, 4], 1000, p=[0.1, 0.4, 0.3, 0.2])
    codes = rng.integers(0, 256, (1000, 8))
    for dtype, want in ((torch.uint8, torch.uint8), (torch.int64, torch.int32)):
        gcodes, ids, offsets, host = pq.grouped_layout(
            tensor(codes).to(dtype), tensor(coarse).to(torch.int32), 5)
        assert gcodes.dtype == want and ids.dtype == offsets.dtype == \
            torch.int32
        idn = ids.numpy()
        np.testing.assert_array_equal(np.sort(idn), np.arange(1000))
        np.testing.assert_array_equal(idn, np.argsort(coarse, kind="stable"))
        np.testing.assert_array_equal(
            np.diff(offsets.numpy()), np.bincount(coarse, minlength=5))
        assert host == tuple(offsets.tolist())
        assert host[0] == 0 and host[-1] == 1000 and host[2] == host[3]
        for c in range(5):
            rows = idn[host[c]:host[c + 1]]
            assert (coarse[rows] == c).all() and (np.diff(rows) > 0).all()
        np.testing.assert_array_equal(gcodes.numpy(), codes[idn])


@pytest.mark.parametrize("m", [8, 16, 64, 128])
def test_pq_topk_plan_sizes_fit(m):
    """The fused scan's planner: pass 1's LUT slices, buffers and digit
    counters fit in shared memory, two blocks an SM where they can (always
    at the serving shapes); the widest query tile that fits; buffers of kk
    + the margin + at least TOPK_MIN_SLACK words; the chunks one wave of
    blocks; the margin within a tile; the sample (16,384 rows, an
    eighth of n at most) only on the buffered path of at least 8 kk rows;
    the merge's word buffers fit; the selection path where the buffers do
    not fit, past SELECT_FROM_KK or where the merge would read more than
    MERGE_WORDS_MAX words a query; every 1 <= kk <= n plans, kk <= 0 and
    kk > n raise."""
    budget = {2: pq_lut.TOPK_SMEM_TWO, 1: pq_lut.TOPK_SMEM_LIMIT}
    for kk, n, b in ((80, 1_000_000, 64), (320, 1_000_000, 64),
                     (2048, 1_000_000, 16), (50_000, 50_000, 64),
                     (1, 1, 1), (4096, 200_000, 3), (300, 2000, 5)):
        p = pq_lut.topk_plan(n, b, kk, m, 256, 132)
        assert p.bq in (1, 2, 4, 8, 16) and p.bq <= pq_lut._pow2(b)
        assert p.smem == pq_lut.topk_smem(p.bq, p.staged, p.cap, m, 256)
        assert p.smem <= budget[p.blocks_per_sm]
        assert p.tile == pq_lut.TOPK_TILE and 0 < p.margin <= p.tile
        assert (p.nchunks - 1) * p.chunk_rows < n <= \
            p.nchunks * p.chunk_rows
        qtiles = -(-b // p.bq)
        assert qtiles * p.nchunks <= max(
            qtiles, p.blocks_per_sm * 132)      # one wave, no tail
        assert p.bp >= qtiles * p.bq and p.bp % min(p.bq, 4) == 0
        if b <= 2:
            assert p.bp == b
        if p.select:
            assert p.cap == p.sample == p.word_warps == 0
            continue
        assert kk + p.margin + pq_lut.TOPK_MIN_SLACK <= p.cap <= \
            kk + p.margin + pq_lut.TOPK_MAX_SLACK
        assert kk <= pq_lut.SELECT_FROM_KK
        assert p.nchunks * kk <= pq_lut.MERGE_WORDS_MAX
        # the next wider tile would not fit two blocks an SM
        if p.bq < min(16, pq_lut._pow2(b)) and p.blocks_per_sm == 2:
            wide = pq_lut.topk_smem(2 * p.bq, p.staged, kk + p.margin +
                                    pq_lut.TOPK_MIN_SLACK, m, 256)
            assert wide > pq_lut.TOPK_SMEM_TWO
        want = min(pq_lut.TOPK_SAMPLE, n // 8)
        assert p.sample == (want if n >= 8 * kk and want >= kk else 0)
        slots, warps = p.word_slots, p.word_warps
        assert slots >= max(2 * kk, kk + pq_lut.WORD_ROUND)
        assert warps * (8 * slots + 1024) <= pq_lut.TOPK_SMEM_LIMIT
        assert pq_lut.topk_plan(n, b, kk, m, 256, 132, select=True).select
    # the serving shapes at M=8: two blocks an SM, the slices staged, a
    # sample of 16,384 rows; EngineConfig()'s k' = 80 buffered at every
    # batch, 320 where its merge reads at most MERGE_WORDS_MAX words a query
    for b in (64, 32, 16, 8, 1):
        for kk in (80, 320):
            p = pq_lut.topk_plan(1_000_000, b, kk, 8, 256, 132)
            buf = pq_lut.topk_plan(1_000_000, b, kk, 8, 256, 132, False)
            assert p.select == (buf.nchunks * kk > pq_lut.MERGE_WORDS_MAX)
            assert p.select == (kk == 320 and b <= 16)
            assert buf.blocks_per_sm == 2 and buf.staged
            assert buf.sample == 16_384 and buf.bq == min(8, b)
    assert pq_lut.topk_plan(1_000_000, 64, 80, 8, 256, 132).bq == 8
    for kk in (512, 1024, 2048):
        assert pq_lut.topk_plan(1_000_000, 64, kk, 8, 256, 132).select == \
            (kk > pq_lut.SELECT_FROM_KK)
    # below 8 kk rows no sample; one query's slice past shared memory is
    # read from L2
    assert pq_lut.topk_plan(1000, 4, 200, 8, 256, 132).sample == 0
    assert pq_lut.topk_plan(8000, 4, 200, 8, 256, 132).sample == 1000
    assert not pq_lut.topk_plan(1000, 4, 10, 256, 256, 132).staged
    for kk in (0, 1001):
        with pytest.raises(ValueError):
            pq_lut.topk_plan(1000, 4, kk, 8, 256, 132)
    with pytest.raises(ValueError):
        pq_lut.topk_plan(200_000, 4, 20_000, 8, 256, 132, select=False)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ref_pq_score_topk_matches_lax_top_k(use_pallas):
    """The plain version of the fused scan is ``lax.top_k(-pq_score_batch)``
    of the reference: quarter-integer LUTs (many equal scores: the smaller
    row first) with -0.0 entries. A row whose M entries are all -0.0 sums
    to -0.0 in the port (its sums start from the first entry, as the fused
    kernel's do) and to +0.0 in the reference (its reductions start from
    +0.0), so every row here holds a +0.0 entry or a non-zero one; the
    ranking of -0.0 against +0.0 is held on the port's own sums."""
    rng = np.random.default_rng(9)
    n, m, k, b = 1500, 4, 32, 3
    codes = rng.integers(0, k, (n, m)).astype(np.int32)
    luts = (rng.integers(0, 6, (b, m, k)) * 0.25).astype(np.float32)
    luts[(luts == 0.0) & (rng.random(luts.shape) < 0.5)] = -0.0
    luts[:, 0, 0] = 0.0
    picked = luts[:, np.arange(m)[None, :], codes]            # (b, n, m)
    all_neg_zero = ((picked == 0) & np.signbit(picked)).all(axis=2)
    codes[all_neg_zero.any(axis=0), 0] = 0                    # a +0.0 entry
    d2 = jops.pq_score_batch(jnp.asarray(codes), jnp.asarray(luts),
                             use_pallas=use_pallas, block_rows=500)
    for kk in (1, 40, n):
        jv, ji = lax.top_k(-d2, kk)
        vals, ids = ref.ref_pq_score_topk(tensor(codes), tensor(luts), kk)
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    assert (np.asarray(d2) == 0).any() and np.signbit(luts).any()
    # the ranking alone on the port's sums, -0.0 and +0.0 both present
    zl = np.where(rng.random((b, m, k)) < 0.5, -0.0, 0.0).astype(np.float32)
    x = -ref.ref_pq_score_batch(tensor(codes), tensor(zl))
    assert torch.signbit(x).any() and (~torch.signbit(x)).any()
    jv, ji = lax.top_k(jnp.asarray(x.numpy()), 200)
    vals, ids = ref.ref_pq_score_topk(tensor(codes), tensor(zl), 200)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


def test_pq_search_takes_the_fused_op():
    """``pq.search`` goes through ``ops.pq_score_topk`` (the plain version
    on the CPU), equal to the B9 distances' packed-key top-k it replaced."""
    rng = np.random.default_rng(2)
    x = tensor(normal(rng, 3000, 32))
    index = pq.build(x, m_subspaces=8, ksub=32, generator=0, ncoarse=8)
    q = tensor(normal(rng, 7, 32))
    vals, ids = pq.search(index, q, 50)
    luts = pq.scan_luts(index, q)
    want = ref.topk_first_packed(
        -ops.pq_score_batch(index.ccodes, luts), 50)
    assert torch.equal(vals, want[0]) and torch.equal(ids, want[1].int())
    gcodes, gids, offsets, host = index.grouped
    assert torch.equal(gcodes, index.codes[gids.long()])
