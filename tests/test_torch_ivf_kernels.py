"""The port's IVF kernel modules (B5, B6, B7 and ``dedup_probes``) against
the JAX package's.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions; they
are held against ``repro.kernels.ops`` with the Pallas kernels in interpret
mode (``use_pallas=True``) and with the jnp references (``False``), on the
same numpy operands (``uniq``/``member`` are built by the JAX
``dedup_probes`` and handed across). Tolerances: scores rtol 1e-5, atol
1e-4 (the dot products round differently across frameworks), ids equal
outside near-ties; payload rows exactly (they are gathered, not computed);
exactly everywhere on integer data, where the tie rules alone order equal
scores. Each CUDA kernel is held against its plain version in
``tests/test_torch_gpu.py``.
"""
import itertools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.kernels import ops as jops
from repro.kernels.ivf_score import dedup_probes as jdedup_probes
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ivf_score
from test_torch_support import assert_topk_match, ivf_inputs, tensor

L2 = dict(rtol=1e-5, atol=1e-4)
# (nlist, max_list, b, nprobe, k); the last leaves some queries fewer live
# candidates than k, so their tail slots are dead (-inf, id 0, zero rows)
SHAPES = [(8, 40, 4, 3, 8), (16, 72, 6, 5, 16), (8, 8, 3, 2, 16)]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _dead_to_zero(vals, ids):
    """The Pallas kernels leave the id of a dead (-inf) slot unspecified
    (their callers zero it, as ``repro.index.ivf.search`` does); the port's
    kernels and plain versions write 0, as the reference's jnp path does."""
    vals, ids = np.asarray(vals), np.asarray(ids)
    return vals, np.where(np.isneginf(vals), 0, ids)


def _dedup_operands(shape, d=32):
    nlist, max_list, b, nprobe, k = shape
    g, gsq, valid, probes, q, pv, pf = ivf_inputs(nlist, max_list, b, nprobe,
                                                  d=d)
    uniq, member = (np.asarray(a) for a in jdedup_probes(jnp.asarray(probes),
                                                         nlist))
    return (g, gsq, valid, uniq, member, q), pv, pf, k


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_ivf_dedup_and_rows_match_jax(use_pallas, shape):
    args, pv, pf, k = _dedup_operands(shape)
    vals, ids = ops.ivf_score_topk_dedup(*map(tensor, args), k)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    jv, ji = _dead_to_zero(*jops.ivf_score_topk_dedup(
        *_j(*args), k, use_pallas=use_pallas))
    nxt = np.asarray(jops.ivf_score_topk_dedup(*_j(*args), k + 1,
                                               use_pallas=False)[0])[:, -1]
    assert_topk_match(jv, ji, vals, ids, **L2, next_vals=nxt)
    dead = np.isneginf(vals.numpy())
    assert (ids.numpy()[dead] == 0).all()
    if shape == SHAPES[-1]:
        assert dead.any()

    out = ops.ivf_score_topk_dedup_rows(*map(tensor, args), tensor(pv),
                                        tensor(pf), k)
    assert torch.equal(out[0], vals) and torch.equal(out[1], ids)
    jout = jops.ivf_score_topk_dedup_rows(*_j(*args, pv, pf), k,
                                          use_pallas=use_pallas)
    same = (ids.numpy() == np.asarray(jout[1])) & ~dead
    for mine, theirs, full in ((out[2], jout[2], pv), (out[3], jout[3], pf)):
        np.testing.assert_array_equal(mine.numpy()[same],
                                      np.asarray(theirs)[same])
        want = full.reshape(-1, full.shape[-1])[ids.numpy()]
        want[dead] = 0.0
        np.testing.assert_array_equal(mine.numpy(), want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_ivf_batch_matches_jax(use_pallas, shape):
    nlist, max_list, b, nprobe, k = shape
    g, gsq, valid, probes, q, _, _ = ivf_inputs(nlist, max_list, b, nprobe,
                                                d=32)
    args = (g, gsq, valid, probes, q)
    vals, ids = ops.ivf_score_topk_batch(*map(tensor, args), k)
    jv, ji = _dead_to_zero(*jops.ivf_score_topk_batch(
        *_j(*args), k, use_pallas=use_pallas))
    nxt = None
    if k < nprobe * max_list:
        nxt = np.asarray(jops.ivf_score_topk_batch(
            *_j(*args), k + 1, use_pallas=False)[0])[:, -1]
    assert_topk_match(jv, ji, vals, ids, **L2, next_vals=nxt)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ivf_single_query_matches_jax(use_pallas):
    g, gsq, valid, probes, q, _, _ = ivf_inputs(16, 72, 2, 5, d=32)
    vals, ids = ops.ivf_score_topk(*map(tensor, (g, gsq, valid, probes[1],
                                                 q[1])), 12)
    jv, ji = jops.ivf_score_topk(*_j(g, gsq, valid, probes[1], q[1]), 12,
                                 use_pallas=use_pallas)
    if not use_pallas:
        # the jnp reference of the single-query call returns -||q - x||^2
        jv = np.asarray(jv) + float((q[1] * q[1]).sum())
    assert_topk_match(np.asarray(jv)[None], np.asarray(ji)[None],
                      vals.numpy()[None], ids.numpy()[None], **L2)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ivf_tie_orders_match_jax(use_pallas):
    """Integer data, so scores are exact and tie often. B7 visits probes in
    the caller's order (here no list order, and query 0 probes one list
    twice, which then competes twice); B5 orders ties by flat id."""
    g, gsq, valid, probes, q, _, _ = ivf_inputs(12, 24, 4, 5, d=16,
                                                ints=True)
    probes[0, 4] = probes[0, 1]
    assert (np.diff(probes, axis=1) < 0).any()
    k = 16
    vals, ids = ops.ivf_score_topk_batch(*map(tensor, (g, gsq, valid, probes,
                                                       q)), k)
    jv, ji = jops.ivf_score_topk_batch(*_j(g, gsq, valid, probes, q), k,
                                       use_pallas=use_pallas)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    assert (np.diff(vals.numpy(), axis=1) == 0).any()   # the data really ties

    uniq, member = jdedup_probes(jnp.asarray(probes), 12)
    args = (g, gsq, valid, np.asarray(uniq), np.asarray(member), q)
    vals, ids = ops.ivf_score_topk_dedup(*map(tensor, args), k)
    jv, ji = jops.ivf_score_topk_dedup(*_j(*args), k, use_pallas=use_pallas)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))

    # one list probed twice, k = every candidate: each live id twice
    twice = np.full((1, 2), 3, np.int32)
    vals, ids = ops.ivf_score_topk_batch(*map(tensor, (g, gsq, valid, twice,
                                                       q[:1])), 48)
    jv, ji = _dead_to_zero(*jops.ivf_score_topk_batch(
        *_j(g, gsq, valid, twice, q[:1]), 48, use_pallas=use_pallas))
    np.testing.assert_array_equal(ids.numpy(), ji)
    live = ids.numpy()[~np.isneginf(vals.numpy())]
    assert (np.unique(live, return_counts=True)[1] == 2).all()


@pytest.mark.parametrize("b,nlist,nprobe", [(4, 8, 3), (6, 16, 5), (3, 64, 4),
                                            (5, 6, 6), (1, 32, 1)])
def test_dedup_probes_matches_jax(b, nlist, nprobe):
    rng = np.random.default_rng(b * nlist)
    probes = np.stack([rng.permutation(nlist)[:nprobe]
                       for _ in range(b)]).astype(np.int32)
    uniq, member = ops.dedup_probes(tensor(probes), nlist)
    ju, jm = (np.asarray(a) for a in jdedup_probes(jnp.asarray(probes),
                                                   nlist))
    assert uniq.dtype == torch.int32 and member.dtype == torch.float32
    live = jm.any(axis=1)
    np.testing.assert_array_equal(uniq.numpy()[live], ju[live])
    np.testing.assert_array_equal(member.numpy(), jm)
    assert (np.diff(uniq.numpy()[live]) > 0).all()      # ascending, unique
    assert (uniq.numpy()[~live] == 0).all()
    assert set(uniq.numpy()[live]) == set(probes.ravel())


DTYPES = [torch.float32, torch.bfloat16, torch.int8]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_plan_sizes_fit_and_refuse(dtype):
    """Every k >= 1 and every width plans (slots past the live candidates
    read (-inf, 0), as in the reference): buffered where a ring of at least
    MIN_STAGES stages, the buffers of some member queries a pass and the
    merge fit in shared memory, the selection path past them; only k <= 0
    raises."""
    elem = torch.empty((), dtype=dtype).element_size()
    for k, d in itertools.product([80, 320, 1000, 1744, 1745, 2048, 3200, 4096,
                                   50_000, 1, 16],
                                  [128, 384, 960, 1536, 30, 64]):
        p = ivf_score.plan(k, d, dtype)
        assert p.smem == ivf_score.scan_smem(elem, p.stages, p.q, p.cap)
        assert p.smem <= ivf_score.SMEM_LIMIT
        assert ivf_score.MIN_STAGES <= p.stages <= ivf_score.MAX_STAGES
        assert 1 <= p.q <= ivf_score.Q_MAX
        if p.select:
            assert p.cap == 0 and p.q == ivf_score.Q_MAX
            with pytest.raises(ValueError, match="do not fit"):
                ivf_score.plan(k, d, dtype, select=False)
        else:
            # a tile of admissions never overflows a buffer that was cut
            assert p.cap >= k + ivf_score.TILE_ROWS
            assert ivf_score.merge_smem(k) <= ivf_score.MERGE_LIMIT
            assert ivf_score.plan(k, d, dtype, select=False) == p
        assert ivf_score.plan(k, d, dtype, select=True).select
    # the default k' and its escalation: every member query of a list in one
    # pass, two tiles of room; IVF at EngineConfig(k=100) escalates to
    # k'=3200: the selection path, whose select reads the scores once
    for k in (80, 320):
        p = ivf_score.plan(k, 128, dtype)
        assert not p.select and p.q == ivf_score.Q_MAX
        assert p.cap == k + 2 * ivf_score.TILE_ROWS
    assert ivf_score.plan(3200, 384, dtype).select
    for k in (0, -3):
        with pytest.raises(ValueError):
            ivf_score.plan(k, 128, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_ring_fits_every_width(dtype):
    """A stage is one tile of TILE_ROWS rows x one 128-byte column chunk,
    whatever d: rows of any width take more stages of the ring, not larger
    ones, so the plan (and its shared memory) is the same at every d up to
    1536, and each box of BOX_ROWS rows is one consumer warp's."""
    elem = torch.empty((), dtype=dtype).element_size()
    assert ivf_score.stage_bytes(elem) == (
        ivf_score.TILE_ROWS * 128 + ivf_score.Q_MAX * (128 // elem) * 4
        + 2 * ivf_score.TILE_ROWS * 4 + ivf_score.META_BYTES)
    assert ivf_score.TILE_ROWS % ivf_score.BOX_ROWS == 0
    assert ivf_score.TILE_ROWS // ivf_score.BOX_ROWS == 8
    for k in (1, 80, 320, 1000):
        plans = {ivf_score.plan(k, d, dtype)
                 for d in (1, 16, 100, 128, 384, 960, 1536)}
        assert len(plans) == 1
        (p,) = plans
        assert p.stages * ivf_score.stage_bytes(elem) <= p.smem


def test_ivf_merge_smem_is_the_stream_cut():
    """Pass 2's shared memory: eight warps' buffers of k plus eight rounds
    of 256 entries (two where that passes 200 KB, k where k is larger), 8
    bytes an entry, beside a 256-bin histogram a warp."""
    for k in (1, 80, 320, 1024, 1744, 2048, 3200):
        extra = 8 * 256 if 8 * 8 * (k + max(k, 8 * 256)) <= 200 * 1024 \
            else 2 * 256
        assert ivf_score.merge_smem(k) == 8 * (8 * (k + max(k, extra))
                                               + 4 * 256)
    assert ivf_score.merge_smem(1744) <= ivf_score.MERGE_LIMIT
    assert ivf_score.merge_smem(1745) > ivf_score.MERGE_LIMIT
    assert ivf_score.plan(1744, 128).q == 4      # the merge's last k
    assert ivf_score.plan(1745, 128).select


@pytest.mark.parametrize("q", [1, 2, 4, 8])
def test_ivf_list_passes_count_member_queries(q):
    """Pass 1 reads a source's list once per q of its member queries, and
    not at all with none: against a numpy count on member matrices from
    empty to dense (every query on every list, the mask plan's shape)."""
    rng = np.random.default_rng(q)
    for s, b, density in ((40, 64, 0.03), (17, 5, 0.5), (8, 64, 1.0),
                          (6, 3, 0.0)):
        member = (rng.random((s, b)) < density).astype(np.float32)
        want = -(-member.sum(axis=1).astype(np.int64) // q)
        got = ivf_score.list_passes(torch.tensor(member), q)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the default plan's passes at phase 3b's members (at most 6 a list)
    member = np.zeros((3, 64), np.float32)
    member[0, :6] = member[1, :1] = 1.0
    assert ivf_score.list_passes(torch.tensor(member)).tolist() == [1, 1, 0]


def test_ivf_cpu_dispatch_launches_no_kernel():
    g, gsq, valid, probes, q, pv, pf = map(tensor, ivf_inputs(8, 16, 3, 2))
    uniq, member = ops.dedup_probes(probes, 8)
    _build.reset_launch_counts()
    ops.ivf_score_topk_dedup(g, gsq, valid, uniq, member, q, 5)
    ops.ivf_score_topk_dedup_rows(g, gsq, valid, uniq, member, q, pv, pf, 5)
    ops.ivf_score_topk_batch(g, gsq, valid, probes, q, 5)
    ops.ivf_score_topk(g, gsq, valid, probes[0], q[0], 5)
    assert _build.launch_counts() == {}
    # the plain versions pad past the last candidate as the kernels do
    vals, ids = ref.ref_ivf_score_topk_batch(g, gsq, valid, probes, q, 40)
    assert torch.isneginf(vals[:, 32:]).all() and (ids[:, 32:] == 0).all()
