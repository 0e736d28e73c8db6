"""Kernel modules of the port against the JAX package, and each CUDA kernel
against its plain version.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions; they
are held against ``repro.kernels.ops`` with the Pallas kernels in interpret
mode (``use_pallas=True``) and with the jnp references (``False``), on the
same numpy inputs. Tolerances: fused_transform rtol = atol = 1e-5 (one
fp32 rounding per op); L2 top-k scores rtol 1e-5, atol 1e-4 (the expansion
||q||^2 - 2 q.x + ||x||^2 rounds differently across frameworks), ids equal
outside near-ties; rescore atol 1e-5.

Each CUDA kernel is held against its plain version in
``tests/test_torch_gpu.py``.
"""
import itertools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.kernels import ops as jops
from repro.kernels.ref import partition_matrix as jax_partition_matrix
from repro_torch.kernels import _build, ops, ref
from test_torch_support import (assert_topk_match, normal, scan_inputs,
                                tensor, tie_inputs, transform_inputs)

L2_RTOL, L2_ATOL = 1e-5, 1e-4


def _jax_next(x, sq, q, k):
    """The JAX reference's (k+1)-th score per query (see near_tie_mask)."""
    vals, _ = jops.score_topk(*map(jnp.asarray, (x, sq, q)), k + 1,
                              use_pallas=False)
    return np.asarray(vals)[:, -1]


# ---------------------------------------------------------------------------
# CPU: plain versions against the JAX package
# ---------------------------------------------------------------------------

def test_partition_matrix_matches_jax():
    np.testing.assert_array_equal(ref.partition_matrix(64, 8).numpy(),
                                  np.asarray(jax_partition_matrix(64, 8)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("embedding", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_fused_transform_matches_jax(use_pallas, embedding, normalized):
    v, f, proj, norms = transform_inputs(300, 64, 8, embedding)
    if normalized:  # the hot path: already-normalized rows, identity norms
        mine = ops.fused_transform(tensor(v), tensor(f), tensor(proj), 1.5)
        d, m = v.shape[1], f.shape[1]
        norms = (np.zeros(d, np.float32), np.ones(d, np.float32),
                 np.zeros(m, np.float32), np.ones(m, np.float32))
    else:
        mine = ops.fused_transform(tensor(v), tensor(f), tensor(proj), 1.5,
                                   *map(tensor, norms))
    theirs = jops.fused_transform(*map(jnp.asarray, (v, f, proj)), 1.5,
                                  *map(jnp.asarray, norms),
                                  use_pallas=use_pallas)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("n,b,k", [(1000, 5, 10), (1000, 5, 88),
                                   (256, 3, 256)])
def test_score_topk_matches_jax(use_pallas, n, b, k):
    x, sq, q, _, _ = scan_inputs(n, b)
    vals, ids = ops.score_topk(tensor(x), tensor(sq), tensor(q), k)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    jv, ji = jops.score_topk_padded(*map(jnp.asarray, (x, sq, q)), k,
                                    use_pallas=use_pallas)
    assert_topk_match(jv, ji, vals, ids, rtol=L2_RTOL, atol=L2_ATOL,
                      next_vals=None if k == n else _jax_next(x, sq, q, k))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("k", [10, 88])
def test_score_topk_rows_matches_jax(use_pallas, k):
    x, sq, q, pv, pf = scan_inputs(1000, 5)
    vals, ids, sr, rv, rf = ops.score_topk_rows(*map(tensor, (x, sq, pv, pf, q)),
                                                k)
    jv, ji, jsr, jrv, jrf = jops.score_topk_rows_padded(
        *map(jnp.asarray, (x, sq, pv, pf, q)), k, use_pallas=use_pallas)
    assert_topk_match(jv, ji, vals, ids, rtol=L2_RTOL, atol=L2_ATOL,
                      next_vals=_jax_next(x, sq, q, k))
    # the carried rows are exactly the stored rows of the returned ids
    idx = ids.long()
    np.testing.assert_array_equal(sr.numpy(), x[idx.numpy()])
    np.testing.assert_array_equal(rv.numpy(), pv[idx.numpy()])
    np.testing.assert_array_equal(rf.numpy(), pf[idx.numpy()])
    same = ids.numpy() == np.asarray(ji)
    np.testing.assert_array_equal(rv.numpy()[same], np.asarray(jrv)[same])
    np.testing.assert_array_equal(rf.numpy()[same], np.asarray(jrf)[same])
    np.testing.assert_array_equal(sr.numpy()[same], np.asarray(jsr)[same])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_score_topk_ties_keep_first_occurrence_like_jax(use_pallas):
    x, sq, q = tie_inputs()
    k = 40
    vals, ids = ops.score_topk(tensor(x), tensor(sq), tensor(q), k)
    jv, ji = jops.score_topk_padded(*map(jnp.asarray, (x, sq, q)), k,
                                    use_pallas=use_pallas)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    # the data really ties: some returned scores repeat
    assert (np.diff(vals.numpy(), axis=1) == 0).any()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rescore_matches_jax(use_pallas):
    rng = np.random.default_rng(3)
    args = (normal(rng, 5, 80, 64), normal(rng, 5, 80, 8),
            normal(rng, 5, 64), normal(rng, 5, 8))
    mine = ops.rescore(*map(tensor, args), 0.6)
    theirs = jops.rescore(*map(jnp.asarray, args), 0.6, use_pallas=use_pallas,
                          block_b=5)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-5)


def test_topk_first_breaks_ties_by_position():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, pos = ref.topk_first(x, 4)
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]
    assert pos.tolist() == [[1, 2, 4, 3]]


SCAN_SHAPES = [(1_000_000, 64, 88), (1_000_000, 64, 328),
               (1_000_000, 64, 2048), (1_000_000, 64, 2056),
               (1_000_000, 64, 3200), (1_000_000, 16, 4104),
               (50_000, 64, 50_000), (1000, 5, 88), (256, 3, 256), (1, 1, 1)]


@pytest.mark.parametrize("et", [0, 1, 2])
@pytest.mark.parametrize("d", [128, 384, 960, 1536, 30, 4096])
def test_scan_plan_sizes_fit_and_cover(d, et):
    """Every 1 <= kk <= n, every width and every stored type plans: the
    buffered path at the widest query tile whose candidate buffers (kk +
    MIN_SLACK slots a query or more) fit beside the query operand (resident
    for every column chunk, or staged a chunk at a time where that fits a
    wider tile) and a ring of at least MIN_STAGES slots, the selection path
    past them (or below a 16-query tile for a larger batch, or when
    forced); the chunks cover the rows and fill the SMs."""
    from repro_torch.kernels import fused_score_topk as scan

    for n, nq, kk in SCAN_SHAPES:
        p = scan.plan(n, nq, kk, d, 132, et=et)
        widest = next(b for b in (8, 16, 32, 64) if b >= nq or b == 64)
        tiles = [b for b in (64, 32, 16, 8) if b <= widest]
        fit = {qs: [b for b in tiles
                    if scan.buffered_cap(b, kk, d, et, qs)[0]]
               for qs in (False, True)}
        best = max([f[0] for f in fit.values() if f], default=0)
        fits = best > 0 and scan.merge_smem(kk) <= scan.SMEM_LIMIT
        assert p.select == (not fits or best < min(16, widest)), \
            (n, nq, kk, d, et)
        assert scan.MIN_STAGES <= p.stages <= scan.MAX_STAGES
        assert scan.scan_smem(p.bq, p.cap, d, et, p.stages, p.qstream) <= \
            scan.SMEM_LIMIT
        if p.select:
            assert p.cap == 0 and p.sample == 0
            room = [b for b in tiles if scan.stages_for(
                b, 0, d, et, p.qstream) >= scan.MIN_STAGES]
            assert p.bq == room[0]
        else:
            assert p.bq == best
            # the operand is staged a chunk at a time only to fit a
            # wider tile than the resident operand allows
            assert p.qstream == (not fit[False] or fit[False][0] < best)
            assert kk + scan.MIN_SLACK <= p.cap <= kk + scan.MAX_SLACK
            assert p.cap % 32 == 0
            assert p.sample == (scan.SAMPLE if n // 8 >= kk else 0)
        assert p.chunk_rows % scan.ROWS == 0
        assert (p.nchunks - 1) * p.chunk_rows < n <= p.nchunks * p.chunk_rows
        qtiles = -(-nq // p.bq)
        assert p.nchunks <= max(1, -(-132 // qtiles))
        forced = scan.plan(n, nq, kk, d, 132, select=True, et=et)
        assert forced.select and forced.nchunks >= 1
        if fits:
            assert not scan.plan(n, nq, kk, d, 132, select=False,
                                 et=et).select
        else:
            with pytest.raises(ValueError, match="do not fit"):
                scan.plan(n, nq, kk, d, 132, select=False, et=et)
    # rows too wide for the resident operand at any tile stream it
    assert scan.plan(1_000_000, 64, 88, 4096, 132, et=et).qstream
    assert not scan.plan(1_000_000, 64, 88, 128, 132, et=et).qstream


def test_scan_plan_query_tile_and_chunks():
    """A batch of 64 reads the corpus once at the serving widths (one
    64-query tile, a chunk per SM); kk=328 halves the tile, kk=2056 takes
    the selection path for a batch and the buffers for a sub-batch of 4,
    at d=128; the chunks fill the SMs at every kk and down to a corpus of
    50,000 rows (a cap by the merge's length measured slower: PERF.md)."""
    from repro_torch.kernels import fused_score_topk as scan

    for et in (0, 1, 2):
        p = scan.plan(1_000_000, 64, 88, 128, 132, et=et)
        assert (p.bq, p.select, p.nchunks) == (64, False, 131)
        assert scan.plan(1_000_000, 64, 18, 128, 132, et=et).bq == 64
        p = scan.plan(1_000_000, 64, 328, 128, 132, et=et)
        assert (p.bq, p.select) == (32, False)
        assert scan.plan(1_000_000, 64, 2056, 128, 132, et=et).select
    assert not scan.plan(1_000_000, 64, 1032, 128, 132).select
    assert scan.plan(1_000_000, 4, 4104, 128, 132).select
    chunks = [scan.plan(n, 8, kk, 128, 132).nchunks
              for n in (1_000_000, 50_000) for kk in (88, 328, 1032)]
    assert chunks == [131] * 6
    for kk in (0, -1, 101):
        with pytest.raises(ValueError):
            scan.plan(100, 64, kk, 128, 132)


@pytest.mark.parametrize("kind", ["random", "none", "ten", "all"])
def test_eligible_ids_match_nonzero(kind):
    """The masked scan's eligible ids, built without a host synchronisation,
    equal mask.nonzero() in ascending order, with their count."""
    from repro_torch.kernels import fused_score_topk as scan

    n = 5000
    rng = np.random.default_rng(4)
    mask = np.zeros(n, np.float32)
    if kind == "random":
        mask[rng.random(n) < 0.2] = 1.0
    elif kind == "ten":
        mask[rng.choice(n, 10, replace=False)] = 1.0
    elif kind == "all":
        mask[:] = 1.0
    m = torch.from_numpy(mask)
    ids, count = scan.eligible_ids(m)
    want = torch.nonzero(m > 0.5).flatten()
    assert ids.shape == (n + 1,) and ids.dtype == torch.int32
    assert count.tolist() == [want.numel()]
    assert torch.equal(ids[: want.numel()].long(), want)


def test_cpu_dispatch_launches_no_kernel():
    _build.reset_launch_counts()
    x, sq, q, pv, pf = scan_inputs(300, 3)
    ops.score_topk(tensor(x), tensor(sq), tensor(q), 10)
    ops.score_topk_rows(*map(tensor, (x, sq, pv, pf, q)), 10)
    assert _build.launch_counts() == {}
