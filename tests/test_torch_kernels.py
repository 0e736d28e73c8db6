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


def test_scan_plan_sizes_fit_and_cover():
    """Every 1 <= kk <= n and every width plans: the buffered path where its
    buffers fit in shared memory, the selection path past them (or when
    forced); shared memory never grows with d."""
    from repro_torch.kernels import fused_score_topk as scan

    for (n, nq, kk), d in itertools.product(
            [(1_000_000, 64, 88), (1_000_000, 64, 328),
             (1_000_000, 64, 2048), (1_000_000, 64, 2056),
             (1_000_000, 64, 3200), (1_000_000, 16, 4104),
             (50_000, 64, 50_000), (1000, 5, 88), (256, 3, 256), (1, 1, 1)],
            [128, 384, 960, 1536, 30]):
        p = scan.plan(n, nq, kk, d, 132)
        dc = scan.staged_cols(d)
        assert dc == min((d + 3) & ~3, _build.DC)
        assert scan.scan_smem(p.bq, p.cap, dc) <= scan.SMEM_LIMIT
        widest = 16 if nq > 8 else 8 if nq > 4 else 4
        cap = scan._pow2(kk + 2 * scan.TILE)
        tiles = [bq for bq in (16, 8, 4) if bq <= widest
                 and scan.scan_smem(bq, cap, dc) <= scan.SMEM_LIMIT]
        buffered_fits = bool(tiles)
        # the selection path where the buffers do not fit, or fit only at a
        # 4-query tile when the batch holds more
        assert p.select == (not tiles or tiles[0] == 4 < widest), \
            (n, nq, kk, d)
        if p.select:
            assert p.cap == p.merge_cap == 0 and p.bq == widest
        else:
            assert p.bq == tiles[0]
            assert p.cap >= kk + 2 * scan.TILE and p.merge_cap >= kk
            assert scan.merge_smem(p.merge_cap) <= scan.SMEM_LIMIT
        assert p.chunk_rows % scan.TILE == 0
        assert (p.nchunks - 1) * p.chunk_rows < n <= p.nchunks * p.chunk_rows
        forced = scan.plan(n, nq, kk, d, 132, select=True)
        assert forced.select and forced.nchunks >= 1
        if buffered_fits:
            assert not scan.plan(n, nq, kk, d, 132, select=False).select
        else:
            with pytest.raises(ValueError, match="do not fit"):
                scan.plan(n, nq, kk, d, 132, select=False)
    # kk=2056 (EngineConfig(k=64) escalated on flat): a batch of 64 takes
    # the selection path, a sub-batch of 4 the buffers, at any d
    for d in (128, 960):
        assert scan.plan(1_000_000, 64, 2056, d, 132).select
        assert not scan.plan(1_000_000, 4, 2056, d, 132).select
    assert not scan.plan(1_000_000, 64, 1032, 128, 132).select
    assert scan.plan(1_000_000, 4, 4104, 128, 132).select
    for kk in (0, -1, 101):
        with pytest.raises(ValueError):
            scan.plan(100, 64, kk, 128, 132)

def test_cpu_dispatch_launches_no_kernel():
    _build.reset_launch_counts()
    x, sq, q, pv, pf = scan_inputs(300, 3)
    ops.score_topk(tensor(x), tensor(sq), tensor(q), 10)
    ops.score_topk_rows(*map(tensor, (x, sq, pv, pf, q)), 10)
    assert _build.launch_counts() == {}
