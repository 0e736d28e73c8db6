"""The filter algebra's kernel variants and index helpers, against the JAX
package: B2's masked (fp32, bf16) and masked+scaled (int8) variants, B5's
``mask=``, and the flat and IVF filtered helpers.

On the CPU ``repro_torch.kernels.ops`` runs the plain versions; they are
held against ``repro.kernels.ops`` with the Pallas kernels in interpret mode
(``use_pallas=True``: ``_masked_kernel``, ``_masked_scaled_kernel``, the
dedup kernels over ``valid * mask``) and with the jnp references
(``False``), on the same stored rows. Tolerances: live scores rtol 1e-5,
atol 1e-4 with ids equal outside near-ties (the dot products round
differently across frameworks); exactly on integer data, where every score
is exact and the tie rule alone orders equal scores. Dead slots (fewer
eligible rows than k) read -inf at the same places in both packages; the
port writes id 0 there, which the reference leaves to its callers (they
clamp it). ``filtered_d2`` agrees with the reference's to fp32 tolerance
(rtol 1e-6) and with itself bit for bit whatever the candidate axis; the
packed-key ``lexsort_topk``, ``grouped_mask`` and ``eligible_lists`` are
exact. Each CUDA variant is held against its plain version in
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.index import flat as jflat
from repro.index import ivf as jivf
from repro.kernels import ops as jops
from repro_torch.core import fcvi
from repro_torch.index import flat, ivf
from repro_torch.kernels import _build, ops, ref
from test_torch_quant_kernels import _dead_to_zero, _ivf_operands, _store
from test_torch_support import (assert_topk_match, ivf_inputs, normal,
                                scan_inputs, tensor, tie_inputs,
                                to_numpy_tree)

L2 = dict(rtol=1e-5, atol=1e-4)
DTYPES = ["float32", "bfloat16", "int8"]


def _row_mask(n, kind, seed=0):
    """(n,) float 0/1: ``sparse`` (~3%), ``half``, ``few`` (3 rows),
    ``none``."""
    rng = np.random.default_rng(seed)
    m = np.zeros(n, np.float32)
    if kind == "sparse":
        m[rng.random(n) < 0.03] = 1.0
    elif kind == "half":
        m[rng.random(n) < 0.5] = 1.0
    elif kind == "few":
        m[rng.choice(n, 3, replace=False)] = 1.0
    return m


def _rows(x, dtype):
    """(port rows, JAX rows, scales or None, squared norms) of fp32 rows."""
    if dtype == "float32":
        return tensor(x), jnp.asarray(x), None, (x * x).sum(-1)
    return _store(x, dtype)


def _opt(a, fn=tensor):
    return None if a is None else fn(a)


def _check_masked(jv, ji, vals, ids, next_vals):
    """Dead slots at the same places (id 0 in the port), live slots within
    the L2 tolerance with ids equal outside near-ties."""
    jv = np.asarray(jv)
    dead = np.isneginf(jv)
    np.testing.assert_array_equal(np.isneginf(vals.numpy()), dead)
    assert (ids.numpy()[dead] == 0).all()
    jv, ji = _dead_to_zero(jv, ji)
    assert_topk_match(jv, ji, vals, ids, **L2, next_vals=next_vals)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["sparse", "half", "few", "none"])
def test_score_topk_masked_matches_jax(use_pallas, dtype, kind):
    x, _, q, _, _ = scan_inputs(1000, 5, d=32)
    mine, theirs, scales, sq = _rows(x, dtype)
    mask = _row_mask(1000, kind)
    k = 18
    vals, ids = ops.score_topk(mine, tensor(sq), tensor(q), k,
                               scales=_opt(scales), mask=tensor(mask))
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    jargs = (theirs, jnp.asarray(sq), jnp.asarray(q))
    jkw = dict(scales=_opt(scales, jnp.asarray), mask=jnp.asarray(mask))
    jv, ji = jops.score_topk_padded(*jargs, k, use_pallas=use_pallas, **jkw)
    nxt = np.asarray(jops.score_topk_padded(*jargs, k + 1, use_pallas=False,
                                            **jkw)[0])[:, -1]
    _check_masked(jv, ji, vals, ids, nxt)
    live = int(mask.sum())
    assert int((~torch.isneginf(vals)).sum(dim=1).min()) == min(k, live)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_score_topk_masked_ties_match_jax(use_pallas):
    """Integer rows with every row duplicated: exact scores, so the masked
    scan equals both JAX paths bit for bit on its live slots."""
    x, sq, q = tie_inputs()
    mask = _row_mask(x.shape[0], "half", seed=4)
    for k in (18, 128):
        vals, ids = ops.score_topk(tensor(x), tensor(sq), tensor(q), k,
                                   mask=tensor(mask))
        jv, ji = _dead_to_zero(*jops.score_topk_padded(
            jnp.asarray(x), jnp.asarray(sq), jnp.asarray(q), k,
            mask=jnp.asarray(mask), use_pallas=use_pallas))
        np.testing.assert_array_equal(vals.numpy(), jv)
        np.testing.assert_array_equal(ids.numpy(), ji)
        assert (np.diff(jv, axis=1) == 0).any()   # the data really ties


def test_masked_plain_version_dead_slots_and_dispatch():
    """The plain masked scan writes (-inf, 0) past the eligible rows; an
    all-ones mask changes nothing; on the CPU no kernel is counted."""
    x, sq, q, _, _ = (tensor(a) for a in scan_inputs(300, 4, d=16))
    mask = torch.zeros(300)
    mask[[5, 77, 210]] = 1.0
    _build.reset_launch_counts()
    vals, ids = ops.score_topk(x, sq, q, 10, mask=mask)
    assert torch.isneginf(vals[:, 3:]).all() and (ids[:, 3:] == 0).all()
    assert set(ids[:, :3].reshape(-1).tolist()) == {5, 77, 210}
    full = ops.score_topk(x, sq, q, 10, mask=torch.ones(300))
    plain = ops.score_topk(x, sq, q, 10)
    assert torch.equal(full[0], plain[0]) and torch.equal(full[1], plain[1])
    assert _build.launch_counts() == {}


def _ivf_rows(dtype, ints=False):
    """Grouped operands at ``dtype`` for both packages (fp32 included)."""
    if dtype == "float32":
        g, sq, valid, probes, q, _, _ = ivf_inputs(16, 72, 6, 5, d=32,
                                                   ints=ints)
        return tensor(g), jnp.asarray(g), None, sq, valid, q
    (mine, theirs, scales, sq, valid, _, _, _, q, _,
     _) = _ivf_operands(dtype, ints=ints)
    return mine, theirs, scales, sq, valid, q


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("routed", [False, True])
def test_ivf_dedup_mask_matches_jax(use_pallas, dtype, routed):
    """B5 ``mask=`` as the mask plan runs it (every list, an all-ones
    member) and as the routed plan does (a routed list set whose tail slot
    repeats a live id with a zero member column)."""
    mine, theirs, scales, sq, valid, q = _ivf_rows(dtype)
    nlist, max_list = valid.shape
    b = q.shape[0]
    mask = _row_mask(nlist * max_list, "sparse", seed=5).reshape(valid.shape)
    mask[3, :6] = 1.0
    if routed:
        uniq = np.int32([3, 7, 11, 3])
        member = np.ones((4, b), np.float32)
        member[3] = 0.0
    else:
        uniq = np.arange(nlist, dtype=np.int32)
        member = np.ones((nlist, b), np.float32)
    k = 18
    args = (mine, *map(tensor, (sq, valid, uniq, member, q)))
    vals, ids = ops.ivf_score_topk_dedup(*args, k, scales=_opt(scales),
                                         mask=tensor(mask))
    jargs = (theirs, *map(jnp.asarray, (sq, valid, uniq, member, q)))
    jkw = dict(scales=_opt(scales, jnp.asarray), mask=jnp.asarray(mask))
    jv, ji = jops.ivf_score_topk_dedup(*jargs, k, use_pallas=use_pallas,
                                       **jkw)
    nxt = np.asarray(jops.ivf_score_topk_dedup(
        *jargs, k + 1, use_pallas=False, **jkw)[0])[:, -1]
    _check_masked(jv, ji, vals, ids, nxt)
    # the mask is exactly a product into valid
    pv, pi = ops.ivf_score_topk_dedup(
        mine, *map(tensor, (sq, valid * mask, uniq, member, q)), k,
        scales=_opt(scales))
    assert torch.equal(pv, vals) and torch.equal(pi, ids)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_dedup_mask_ties_match_jax(use_pallas, dtype):
    mine, theirs, scales, sq, valid, q = _ivf_rows(dtype, ints=True)
    nlist = valid.shape[0]
    mask = _row_mask(valid.size, "half", seed=6).reshape(valid.shape)
    uniq = np.arange(nlist, dtype=np.int32)
    member = np.ones((nlist, q.shape[0]), np.float32)
    vals, ids = ops.ivf_score_topk_dedup(
        mine, *map(tensor, (sq, valid, uniq, member, q)), 40,
        scales=_opt(scales), mask=tensor(mask))
    jv, ji = _dead_to_zero(*jops.ivf_score_topk_dedup(
        theirs, *map(jnp.asarray, (sq, valid, uniq, member, q)), 40,
        scales=_opt(scales, jnp.asarray), mask=jnp.asarray(mask),
        use_pallas=use_pallas))
    np.testing.assert_array_equal(vals.numpy(), jv)
    np.testing.assert_array_equal(ids.numpy(), ji)


# -- the filtered refine's primitives ----------------------------------------

def test_filtered_d2_matches_reference_and_ignores_shape():
    rng = np.random.default_rng(7)
    for d in (1, 16, 30, 128):
        q, rows = normal(rng, 5, d), normal(rng, 5, 40, d) * 3.0
        got = flat.filtered_d2(tensor(q), tensor(rows))
        want = np.asarray(jflat.filtered_d2(jnp.asarray(q),
                                            jnp.asarray(rows)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        ref64 = ((q[:, None, :].astype(np.float64) - rows) ** 2).sum(-1)
        np.testing.assert_allclose(got.numpy(), ref64, rtol=1e-5)
        # the same row gives the same bits whatever the candidate axis
        for c in (1, 7, 18, 40):
            part = flat.filtered_d2(tensor(q), tensor(rows[:, :c]))
            assert torch.equal(part, got[:, :c])
        shared = flat.filtered_d2(tensor(q), tensor(rows[0]))   # (c, d)
        assert torch.equal(shared[0], got[0])


def test_lexsort_topk_and_finalize_match_reference():
    rng = np.random.default_rng(8)
    d2 = rng.integers(0, 6, size=(4, 30)).astype(np.float32) * 0.5
    d2[rng.random(d2.shape) < 0.2] = np.inf
    ids = np.stack([rng.permutation(1000)[:30] for _ in range(4)]).astype(
        np.int32)
    ids[np.isinf(d2)] = flat.DEAD_ID
    assert flat.DEAD_ID == int(jflat.DEAD_ID)
    for k in (5, 30, 40):                     # 40 > c pads
        got = flat.lexsort_topk(tensor(d2), tensor(ids), k)
        want = jflat.lexsort_topk(jnp.asarray(d2), jnp.asarray(ids), k)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        fs, fi = flat.finalize_filtered(*got)
        js, ji = jflat.finalize_filtered(*want)
        np.testing.assert_array_equal(fs.numpy(), np.asarray(js))
        np.testing.assert_array_equal(fi.numpy(), np.asarray(ji))
        assert fi.dtype == torch.int32


@pytest.fixture(scope="module")
def handed():
    """JAX flat and IVF indexes on one corpus, handed to the port."""
    from repro_torch.data.synthetic import CorpusSpec, make_corpus

    corpus = make_corpus(CorpusSpec(n=1500, d=32, n_categories=4,
                                    n_numeric=4, seed=3))
    rng = np.random.default_rng(4)
    q = normal(rng, 6, 32)
    out = {}
    for backend in ("flat", "ivf"):
        cfg = dict(backend=backend, nlist=12, nprobe=3)
        jidx = jfcvi.build(jnp.asarray(corpus.vectors),
                           jnp.asarray(corpus.filters),
                           jfcvi.FCVIConfig(**cfg))
        mine = fcvi.index_from_state(fcvi.FCVIConfig(**cfg),
                                     to_numpy_tree(jfcvi.index_state(jidx)),
                                     device="cpu")
        out[backend] = (jidx, mine)
    elig = corpus.filters[:, 0] > 0.5      # one category, ~40% of rows
    elig &= corpus.filters[:, 7] < 0.4
    return out, q, elig


def test_search_masked_matches_reference(handed):
    out, q, elig = handed
    jidx, mine = out["flat"]
    q_t = mine.transform.apply(tensor(q), torch.zeros(6, 8))
    vals, ids = flat.search_masked(mine.backend, q_t, 10, tensor(elig))
    jv, ji = jflat.search_masked(jidx.backend, jnp.asarray(q_t.numpy()), 10,
                                 jnp.asarray(elig))
    assert_topk_match(jv, ji, vals, ids, **L2)
    assert elig[ids.numpy()].all()


def test_search_masked_fewer_eligible_than_k(handed):
    """Three eligible rows and k=10: the reference's three live slots, then
    (-inf, -1) where the reference leaves the id to its callers."""
    out, q, _ = handed
    jidx, mine = out["flat"]
    few = np.zeros(mine.backend.size, bool)
    few[[5, 700, 1400]] = True
    q_t = mine.transform.apply(tensor(q), torch.zeros(6, 8))
    vals, ids = flat.search_masked(mine.backend, q_t, 10, tensor(few))
    jv, ji = jflat.search_masked(jidx.backend, jnp.asarray(q_t.numpy()), 10,
                                 jnp.asarray(few))
    assert_topk_match(np.asarray(jv)[:, :3], np.asarray(ji)[:, :3],
                      vals[:, :3], ids[:, :3], **L2)
    assert np.isneginf(np.asarray(jv)[:, 3:]).all()
    assert torch.isneginf(vals[:, 3:]).all() and (ids[:, 3:] == -1).all()


def test_flat_masked_candidates_match_reference(handed):
    out, q, elig = handed
    jidx, mine = out["flat"]
    q_t = mine.transform.apply(tensor(q), torch.zeros(6, 8))
    cand, valid = flat.masked_candidates(mine.backend, q_t, 18, tensor(elig))
    jc, jvld = jflat.masked_candidates(jidx.backend, jnp.asarray(q_t.numpy()),
                                       18, jnp.asarray(elig))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvld))
    d2, ids = flat.filtered_refine(mine.backend.vectors, None, q_t, cand,
                                   valid, tensor(elig), 10)
    jd2, jids = jflat.filtered_refine(jidx.backend.vectors, None,
                                      jnp.asarray(q_t.numpy()), jc, jvld,
                                      jnp.asarray(elig), 10)
    assert_topk_match(-np.asarray(jd2), jids, -d2, ids, **L2)


def test_ivf_routing_helpers_match_reference(handed):
    out, q, elig = handed
    jidx, mine = out["ivf"]
    jb, be = jidx.backend, mine.backend
    np.testing.assert_array_equal(
        ivf.grouped_mask(be, tensor(elig)).numpy(),
        np.asarray(jivf.grouped_mask(jb, jnp.asarray(elig))))
    for rows in (elig, np.zeros_like(elig), elig & (np.arange(elig.size)
                                                    < 50)):
        got = ivf.eligible_lists(be.lists, tensor(rows))
        want = jivf.eligible_lists(np.asarray(jb.lists), rows)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        assert got[1] == want[1] and got[0].dtype == torch.int32


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ivf_candidates_match_reference(handed, use_pallas):
    out, q, elig = handed
    jidx, mine = out["ivf"]
    jb, be = jidx.backend, mine.backend
    q_t = mine.transform.apply(tensor(q), torch.zeros(6, 8))
    jq = jnp.asarray(q_t.numpy())
    few = elig & (np.arange(elig.size) < 300)
    uniq, n_live = ivf.eligible_lists(be.lists, tensor(few))
    runs = [(ivf.masked_candidates(be, q_t, 18, tensor(elig)),
             jivf.masked_candidates(jb, jq, 18, jnp.asarray(elig),
                                    use_pallas=use_pallas), elig),
            (ivf.routed_candidates(be, q_t, 18, tensor(few), uniq, n_live),
             jivf.routed_candidates(jb, jq, 18, jnp.asarray(few),
                                    jnp.asarray(uniq.numpy()),
                                    jnp.asarray(n_live),
                                    use_pallas=use_pallas), few)]
    for (cand, valid), (jc, jvld), rows in runs:
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvld))
        d2, ids = flat.filtered_refine(be.vectors, None, q_t, cand, valid,
                                       tensor(rows), 10)
        jd2, jids = jflat.filtered_refine(jb.vectors, None, jq, jc, jvld,
                                          jnp.asarray(rows), 10)
        assert_topk_match(-np.asarray(jd2), jids, -d2, ids, **L2)
        assert rows[ids.numpy()].all()
