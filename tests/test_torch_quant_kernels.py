"""The bf16 and int8-scaled variants of the scan kernels' plain versions
(B2, B3, B5, B6, B7) and B4's dtype matrix, against the JAX package.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions; they
are held against ``repro.kernels.ops`` with the Pallas kernels in interpret
mode (``use_pallas=True``: ``_kernel`` on bf16 rows, ``_scaled_kernel`` /
``_dedup_scaled_kernel`` / ``_batch_scaled_kernel`` and the rows kernels
with int8 codes and scales) and with the jnp references (``False``). Both
packages get the same stored rows: int8 codes and scales from the JAX
package's ``quantize_rows`` (bit-equal to the port's,
``tests/test_torch_quant.py``), bf16 rows as one bit pattern. Tolerances:
scores rtol 1e-5, atol 1e-4 (the dot products round differently across
frameworks), ids equal outside near-ties; the carried rows exactly (they are
dequantized, ``code * scale``, not computed); exactly everywhere on integer
codes with power-of-two scales, where every score is exact and the tie
rules alone order equal scores. Each CUDA variant is held against its plain
version in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.index import quant as jquant
from repro.kernels import ops as jops
from repro.kernels.ivf_score import dedup_probes as jdedup_probes
from repro_torch.kernels import _build, ops
from test_torch_support import (assert_topk_match, ivf_inputs, normal,
                                scan_inputs, tensor)

L2 = dict(rtol=1e-5, atol=1e-4)
DTYPES = ["bfloat16", "int8"]


def _store(x, dtype):
    """(stored rows for the port, for JAX, scales or None, squared norms of
    the stored rows) of fp32 rows ``x``: bf16 by cast, int8 by the JAX
    package's quantizer."""
    if dtype == "int8":
        codes, scales = jquant.quantize_rows(jnp.asarray(x))
        sq = np.asarray(jquant.sq_norms_of(codes, scales))
        codes, scales = np.asarray(codes), np.asarray(scales)
        return tensor(codes), jnp.asarray(codes), scales, sq
    half = tensor(x).to(torch.bfloat16)
    sq = (half.float() ** 2).sum(-1).numpy()
    theirs = jnp.asarray(half.float().numpy()).astype(jnp.bfloat16)
    return half, theirs, None, sq


def _dequant(stored, scales):
    rows = stored.float().numpy()
    return rows if scales is None else rows * scales[..., None]


def _opt(scales, fn=tensor):
    return None if scales is None else fn(scales)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [10, 40])
def test_score_topk_variants_match_jax(use_pallas, dtype, k):
    x, _, q, pv, pf = scan_inputs(1000, 5, d=32)
    mine, theirs, scales, sq = _store(x, dtype)
    vals, ids = ops.score_topk(mine, tensor(sq), tensor(q), k,
                               scales=_opt(scales))
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    jargs = (theirs, jnp.asarray(sq), jnp.asarray(q))
    jscales = _opt(scales, jnp.asarray)
    jv, ji = jops.score_topk_padded(*jargs, k, scales=jscales,
                                    use_pallas=use_pallas)
    nxt = np.asarray(jops.score_topk_padded(*jargs, k + 1, scales=jscales,
                                            use_pallas=False)[0])[:, -1]
    assert_topk_match(jv, ji, vals, ids, **L2, next_vals=nxt)

    # B3: the same (vals, ids), and the rows dequantized to fp32
    out = ops.score_topk_rows(mine, tensor(sq), tensor(pv), tensor(pf),
                              tensor(q), k, scales=_opt(scales))
    assert torch.equal(out[0], vals) and torch.equal(out[1], ids)
    idx = ids.numpy()
    np.testing.assert_array_equal(out[2].numpy(),
                                  _dequant(mine, scales)[idx])
    np.testing.assert_array_equal(out[3].numpy(), pv[idx])
    np.testing.assert_array_equal(out[4].numpy(), pf[idx])
    jout = jops.score_topk_rows_padded(
        theirs, jnp.asarray(sq), jnp.asarray(pv), jnp.asarray(pf),
        jnp.asarray(q), k, scales=jscales, use_pallas=use_pallas)
    same = idx == np.asarray(jout[1])
    for got, want in zip(out[2:], jout[2:]):
        np.testing.assert_array_equal(got.numpy()[same],
                                      np.asarray(want)[same])


def _ivf_operands(dtype, ints=False, nlist=16, max_list=72, b=6, nprobe=5,
                  d=32):
    """Grouped slabs stored at ``dtype`` (port and JAX copies), their
    scales and squared norms, valid, probes, (uniq, member), queries and
    grouped payloads. ``ints``: small-integer codes with power-of-two
    scales, so every score is exact."""
    g, _, valid, probes, q, pv, pf = ivf_inputs(nlist, max_list, b, nprobe,
                                                d=d, ints=ints)
    if ints:
        rng = np.random.default_rng(9)
        scales = None
        if dtype == "int8":
            scales = rng.choice(np.float32([0.25, 0.5, 1.0, 2.0]),
                                size=(nlist, max_list))
        mine = tensor(g).to(torch.int8 if dtype == "int8"
                            else torch.bfloat16)
        theirs = jnp.asarray(g).astype(jnp.int8 if dtype == "int8"
                                       else jnp.bfloat16)
        sq = (_dequant(mine, scales) ** 2).sum(-1)
    else:
        mine, theirs, scales, sq = _store(g.reshape(-1, d), dtype)
        mine = mine.reshape(nlist, max_list, d)
        theirs = theirs.reshape(nlist, max_list, d)
        sq = sq.reshape(nlist, max_list)
        if scales is not None:
            scales = scales.reshape(nlist, max_list)
    uniq, member = (np.asarray(a) for a in jdedup_probes(jnp.asarray(probes),
                                                         nlist))
    return mine, theirs, scales, sq, valid, probes, uniq, member, q, pv, pf


def _dead_to_zero(vals, ids):
    """Dead (-inf) slots read id 0 (the Pallas kernels leave it to their
    callers, as ``tests/test_torch_ivf_kernels.py`` explains)."""
    vals, ids = np.asarray(vals), np.asarray(ids)
    return vals, np.where(np.isneginf(vals), 0, ids)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_variants_match_jax(use_pallas, dtype):
    (mine, theirs, scales, sq, valid, probes, uniq, member, q, pv,
     pf) = _ivf_operands(dtype)
    k = 16
    sc, jsc = _opt(scales), _opt(scales, jnp.asarray)
    ded = (mine, tensor(sq), tensor(valid), tensor(uniq), tensor(member),
           tensor(q))
    jded = (theirs, *map(jnp.asarray, (sq, valid, uniq, member, q)))

    vals, ids = ops.ivf_score_topk_dedup(*ded, k, scales=sc)
    jv, ji = _dead_to_zero(*jops.ivf_score_topk_dedup(
        *jded, k, scales=jsc, use_pallas=use_pallas))
    nxt = np.asarray(jops.ivf_score_topk_dedup(
        *jded, k + 1, scales=jsc, use_pallas=False)[0])[:, -1]
    assert_topk_match(jv, ji, vals, ids, **L2, next_vals=nxt)

    out = ops.ivf_score_topk_dedup_rows(*ded, tensor(pv), tensor(pf), k,
                                        scales=sc)
    assert torch.equal(out[0], vals) and torch.equal(out[1], ids)
    jout = jops.ivf_score_topk_dedup_rows(
        *jded, jnp.asarray(pv), jnp.asarray(pf), k, scales=jsc,
        use_pallas=use_pallas)
    dead = np.isneginf(vals.numpy())
    same = (ids.numpy() == np.asarray(jout[1])) & ~dead
    for got, want in zip(out[2:], jout[2:]):
        np.testing.assert_array_equal(got.numpy()[same],
                                      np.asarray(want)[same])

    bargs = (mine, tensor(sq), tensor(valid), tensor(probes), tensor(q))
    jb = (theirs, *map(jnp.asarray, (sq, valid, probes, q)))
    vals, ids = ops.ivf_score_topk_batch(*bargs, k, scales=sc)
    jv, ji = _dead_to_zero(*jops.ivf_score_topk_batch(
        *jb, k, scales=jsc, use_pallas=use_pallas))
    nxt = np.asarray(jops.ivf_score_topk_batch(
        *jb, k + 1, scales=jsc, use_pallas=False)[0])[:, -1]
    assert_topk_match(jv, ji, vals, ids, **L2, next_vals=nxt)
    # B7 at batch 1, the single-query call (the plain einsum may sum in
    # another order at batch 1)
    one = ops.ivf_score_topk(*bargs[:3], tensor(probes[2]), tensor(q[2]), k,
                             scales=sc)
    assert_topk_match(jv[2:3], ji[2:3], one[0][None], one[1][None], **L2,
                      next_vals=nxt[2:3])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ivf_variant_tie_orders_match_jax(use_pallas, dtype):
    """Integer codes and power-of-two scales: exact scores that tie often.
    B7 keeps the probe order (one list probed twice competes twice), B5
    the flat-id order, bit for bit with both JAX paths."""
    (mine, theirs, scales, sq, valid, probes, _, _, q, _,
     _) = _ivf_operands(dtype, ints=True, nlist=12, max_list=24, b=4,
                        nprobe=5, d=16)
    probes[0, 4] = probes[0, 1]
    k = 16
    sc, jsc = _opt(scales), _opt(scales, jnp.asarray)
    vals, ids = ops.ivf_score_topk_batch(
        mine, *map(tensor, (sq, valid, probes, q)), k, scales=sc)
    jv, ji = jops.ivf_score_topk_batch(
        theirs, *map(jnp.asarray, (sq, valid, probes, q)), k, scales=jsc,
        use_pallas=use_pallas)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    assert (np.diff(vals.numpy(), axis=1) == 0).any()   # the data really ties

    uniq, member = (np.asarray(a) for a in jdedup_probes(jnp.asarray(probes),
                                                         12))
    vals, ids = ops.ivf_score_topk_dedup(
        mine, *map(tensor, (sq, valid, uniq, member, q)), k, scales=sc)
    jv, ji = jops.ivf_score_topk_dedup(
        theirs, *map(jnp.asarray, (sq, valid, uniq, member, q)), k,
        scales=jsc, use_pallas=use_pallas)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_rescore_dtype_matrix_matches_jax(use_pallas):
    """B4 takes fp32, bf16 and int8-dequantized candidate tiles: the bf16
    ones are cast up first, so every rung scores exactly as its fp32
    upcast, and agrees with the JAX package's ``ops.rescore`` (which casts
    up too) within atol 1e-5, as the fp32 rescore does."""
    rng = np.random.default_rng(1)
    b, kp, d, m = 8, 16, 32, 8
    cv, cf = normal(rng, b, kp, d), normal(rng, b, kp, m)
    qn, fqn = normal(rng, b, d), normal(rng, b, m)

    def rungs(x):
        codes, scales = jquant.quantize_rows(jnp.asarray(x))
        return {"float32": tensor(x),
                "bfloat16": tensor(x).to(torch.bfloat16),
                "int8-dequant": tensor(np.asarray(
                    jquant.dequantize_rows(codes, scales)))}

    for name, v in rungs(cv).items():
        f = rungs(cf)[name]
        got = ops.rescore(v, f, tensor(qn), tensor(fqn), 0.6)
        assert got.dtype == torch.float32, name
        up = ops.rescore(v.float(), f.float(), tensor(qn), tensor(fqn), 0.6)
        assert torch.equal(got, up), name
        jv = (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
              if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
        jf = (jnp.asarray(f.float().numpy()).astype(jnp.bfloat16)
              if f.dtype == torch.bfloat16 else jnp.asarray(f.numpy()))
        theirs = jops.rescore(jv, jf, jnp.asarray(qn), jnp.asarray(fqn), 0.6,
                              use_pallas=use_pallas, block_b=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs), rtol=0,
                                   atol=1e-5, err_msg=name)
    # bf16 queries are cast up as well
    got = ops.rescore(tensor(cv), tensor(cf), tensor(qn).to(torch.bfloat16),
                      tensor(fqn), 0.6)
    assert torch.equal(got, ops.rescore(
        tensor(cv), tensor(cf), tensor(qn).to(torch.bfloat16).float(),
        tensor(fqn), 0.6))


def test_element_types_and_cpu_dispatch():
    """The scan kernels take fp32, bf16 and int8 rows, each with its own
    launch counter; any other dtype raises before a launch. On the CPU the
    variants reach no kernel."""
    assert _build.element_type(torch.empty(1), "x") == (0, "")
    assert _build.element_type(torch.empty(1, dtype=torch.bfloat16),
                               "x") == (1, "_bf16")
    assert _build.element_type(torch.empty(1, dtype=torch.int8),
                               "x") == (2, "_int8")
    for dtype in (torch.float16, torch.float64, torch.uint8):
        with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
            _build.element_type(torch.empty(1, dtype=dtype), "x")
    _build.reset_launch_counts()
    x, sq, q, pv, pf = scan_inputs(300, 3, d=32)
    for dtype in DTYPES:
        mine, _, scales, sq = _store(x, dtype)
        ops.score_topk(mine, tensor(sq), tensor(q), 10, scales=_opt(scales))
        ops.score_topk_rows(mine, tensor(sq), tensor(pv), tensor(pf),
                            tensor(q), 10, scales=_opt(scales))
    assert _build.launch_counts() == {}
