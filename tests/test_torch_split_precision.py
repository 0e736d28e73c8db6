"""The accuracy of the flat scan's split products, emulated on the CPU.

The CUDA scan (``csrc/fused_score_topk.cu``) forms its dot products on the
tensor cores: fp32 rows as three TF32 products (3xTF32), bf16 and int8 rows
(exact in bf16) against the query split into three bf16 terms.
``ref.split_scores`` emulates those products by masking mantissa bits and
sums them exactly; these tests hold the emulated scores against fp64 on
SIFT-scale (d=128) and GIST-scale (d=384, 960) data from numpy seeds. The
split's error sits inside the scan's L2 tolerance (rtol 1e-5 / atol 1e-4,
plus at d > 128 the sqrt(d) depth term of ``chip_smoke.py`` phase 3g) with
a margin of MARGIN; one uncompensated TF32 or bf16 product does not fit
in it, which is why the split exists.

The emulation covers the split only. The tensor cores' own accumulation
(which does not round to nearest, and whose error grows with the terms one
MMA sum adds) is not emulated, and on the card it is the larger part of
the scan's error: the margin stated here is the split's, not the kernel's.
The kernel's own margin, on near-cancelling scores, is held on the card
by ``tests/test_torch_gpu.py::test_flat_scan_near_cancelling_scores``.
"""
import numpy as np
import pytest
import torch

from repro_torch.index import quant
from repro_torch.kernels import ref

L2_RTOL, L2_ATOL = 1e-5, 1e-4
MARGIN = 20.0    # the split's worst error against its tolerance
                 # (the split alone: no MMA accumulation error)


def _case(d, seed, n=1500, b=24):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return x, q


def _tolerance(exact, q, x, d):
    """The scan's L2 tolerance on each score, with the depth term of phase
    3g (4 sqrt(d) u ||q|| max ||x||) at d > 128."""
    atol = torch.full((q.shape[0], 1), L2_ATOL, dtype=torch.float64)
    if d > 128:
        xmax = torch.sqrt(torch.max(torch.sum(x.double() ** 2, dim=-1)))
        qn = torch.sqrt(torch.sum(q.double() ** 2, dim=-1, keepdim=True))
        atol = atol + 4.0 * d ** 0.5 * 2.0 ** -24 * qn * xmax
    return atol + L2_RTOL * exact.abs()


def _exact(rows, sq, q, scales=None):
    """fp64 scores of the stored rows (dequantized) against the queries."""
    x = rows.double()
    if scales is not None:
        x = x * scales.double()[:, None]
    q = q.double()
    return (2.0 * (q @ x.T) - (x * x).sum(-1)[None, :]
            - (q * q).sum(-1, keepdim=True))


def _worst(rows, sq, q, kind, scales, d):
    """max |emulated - fp64| / tolerance over every (query, row) pair."""
    got = ref.split_scores(rows, sq, q, kind, scales).double()
    exact = _exact(rows, sq, q, scales)
    return ((got - exact).abs() / _tolerance(exact, q, rows.float(), d)).max()


def _stored(x, dtype):
    if dtype == "float32":
        return x, None, (x.double() ** 2).sum(-1).float()
    if dtype == "bfloat16":
        rows = x.to(torch.bfloat16)
        return rows, None, (rows.double() ** 2).sum(-1).float()
    rows, scales = quant.quantize_rows(x)
    deq = rows.double() * scales.double()[:, None]
    return rows, scales, (deq ** 2).sum(-1).float()


def test_tf32_and_bf16_rounding_masks_mantissa_bits():
    u = 2.0 ** -11
    x = torch.tensor([1.0 + u, 1.0 + 3 * u, -(1.0 + u), 1.0 + u / 2, 3.0])
    # ties go away from zero; 10 mantissa bits stay
    assert ref.tf32_round(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                                         -(1.0 + 2.0 ** -10), 1.0, 3.0]
    bits = ref.tf32_round(torch.randn(1000)).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    # the two-term split keeps about 22 bits: hi + lo within 2^-21 of x
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000).astype(np.float32))
    hi, lo = ref.split_terms(v, "tf32x2")
    assert bool(((hi.double() + lo.double() - v.double()).abs()
                 <= 2.0 ** -21 * v.double().abs()).all())
    t = ref.split_terms(v, "bf16x3")
    assert bool(((sum(u.double() for u in t) - v.double()).abs()
                 <= 2.0 ** -24 * v.double().abs()).all())


@pytest.mark.parametrize("d,seed", [(128, 0), (384, 1), (960, 2)])
def test_3xtf32_fp32_rows_inside_tolerance(d, seed):
    x, q = _case(d, seed)
    rows, scales, sq = _stored(x, "float32")
    assert _worst(rows, sq, q, "3xtf32", scales, d) <= 1.0 / MARGIN


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("d,seed", [(128, 3), (384, 4), (960, 5)])
def test_bf16x3_split_query_inside_tolerance(dtype, d, seed):
    x, q = _case(d, seed)
    rows, scales, sq = _stored(x, dtype)
    # the rows are exact in bf16: int8 codes are integers of at most 8 bits
    assert torch.equal(rows.float().to(torch.bfloat16).float(), rows.float())
    assert _worst(rows, sq, q, "bf16x3", scales, d) <= 1.0 / MARGIN


@pytest.mark.parametrize("d,seed", [(128, 6), (384, 7), (960, 8)])
def test_one_pass_products_miss_the_tolerance(d, seed):
    """A single TF32 product (fp32 rows), or a single bf16 query term (bf16
    rows), falls outside the scan's tolerance: the split is needed."""
    x, q = _case(d, seed)
    rows, scales, sq = _stored(x, "float32")
    assert _worst(rows, sq, q, "tf32", scales, d) > 1.0
    rows, scales, sq = _stored(x, "bfloat16")
    assert _worst(rows, sq, q, "bf16", scales, d) > 1.0


def test_split_scores_keep_the_kernel_order():
    """Scale, ||x||^2 and ||q||^2 enter after the dot product, as the
    kernel's epilogue applies them; on integer data every split is exact
    and equals the plain version bit for bit."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.integers(-3, 4, (200, 16)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-3, 4, (5, 16)).astype(np.float32))
    sq = (x * x).sum(-1)
    want = ref.ref_score_topk(x, sq, q, 200)[0]
    for kind in ("3xtf32", "bf16x3"):
        got = ref.split_scores(x, sq, q, kind)
        assert torch.equal(torch.sort(got, dim=-1, descending=True)[0], want)
