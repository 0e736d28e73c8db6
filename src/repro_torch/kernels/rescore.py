"""CUDA kernel B4: the combined-cosine re-rank.

score = lam * cos(v, q) + (1 - lam) * cos(f, F_q) per candidate, one warp per
candidate row (``csrc/rescore.cu``). Replaces the Pallas kernel
``repro/kernels/rescore.py::rescore``; its plain version is
``ref.ref_rescore``.

``rescore_topk`` is the re-rank the callers run around it (the reference's
``lax.top_k`` and ``take_along_axis``): the scores, their first-occurrence
top-k (``ref.topk_first``'s order) and the candidates' ids at those
positions, as one launch, one block per query; its scores are
``rescore``'s bits. Past what a block's shared memory holds (``fits``) it
runs the scores-only kernel and ``topk_first``, counted ``rescore_wide``:
a shape rule, not a fallback. Its plain version is
``ref.ref_rescore_topk``.

bf16 inputs are cast up to fp32 before the kernel, as the reference casts
every input up first; any other dtype than fp32 and bf16 raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import topk_first

NAME = "rescore"
NAME_WIDE = "rescore_wide"
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (bytes)
# rescore_topk_kernel's dynamic shared memory, beside its static histogram
TOPK_SMEM_LIMIT = SMEM_LIMIT - 2048
ID_BYTES = {torch.int32: 4, torch.int64: 8}


def topk_smem(kp: int, d: int, m: int) -> int:
    """rescore_topk_kernel's dynamic shared memory in bytes: a 32-bit key,
    a score and a gathered position a candidate (kp rounded up to 4 each)
    and the query's d + m columns."""
    return 4 * (3 * (-(-kp // 4) * 4) + d + m)


def fits(kp: int, d: int, m: int) -> bool:
    """Whether the fused re-rank takes kp candidates of d + m columns (kp
    up to 19,152 at d = 128, m = 8); past it ``rescore_topk`` takes the
    wide route."""
    return topk_smem(kp, d, m) <= TOPK_SMEM_LIMIT


def _operands(cand_v, cand_f, qn, fqn):
    """The four tiles cast up from bf16 and checked once: (b, kp, d) and
    (b, kp, m) candidates, (b, d) and (b, m) queries, float32, contiguous,
    on cand_v's device."""
    ts = (cand_v, cand_f, qn, fqn)
    if torch.bfloat16 in (cand_v.dtype, cand_f.dtype, qn.dtype, fqn.dtype):
        ts = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)
    if ts[0].dim() != 3 or ts[1].dim() != 3:
        raise ValueError("cand_v and cand_f must be 3-D")
    b, kp, d = ts[0].shape
    m = ts[1].shape[-1]
    shapes = ((b, kp, d), (b, kp, m), (b, d), (b, m))
    dev = ts[0].device
    f32 = torch.float32
    if not all(t.dtype == f32 and t.shape == shape and t.is_contiguous()
               and t.device == dev for t, shape in zip(ts, shapes)):
        for t, name, shape in zip(ts, ("cand_v", "cand_f", "qn", "fqn"),
                                  shapes):
            _build.require(t, name, shape, dev)   # raises with the reason
    return ts, (b, kp, d, m), dev


def _launch(dev, call):
    """Run ``call(stream)`` with ``dev`` current (no device switch when it
    already is)."""
    if dev.index == torch.cuda.current_device():
        return call(_build.stream(dev))
    with torch.cuda.device(dev):
        return call(_build.stream(dev))


def _scores(ts, shape, dev, lam):
    b, kp, d, m = shape
    out = torch.empty((b, kp), dtype=torch.float32, device=dev)
    lib = _build.library()
    code = _launch(dev, lambda st: lib.fcvi_rescore(
        ts[0].data_ptr(), ts[1].data_ptr(), ts[2].data_ptr(),
        ts[3].data_ptr(), float(lam), 1.0 - float(lam), out.data_ptr(), b,
        kp, d, m, st))
    _build.check(code, NAME)
    return out


def rescore(cand_v: torch.Tensor, cand_f: torch.Tensor, qn: torch.Tensor,
            fqn: torch.Tensor, lam: float) -> torch.Tensor:
    """cand_v: (b, kp, d); cand_f: (b, kp, m); qn: (b, d); fqn: (b, m), all
    float32 or bfloat16 on one CUDA device. Returns (b, kp) float32."""
    ts, shape, dev = _operands(cand_v, cand_f, qn, fqn)
    out = _scores(ts, shape, dev, lam)
    _build.count(NAME)
    return out


def rescore_topk(cand_v: torch.Tensor, cand_f: torch.Tensor,
                 qn: torch.Tensor, fqn: torch.Tensor, lam: float,
                 cand_ids: torch.Tensor, k: int):
    """``rescore``'s scores, their top min(k, kp) by (score desc, position
    asc) as ``topk_first`` ranks them, and ``cand_ids`` (b, kp) int32 or
    int64 at those positions. Returns (scores (b, k) float32, ids (b, k) in
    cand_ids' dtype)."""
    ts, (b, kp, d, m), dev = _operands(cand_v, cand_f, qn, fqn)
    if cand_ids.dtype not in ID_BYTES:
        raise ValueError(f"cand_ids must be int32 or int64, got "
                         f"{cand_ids.dtype}")
    cand_ids = cand_ids.contiguous()   # an expanded arange, for the delta
    _build.require(cand_ids, "cand_ids", (b, kp), dev, cand_ids.dtype)
    k = max(0, min(k, kp))
    if b == 0 or k == 0:
        return (torch.empty((b, k), dtype=torch.float32, device=dev),
                torch.empty((b, k), dtype=cand_ids.dtype, device=dev))
    if not fits(kp, d, m):
        vals, pos = topk_first(_scores(ts, (b, kp, d, m), dev, lam), k)
        _build.count(NAME_WIDE)
        return vals, torch.gather(cand_ids, -1, pos)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=cand_ids.dtype, device=dev)
    lib = _build.library()
    code = _launch(dev, lambda st: lib.fcvi_rescore_topk(
        ts[0].data_ptr(), ts[1].data_ptr(), ts[2].data_ptr(),
        ts[3].data_ptr(), float(lam), 1.0 - float(lam), cand_ids.data_ptr(),
        ID_BYTES[cand_ids.dtype], b, kp, d, m, k, topk_smem(kp, d, m),
        vals.data_ptr(), ids.data_ptr(), st))
    _build.check(code, NAME)
    _build.count(NAME)
    return vals, ids
