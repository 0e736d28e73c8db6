"""CUDA kernel B4: fused combined-cosine re-rank score.

score = lam * cos(v, q) + (1 - lam) * cos(f, F_q) per candidate, one warp per
candidate row (``csrc/rescore.cu``). Replaces the Pallas kernel
``repro/kernels/rescore.py::rescore``; its plain version is
``ref.ref_rescore``. bf16 inputs are cast up to fp32 before the kernel, as
the reference casts every input up first; any other dtype than fp32 and
bf16 raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "rescore"


def rescore(cand_v: torch.Tensor, cand_f: torch.Tensor, qn: torch.Tensor,
            fqn: torch.Tensor, lam: float) -> torch.Tensor:
    """cand_v: (b, kp, d); cand_f: (b, kp, m); qn: (b, d); fqn: (b, m), all
    float32 or bfloat16 on one CUDA device. Returns (b, kp) float32."""
    cand_v, cand_f, qn, fqn = (
        t.to(torch.float32) if t.dtype == torch.bfloat16 else t
        for t in (cand_v, cand_f, qn, fqn))
    if cand_v.dim() != 3 or cand_f.dim() != 3:
        raise ValueError("cand_v and cand_f must be 3-D")
    b, kp, d = cand_v.shape
    m = cand_f.shape[-1]
    dev = cand_v.device
    _build.require(cand_v, "cand_v", (b, kp, d), dev)
    _build.require(cand_f, "cand_f", (b, kp, m), dev)
    _build.require(qn, "qn", (b, d), dev)
    _build.require(fqn, "fqn", (b, m), dev)
    out = torch.empty((b, kp), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_rescore(
            cand_v.data_ptr(), cand_f.data_ptr(), qn.data_ptr(),
            fqn.data_ptr(), float(lam), 1.0 - float(lam), out.data_ptr(),
            b, kp, d, m, _build.stream(dev))
    _build.check(code, NAME)
    _build.count(NAME)
    return out
