"""CUDA kernel B1: fused per-dim normalize + psi fold.

out = (v - mu_v)/sd_v - alpha * ((f - mu_f)/sd_f) @ P, in one pass over the
rows (``csrc/fcvi_transform.cu``). Replaces the Pallas kernel
``repro/kernels/fcvi_transform.py::fused_transform``; its plain version is
``ref.ref_fused_transform``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "fused_transform"


def fused_transform(v: torch.Tensor, f: torch.Tensor, proj: torch.Tensor,
                    alpha: float, mean_v: Optional[torch.Tensor] = None,
                    std_v: Optional[torch.Tensor] = None,
                    mean_f: Optional[torch.Tensor] = None,
                    std_f: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v: (n, d), f: (n, m), proj: (m, d), all float32 on one CUDA device.
    A normalizer pair left as None is the identity. Returns (n, d)."""
    if v.dim() != 2 or f.dim() != 2:
        raise ValueError("v and f must be 2-D")
    n, d = v.shape
    m = f.shape[1]
    dev = v.device
    _build.require(v, "v", (n, d), dev)
    _build.require(f, "f", (n, m), dev)
    _build.require(proj, "proj", (m, d), dev)
    for name, t, dim in (("mean_v", mean_v, d), ("std_v", std_v, d),
                         ("mean_f", mean_f, m), ("std_f", std_f, m)):
        if t is not None:
            _build.require(t, name, (dim,), dev)
    if (mean_v is None) != (std_v is None) or (mean_f is None) != (std_f is None):
        raise ValueError("pass each normalizer's mean and std together")
    out = torch.empty_like(v)
    ptr = _build.ptr
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_fused_transform(
            v.data_ptr(), f.data_ptr(), proj.data_ptr(), float(alpha),
            ptr(mean_v), ptr(std_v), ptr(mean_f), ptr(std_f), out.data_ptr(),
            n, d, m, _build.stream(dev))
    _build.check(code, NAME)
    _build.count(NAME)
    return out
