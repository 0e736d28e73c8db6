"""Per-row symmetric int8 quantization for corpus slabs (the int8 rung of
the storage ladder, ``FCVIConfig.storage_dtype="int8"``).

Each corpus row is stored as int8 codes plus one fp32 scale, ``amax / 127``,
so the row's largest magnitude maps to +-127 and the round never clips.
Rows whose value range is zero (all-zero rows, the zero pad rows of
grouped slabs) get scale 1.0 and codes 0. The scan kernels read the codes
and multiply the dot product's output by the scale, so accumulation stays
fp32 and the scores are exact for the dequantized rows; the squared norms
are those of the dequantized rows.

A copy of ``repro.index.quant`` in PyTorch: ``torch.round`` and
``jnp.round`` both round half to even, so codes and scales are bit-equal to
the reference's on the same fp32 input.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# int8 symmetric range: the scale maps the row's absolute max onto +-127
QMAX = 127.0


def quantize_rows(x: Tensor):
    """Rows of ``x`` (..., d) -> (codes (..., d) int8, scales (...,) fp32).
    A (0, d) input gives (0,) scales."""
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=-1)
    scales = torch.where(amax > 0.0, amax / QMAX,
                         torch.ones_like(amax))
    codes = torch.round(x / scales[..., None]).to(torch.int8)
    return codes, scales


def dequantize_rows(codes: Tensor, scales: Tensor) -> Tensor:
    """The one dequantization formula every consumer shares (plain scans,
    the kernels' carried rows, exact refine): ``codes.float() * scale``."""
    return codes.to(torch.float32) * scales[..., None]


def sq_norms_of(codes: Tensor, scales: Tensor) -> Tensor:
    """fp32 squared norms of the dequantized rows (the slab's sq_norms)."""
    return torch.sum(dequantize_rows(codes, scales) ** 2, dim=-1)


def is_quantized(dtype) -> bool:
    """True for storage dtypes that carry per-row scales (int8)."""
    return dtype is not None and (dtype is torch.int8 or dtype == "int8")
