"""Gradient compression for the scarce cross-pod links.

int8 block-quantization with stochastic rounding: unbiased (E[deq] = x), so
SGD/Adam convergence is preserved in expectation; per-block scales bound the
worst-case error to one quantization step. Mirrors
``repro.distributed.compression``: the same blocks, the same scales bit for
bit and the same arithmetic; the rounding noise is drawn from a
``torch.Generator`` (``torch.rand``), so a code may land one step from the
reference's for the same input.

The two-stage sync that uses it across pods (``cross_pod_grad_sync``: fp32
reduce within a pod, int8 across pods) belongs to the model's shardings
(ROADMAP A13f) and is not here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

BLOCK = 256


def _pad_to_block(x: Tensor):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def quantize_int8(x: Tensor, gen: torch.Generator):
    """Block-wise int8 quantization with stochastic rounding; the noise is
    uniform in [0, 1) from ``gen`` (a generator on ``x``'s device).

    Returns (codes int8 (nblocks, BLOCK), scales fp32 (nblocks,), pad).
    Unbiased: E[dequantize(quantize(x))] == x."""
    blocks, pad = _pad_to_block(x.float())
    scales = torch.amax(torch.abs(blocks), dim=1) / 127.0
    safe = torch.clamp_min(scales, 1e-12)
    scaled = blocks / safe[:, None]
    noise = torch.rand(scaled.shape, generator=gen, device=x.device)
    codes = torch.clamp(torch.floor(scaled + noise), -127, 127).to(torch.int8)
    return codes, scales, pad


def dequantize_int8(codes: Tensor, scales: Tensor, pad: int, shape,
                    dtype) -> Tensor:
    flat = (codes.float() * scales[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def compress_ratio(x: Tensor) -> float:
    """Bytes(int8 codes + scales) / bytes(f32)."""
    nblocks = -(-x.numel() // BLOCK)
    return (nblocks * BLOCK + nblocks * 4) / (x.numel() * 4)
