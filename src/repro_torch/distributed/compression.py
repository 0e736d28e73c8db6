"""Gradient compression for the scarce cross-pod links.

int8 block-quantization with stochastic rounding: unbiased (E[deq] = x), so
SGD/Adam convergence is preserved in expectation; per-block scales bound the
worst-case error to one quantization step. Mirrors
``repro.distributed.compression``: the same blocks, the same scales bit for
bit and the same arithmetic; the rounding noise is drawn from a
``torch.Generator`` (``torch.rand``), so a code may land one step from the
reference's for the same input.

``cross_pod_grad_sync`` is the two-stage gradient sync of a multi-pod
mesh: an fp32 reduce within each pod (the fat links), then each pod's
partial quantized once to int8, dequantized and summed across pods (the
thin ones).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.distributed.sharding import (CollectiveStats, flat_index,
                                              positions, quiet_ops, scope)

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


def cross_pod_grad_sync(mesh, pod_axis: str = "pod",
                        stats: Optional[CollectiveStats] = None,
                        int8: bool = True):
    """Two-stage sync over ``mesh``: an fp32 sum over every axis but
    ``pod_axis``, then int8 across pods. Returns ``sync(blocks, gen,
    dim=None)``: ``blocks`` an object array of the mesh's shape holding
    each position's gradient leaf (one shape for all); the result, an
    object array of each position's synced leaf (positions of one pod on
    one device share it). Each pod sums its positions' leaves in
    row-major order; its partial is quantized exactly once, with noise
    from ``gen`` (a generator on the partial's device, drawn pod by pod
    in order); the pods' dequantized partials are summed in pod order.
    With ``dim``, the within-pod sum is a reduce-scatter: each position
    keeps its block of ``dim`` (split over the inner axes, row-major), and
    that block crosses the pods. Without a pod axis it is a plain fp32
    sum. The reference quantizes every pod's partial with one key; here
    each pod draws its own noise. ``int8=False`` sums the pods' partials
    in fp32 (the reference's sharded train step sums so).

    ``stats`` records the within-pod all-reduce (or reduce-scatter) at the
    leaves' bytes and the cross-pod all-reduce at the int8 wire format's
    (codes and scales)."""
    names = mesh.axis_names
    inner = tuple(a for a in names if a != pod_axis)
    has_pod = pod_axis in names
    n_pods = mesh.shape[pod_axis] if has_pod else 1
    n_inner = mesh.size // n_pods

    def record(kind, axes, nbytes):
        if stats is not None and axes:
            stats.add(kind, ",".join(axes), nbytes)

    def hop(totals, slot, gen, dim):
        """One slot's pod partials quantized, crossed and summed."""
        partials = [t if slot is None else
                    t.chunk(n_inner, dim)[slot].contiguous() for t in totals]
        if not has_pod:
            return partials[0]
        deq = []
        width = n_inner if slot is None else 1
        for part in partials:
            if not int8:
                record("all-reduce", (pod_axis,), width * part.numel() * 4)
                deq.append(part)
                continue
            codes, scales, pad = quantize_int8(
                part if gen is None else part.to(gen.device), gen)
            record("all-reduce", (pod_axis,), width * (
                codes.numel() + 4 * scales.numel()))
            deq.append(dequantize_int8(codes, scales, pad, part.shape,
                                       torch.float32))
        with quiet_ops():      # the cross-pod all-reduce's own sum
            synced = deq[0]
            for t in deq[1:]:
                synced = synced + t.to(synced.device)
        return synced

    def sync(blocks: np.ndarray, gen: Optional[torch.Generator], dim=None):
        pods: list = [[] for _ in range(n_pods)]
        flat: dict = {}
        for pos, coords in positions(mesh):
            pods[coords.get(pod_axis, 0)].append((pos, blocks[pos]))
            flat[pos] = flat_index(mesh, coords)
        leaf = pods[0][0][1]
        kind = "all-reduce" if dim is None else "reduce-scatter"
        record(kind, inner, mesh.size * leaf.numel() * leaf.element_size())
        totals = []
        with quiet_ops():      # the within-pod reduce's own sums
            for members in pods:
                home = mesh.devices[members[0][0]]
                total = members[0][1].float().to(home)
                for _, t in members[1:]:
                    total = total + t.float().to(home)
                totals.append(total)
        out = np.empty(mesh.devices.shape, dtype=object)
        # each inner position's slot (its block of dim), or the whole leaf
        # for all of them; a cost trace counts each slot's hop for the
        # positions holding it
        for slot in (range(n_inner) if dim is not None else [None]):
            held = [(pos, flat[pos]) for members in pods
                    for i, (pos, _) in enumerate(members)
                    if slot is None or i == slot]
            with scope([f for _, f in held]):
                synced = hop(totals, slot, gen, dim)
            for pos, _ in held:
                out[pos] = synced.to(mesh.devices[pos])
        return out

    return sync
