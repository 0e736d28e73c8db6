"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch into
per-expert buffers, the expert FFNs as one batched product, and the
combine. Mirrors ``repro.models.moe`` without a mesh.

The reference groups tokens by the data-parallel degree (``_dp_groups``),
which is 1 without a mesh: this is that one-group function. Its EP
sharding of the experts waits for the model's shardings (ROADMAP A13f).

What must match the reference for the same tokens to be dropped:

* the router's top-k keeps the first occurrence on ties (``lax.top_k``'s
  order; ``topk_first``), and the gates renormalise in fp32 with a 1e-9
  floor;
* the capacity is the reference's Python arithmetic,
  ``int(capacity_factor * t * top_k / n_experts)`` clamped to [8, t];
* a (token, expert) pair's slot is the number of earlier pairs of that
  expert in the token-major, k-inner flattening; pairs at or past the
  capacity are dropped and pass through the residual.

The dispatch writes each kept pair into its unique (expert, slot) with a
plain index write (the reference's scatter-add onto zeros; dropped pairs
go to a spare row that is cut off). The combine sums each token's
``top_k`` contributions in bf16 in the order k = 0, 1, ..., rounding after
each add, as the reference's scatter-add of bf16 updates does; no atomics,
so the card adds in the same order. The expert products are bf16 with
fp32 accumulation and ``silu(g) * h`` runs op by op in bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.kernels.ref import topk_first
from repro_torch.models.layers import _param, bf16, normal_, silu


class MoE(nn.Module):
    """``w_router`` (d, E), ``we_in`` / ``we_gate`` (E, d, f), ``we_out``
    (E, f, d)."""

    def __init__(self, d: int, d_ff: int, n_experts: int, device=None):
        super().__init__()
        self.w_router = _param((d, n_experts), device)
        self.we_in = _param((n_experts, d, d_ff), device)
        self.we_gate = _param((n_experts, d, d_ff), device)
        self.we_out = _param((n_experts, d_ff, d), device)

    def reset_parameters(self, gen=None) -> None:
        d, f = self.we_in.shape[1:]
        for w in (self.w_router, self.we_in, self.we_gate):
            normal_(w, 1.0 / math.sqrt(d), gen)
        normal_(self.we_out, 1.0 / math.sqrt(f), gen)


def capacity(capacity_factor: float, tokens: int, top_k: int,
             n_experts: int) -> int:
    """Slots an expert holds: the reference's Python arithmetic."""
    c = int(capacity_factor * tokens * top_k / n_experts)
    return max(8, min(c, tokens))


def route(p: MoE, xt: Tensor, top_k: int, cap: int):
    """The router over tokens ``xt`` (t, d). Returns (probs (t, E) fp32,
    gate values (t, K) fp32 renormalised, experts (t, K) int64, each pair's
    slot (t * K,) int64, keep (t * K,) bool)."""
    n_experts = p.w_router.shape[-1]
    logits = xt.float() @ p.w_router.float()
    e = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = e / torch.sum(e, dim=-1, keepdim=True)
    gate_vals, experts = topk_first(probs, top_k)
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, dim=-1, keepdim=True), 1e-9)
    pos, keep = slots(experts, n_experts, cap)
    return probs, gate_vals, experts, pos, keep


def slots(experts: Tensor, n_experts: int, cap: int):
    """Each (token, expert) pair's slot in its expert's buffer and whether
    it is kept. ``experts`` (t, K). Returns (pos (t * K,) int64, keep
    (t * K,) bool)."""
    flat_e = experts.reshape(-1)                       # token-major, k inner
    # each pair's rank among its expert's pairs: a running count along the
    # pairs, one row an expert (a scan along the inner, contiguous axis)
    rank = torch.cumsum(F.one_hot(flat_e, n_experts).T.contiguous(), dim=1)
    pos = torch.gather(rank, 0, flat_e[None, :])[0] - 1
    return pos, pos < cap


def apply_moe(p: MoE, x: Tensor, *, top_k: int,
              capacity_factor: float = 1.25, return_aux: bool = False):
    """x: (b, s, d) -> (b, s, d) bf16 (and the load-balancing aux loss,
    a 0-d fp32 tensor, with ``return_aux``). Dropped tokens pass through
    the residual."""
    b, s, d = x.shape
    n_experts = p.w_router.shape[-1]
    t = b * s
    xt = x.reshape(t, d)
    cap = capacity(capacity_factor, t, top_k, n_experts)
    probs, gate_vals, experts, pos, keep = route(p, xt, top_k, cap)
    flat_e = experts.reshape(-1)
    # kept pairs own unique (expert, slot) rows; dropped ones a spare row
    dump = n_experts * cap
    slot = torch.where(keep, flat_e * cap + pos, dump)
    tok_ids = torch.arange(t, device=x.device).repeat_interleave(top_k)
    contrib = torch.where(keep[:, None], bf16(xt[tok_ids]), 0.0)
    buf = contrib.new_zeros((dump + 1, d))
    buf[slot] = contrib
    buf = buf[:dump].reshape(n_experts, cap, d)
    h = torch.bmm(buf, bf16(p.we_in))
    g = torch.bmm(buf, bf16(p.we_gate))
    out_buf = torch.bmm(silu(g) * h, bf16(p.we_out)).reshape(dump, d)
    safe = torch.where(keep, slot, 0)
    weighted = out_buf[safe] * (gate_vals.reshape(-1, 1) * keep[:, None])
    weighted = bf16(weighted).reshape(t, top_k, d)
    y = weighted.new_zeros((t, d))
    for k in range(top_k):
        y = y + weighted[:, k]
    y = y.reshape(b, s, d)
    if return_aux:
        me = torch.mean(probs, dim=0)
        ce = torch.mean(F.one_hot(experts[:, 0], n_experts).float(), dim=0)
        return y, n_experts * torch.sum(me * ce)
    return y
