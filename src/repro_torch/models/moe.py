"""Mixture-of-Experts FFN: top-k routing, capacity-based dispatch into
per-expert buffers, the expert FFNs as one batched product, and the
combine. Mirrors ``repro.models.moe``.

The reference groups tokens by the data-parallel degree (``_dp_groups``):
under rules with a mesh whose batch axes have G positions (G > 1
dividing the batch), the tokens split into G groups of consecutive rows,
each dispatched alone with its own capacity, which changes which tokens
drop. Without a mesh G is 1. A sharded train step hands each of its
batch groups its own rows, which are one dispatch group.

In a sharded step's group the experts' weights split over the
tensor-parallel axis as the rules place them: by experts (EP: the router's
columns, each position's experts run on its slice of the dispatch buffer,
an all-gather joins their outputs) or by ``moe_ff`` (each position's
columns of the hidden layer, fp32 partial outputs summed by an all-reduce
and rounded once).

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

from repro_torch.distributed.sharding import (Blocks, current_rules,
                                              group_of)
from repro_torch.kernels.ref import topk_first
from repro_torch.models.layers import _param, bf16, dot_f32, normal_, silu


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


def _dp_groups(batch: int, in_group: bool = False) -> int:
    """Number of dispatch groups: the data-parallel degree of the current
    rules' mesh where it divides the batch, else 1 (and 1 ``in_group``, a
    sharded step's group, whose rows are one group)."""
    r = current_rules()
    if in_group or r is None or r.mesh is None:
        return 1
    ax = r.rules.get("batch")
    if ax is None:
        return 1
    axes = ax if isinstance(ax, tuple) else (ax,)
    g = 1
    for a in axes:
        g *= r.mesh.shape.get(a, 1)
    return g if (g > 1 and batch % g == 0) else 1


def route(p: MoE, xt: Tensor, top_k: int, cap: int):
    """The router over tokens ``xt`` (t, d). Returns (probs (t, E) fp32,
    gate values (t, K) fp32 renormalised, experts (t, K) int64, each pair's
    slot (t * K,) int64, keep (t * K,) bool)."""
    w = p.w_router
    if isinstance(w, Blocks):       # experts split: each position's logits
        tp = w.group
        logits = tp.gathered([xm.float() @ wm.float() for xm, wm in
                              zip(tp.broadcast(xt), w)], 1)
    else:
        logits = xt.float() @ w.float()
    n_experts = logits.shape[-1]
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
    # pairs, one row an expert (a scan along the inner, contiguous axis);
    # the one-hot rows by comparison (``F.one_hot`` checks its range on
    # the host)
    hot = torch.arange(n_experts, device=flat_e.device)[:, None] == flat_e
    rank = torch.cumsum(hot.long(), dim=1)
    pos = torch.gather(rank, 0, flat_e[None, :])[0] - 1
    return pos, pos < cap


def _experts(p: MoE, buf: Tensor) -> Tensor:
    """The expert FFNs over the dispatch buffer (E, C, d) bf16."""
    we_in, we_gate, we_out = p.we_in, p.we_gate, p.we_out
    if not isinstance(we_in, Blocks):
        h = torch.bmm(buf, bf16(we_in))
        g = torch.bmm(buf, bf16(we_gate))
        return torch.bmm(silu(g) * h, bf16(we_out))
    tp = we_in.group
    dims = (we_in.dim, we_gate.dim, we_out.dim)
    if dims == (0, 0, 0):           # EP: each position's experts
        outs = [torch.bmm(silu(torch.bmm(bm, bf16(wg)))
                          * torch.bmm(bm, bf16(wi)), bf16(wo))
                for bm, wi, wg, wo in zip(tp.split(buf, 0), we_in, we_gate,
                                          we_out)]
        return tp.gathered(outs, 0)
    if dims == (2, 2, 1):           # moe_ff: partial products
        return bf16(tp.psum([dot_f32(silu(torch.bmm(bm, bf16(wg)))
                                     * torch.bmm(bm, bf16(wi)), wo)
                             for bm, wi, wg, wo in zip(
                                 tp.broadcast(buf), we_in, we_gate,
                                 we_out)]))
    raise ValueError("the experts split over the tensor-parallel axis by "
                     "experts or by moe_ff, not as their rules place them")


def apply_moe(p: MoE, x: Tensor, *, top_k: int,
              capacity_factor: float = 1.25, return_aux: bool = False):
    """x: (b, s, d) -> (b, s, d) bf16 (and the load-balancing aux loss,
    a 0-d fp32 tensor, with ``return_aux``). Dropped tokens pass through
    the residual. The tokens dispatch in ``_dp_groups`` groups."""
    b, s, d = x.shape
    groups = _dp_groups(b, group_of(p) is not None)
    outs = [_moe_group(p, xg.reshape(-1, d), top_k, capacity_factor)
            for xg in x.chunk(groups, 0)]
    y = torch.cat([o[0] for o in outs]).reshape(b, s, d)
    if return_aux:
        probs = torch.cat([o[1] for o in outs])
        experts = torch.cat([o[2] for o in outs])
        n_experts = probs.shape[-1]
        me = torch.mean(probs, dim=0)
        ce = torch.mean(F.one_hot(experts[:, 0], n_experts).float(), dim=0)
        return y, n_experts * torch.sum(me * ce)
    return y


def _moe_group(p: MoE, xt: Tensor, top_k: int, capacity_factor: float):
    """One dispatch group of tokens ``xt`` (t, d): (y (t, d) bf16, probs,
    experts)."""
    t, d = xt.shape
    w = p.w_router
    n_experts = (sum(wm.shape[-1] for wm in w) if isinstance(w, Blocks)
                 else w.shape[-1])
    cap = capacity(capacity_factor, t, top_k, n_experts)
    probs, gate_vals, experts, pos, keep = route(p, xt, top_k, cap)
    flat_e = experts.reshape(-1)
    # kept pairs own unique (expert, slot) rows; dropped ones a spare row
    dump = n_experts * cap
    slot = torch.where(keep, flat_e * cap + pos, dump)
    tok_ids = torch.arange(t, device=xt.device).repeat_interleave(top_k)
    contrib = torch.where(keep[:, None], bf16(xt[tok_ids]), 0.0)
    buf = contrib.new_zeros((dump + 1, d))
    buf[slot] = contrib
    buf = buf[:dump].reshape(n_experts, cap, d)
    out_buf = _experts(p, buf).reshape(dump, d)
    safe = torch.where(keep, slot, 0)
    weighted = out_buf[safe] * (gate_vals.reshape(-1, 1) * keep[:, None])
    weighted = bf16(weighted).reshape(t, top_k, d)
    y = weighted.new_zeros((t, d))
    for k in range(top_k):
        y = y + weighted[:, k]
    return y, probs, experts
