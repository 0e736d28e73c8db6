"""Building-block layers of the decoder LMs. Mirrors ``repro.models.layers``.

Compute dtype is bf16: activations are cast at the entry of each matmul,
parameters stay fp32 and are cast where they are used, and reductions
(norms, softmax statistics, RoPE angles) run in fp32. The layers with
parameters are ``nn.Module``s whose parameters carry the reference's names
and shapes, so a JAX param tree loads leaf by leaf; the rest are functions
on tensors.

A product of bf16 operands with an fp32 result (the reference's
``preferred_element_type=jnp.float32``) is ``dot_f32``: both operands are
rounded to bf16, widened to fp32 and multiplied there. The product of two
bf16 numbers is exact in fp32, so this is the reference's function up to
the order of the fp32 sum; the package switches TF32 off at import, so the
card's fp32 GEMM keeps every product. A plain bf16 product (bf16 result)
is a bf16 matmul, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import Tensor, nn

from repro_torch.distributed.sharding import Blocks

COMPUTE_DTYPE = torch.bfloat16


def bf16(x: Tensor) -> Tensor:
    return x.to(COMPUTE_DTYPE)


def dot_f32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of the bf16-rounded operands, in fp32 (see the module
    docstring)."""
    return torch.matmul(bf16(a).float(), bf16(b).float())


def weak_scalar(x: Tensor, c: float) -> Tensor:
    """A Python float as JAX combines it with the array ``x``: a weak type,
    so it takes ``x``'s dtype first. In bf16 that rounds the constant:
    ``embed_scale``'s sqrt(1152) = 33.94 multiplies as 34.0, where torch's
    ``x * 33.94`` would keep it in fp32 and round only the product."""
    return torch.tensor(c, dtype=x.dtype, device=x.device)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


def normal_(p: Tensor, std: float, gen: Optional[torch.Generator]) -> None:
    """Fill ``p`` with N(0, std^2) from ``gen``; nothing on the meta
    device."""
    if p.device.type != "meta":
        with torch.no_grad():
            p.normal_(0.0, std, generator=gen)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """Gemma's RMSNorm: scales by ``1 + scale`` (scale starts at zeros)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + scale)
    return y.to(x.dtype)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor,
               eps: float = 1e-5) -> Tensor:
    """LayerNorm with the population variance (ddof = 0)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param((d,), device)

    def reset_parameters(self, gen=None) -> None:
        with torch.no_grad():
            self.scale.zero_()

    def forward(self, x: Tensor) -> Tensor:
        return rms_norm(x, self.scale)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param((d,), device)
        self.bias = _param((d,), device)

    def reset_parameters(self, gen=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        return layer_norm(x, self.scale, self.bias)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed(table, tokens: Tensor) -> Tensor:
    """Rows of ``table`` for int tokens (widened to int64), in bf16. In a
    sharded step's group, a table split over vocab (``Blocks`` of rows)
    looks each token up at the position holding its row, zeros elsewhere,
    and sums the positions' lookups (exact: one is not zero)."""
    if isinstance(table, Blocks):
        if table.dim != 0:
            raise ValueError("the embedding splits over the "
                             "tensor-parallel axis only along vocab")
        tp = table.group
        parts, lo = [], 0
        for t in table:
            rows = t.shape[0]
            local = tokens.to(t.device).long() - lo
            ok = (local >= 0) & (local < rows)
            parts.append(torch.where(ok[..., None],
                                     bf16(t[local.clamp(0, rows - 1)]), 0.0))
            lo += rows
        return tp.psum(parts)
    return bf16(table[tokens.long()])


def unembed(x: Tensor, w: Tensor) -> Tensor:
    """(..., d) @ (d, V): bf16 operands, fp32 product."""
    return dot_f32(x, w)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.embedding = _param((vocab, d), device)

    def reset_parameters(self, gen=None) -> None:
        normal_(self.embedding, 1.0 / math.sqrt(self.embedding.shape[1]),
                gen)

    def forward(self, tokens: Tensor) -> Tensor:
        return embed(self.embedding, tokens)


class Unembed(nn.Module):
    """The untied output head, (d, V)."""

    def __init__(self, d: int, vocab: int, device=None):
        super().__init__()
        self.lm_head = _param((d, vocab), device)

    def reset_parameters(self, gen=None) -> None:
        normal_(self.lm_head, 1.0 / math.sqrt(self.lm_head.shape[0]), gen)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor,
               theta: float = 10000.0) -> Tensor:
    """x: (b, s, h, dh); positions: (b, s) int. Rotates the split halves
    (not interleaved pairs) in fp32 and returns x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (b, s, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, device=None,
                         offset=0) -> Tensor:
    """(seq_len, d) fp32 at positions ``offset``, ``offset + 1``, ...
    (``offset`` an int or a 0-d tensor on ``device``)."""
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device)
           + offset)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((seq_len, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (torch's ``gelu``
    is the exact erf form unless asked), op by op in ``x``'s dtype as the
    reference computes it: in bf16 every step rounds (XLA converts each
    op's result back to bf16), and so does each torch op here. A fused
    fp32 gelu rounded once differs from it in about 40% of the elements."""
    inner = weak_scalar(x, math.sqrt(2.0 / math.pi)) * (
        x + weak_scalar(x, 0.044715) * (x * x * x))
    return x * (weak_scalar(x, 0.5) * (weak_scalar(x, 1.0) + torch.tanh(inner)))


def silu(x: Tensor) -> Tensor:
    """``jax.nn.silu``, ``x * 1 / (1 + exp(-x))`` op by op in ``x``'s dtype,
    as XLA expands the reference's ``logistic`` in bf16."""
    one = weak_scalar(x, 1.0)
    return x * (one / (one + torch.exp(-x)))


class MLP(nn.Module):
    """``swiglu`` / ``geglu`` (gated, ``w_gate``) or ``gelu``; bf16 products
    and the activation and gating in bf16, op by op."""

    def __init__(self, d: int, d_ff: int, kind: str = "swiglu",
                 device=None):
        super().__init__()
        if kind not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown mlp kind {kind}")
        self.kind = kind
        self.w_in = _param((d, d_ff), device)
        self.w_out = _param((d_ff, d), device)
        if kind in ("swiglu", "geglu"):
            self.w_gate = _param((d, d_ff), device)

    def reset_parameters(self, gen=None) -> None:
        d, d_ff = self.w_in.shape
        normal_(self.w_in, 1.0 / math.sqrt(d), gen)
        if self.kind != "gelu":
            normal_(self.w_gate, 1.0 / math.sqrt(d), gen)
        normal_(self.w_out, 1.0 / math.sqrt(d_ff), gen)

    def _hidden(self, xc: Tensor, w_in: Tensor, w_gate) -> Tensor:
        h = xc @ bf16(w_in)
        if self.kind == "gelu":
            return gelu(h)
        g = xc @ bf16(w_gate)
        return (silu(g) if self.kind == "swiglu" else gelu(g)) * h

    def forward(self, x: Tensor) -> Tensor:
        """In a sharded step's group with ``ff`` split (``Blocks``), each
        position computes its columns of the hidden layer and its partial
        output product in fp32; the partials' all-reduce rounds to bf16
        once, as the whole product does."""
        xc = bf16(x)
        if isinstance(self.w_in, Blocks):
            if (self.w_in.dim, self.w_out.dim) != (1, 0):
                raise ValueError("the MLP splits over the tensor-parallel "
                                 "axis only along ff")
            tp = self.w_in.group
            gates = self.w_gate if self.kind != "gelu" else [None] * tp.n
            return bf16(tp.psum([dot_f32(self._hidden(xm, wi, wg), wo)
                                 for xm, wi, wg, wo in zip(
                                     tp.broadcast(xc), self.w_in, gates,
                                     self.w_out)]))
        gate = self.w_gate if self.kind != "gelu" else None
        return self._hidden(xc, self.w_in, gate) @ bf16(self.w_out)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x.float() / cap)
