"""Recurrent mixers: RG-LRU (Griffin / RecurrentGemma) and xLSTM (mLSTM,
sLSTM). Mirrors ``repro.models.recurrent``.

* ``causal_conv1d``: Griffin's depthwise width-4 conv with its state, op
  by op in bf16 (each product and each add rounds, as the reference's sum
  of bf16 terms does).
* RG-LRU is a diagonal linear recurrence. ``rglru_scan`` runs the
  reference's ``jax.lax.associative_scan`` recursion (pairs combined, the
  half-length scan, the even positions filled in, interleaved), so the
  products are grouped in the reference's tree order and a prefill of s
  tokens costs O(log s) rounds of elementwise launches, not s.
* mLSTM runs the reference's chunkwise-parallel form (intra-chunk
  quadratic, inter-chunk state), chunks of ``lstm_chunk`` with an
  identity pad (f = 1, i = 0); the model calls it in every mode, decode
  included (chunk 1). ``mlstm_decode`` is the one-step recurrence.
* sLSTM has a true hidden-to-hidden recurrence: a sequential loop over
  positions with fp32 stabilised exponential gating.

fp32 products (the gates, the sLSTM input projection) run with TF32 off
(the package sets it at import). ``softplus`` is the reference's
``logaddexp(x, 0)``, not torch's, which returns x past a threshold.
Plain PyTorch: the reference computes these in ``jnp`` outside any Pallas
kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.distributed.sharding import Blocks
from repro_torch.models.layers import (_param, bf16, dot_f32, gelu, normal_,
                                       weak_scalar)

# ---------------------------------------------------------------------------
# Elementwise helpers in the reference's formulas
# ---------------------------------------------------------------------------


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def sigmoid(x: Tensor) -> Tensor:
    """``jax.nn.sigmoid`` as XLA expands it: ``1 / (1 + exp(-x))``."""
    return 1.0 / (1.0 + torch.exp(-x))


# ---------------------------------------------------------------------------
# Temporal (depthwise causal) conv
# ---------------------------------------------------------------------------

def causal_conv1d(x: Tensor, w: Tensor, state: Optional[Tensor] = None):
    """x: (b, s, c); w: (width, c) depthwise, x's dtype; state: (b,
    width - 1, c) history. Returns (y, new_state)."""
    width, s = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xp[:, i:i + s] * w[i]
    return y, xp[:, xp.shape[1] - (width - 1):]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

RGLRU_C = 8.0


class RGLRU(nn.Module):
    """``w_rnn_in`` / ``w_rnn_gate`` (d, d_rnn), ``conv_w`` (width,
    d_rnn), ``w_gate_a`` / ``w_gate_x`` (d_rnn, d_rnn), ``lam`` (d_rnn,),
    ``w_rnn_out`` (d_rnn, d)."""

    def __init__(self, d: int, d_rnn: int, conv_width: int = 4,
                 device=None):
        super().__init__()
        self.w_rnn_in = _param((d, d_rnn), device)
        self.w_rnn_gate = _param((d, d_rnn), device)
        self.conv_w = _param((conv_width, d_rnn), device)
        self.w_gate_a = _param((d_rnn, d_rnn), device)
        self.w_gate_x = _param((d_rnn, d_rnn), device)
        self.lam = _param((d_rnn,), device)
        self.w_rnn_out = _param((d_rnn, d), device)

    def reset_parameters(self, gen=None) -> None:
        d, d_rnn = self.w_rnn_in.shape
        normal_(self.w_rnn_in, 1.0 / math.sqrt(d), gen)
        normal_(self.w_rnn_gate, 1.0 / math.sqrt(d), gen)
        for w in (self.conv_w, self.w_gate_a, self.w_gate_x,
                  self.w_rnn_out):
            normal_(w, 1.0 / math.sqrt(d_rnn), gen)
        if self.lam.device.type != "meta":
            # a = sigmoid(lam)^(c r) starts in [0.9, 0.999]
            with torch.no_grad():
                u = torch.empty_like(self.lam).uniform_(0.9, 0.999,
                                                        generator=gen)
                v = u ** (1.0 / RGLRU_C)
                self.lam.copy_(torch.log(v / (1 - v)))


def _rglru_gates(p: RGLRU, u: Tensor):
    return _gates(u, u, p.w_gate_a, p.w_gate_x, p.lam)


def _gates(u_full: Tensor, u: Tensor, w_gate_a: Tensor, w_gate_x: Tensor,
           lam: Tensor):
    """The gates' columns of ``w_gate_*`` and ``lam`` over the whole
    ``u_full``; ``u`` is its matching columns (the same tensor unsplit)."""
    r = sigmoid(u_full.float() @ w_gate_a.float())
    i = sigmoid(u_full.float() @ w_gate_x.float())
    uf = u.float()
    # log sigmoid(lam)^(c r)
    log_a = -RGLRU_C * r * softplus(lam.float())
    a = torch.exp(log_a)
    # sqrt(1 - a^2) input normalisation (Griffin eq. 4)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i * uf


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _assoc_scan(a: Tensor, b: Tensor):
    """``lax.associative_scan(combine, (a, b), axis=1)`` in its recursion
    order."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _assoc_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    out_a = torch.empty_like(a)
    out_b = torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = ea, oa
    out_b[:, 0::2], out_b[:, 1::2] = eb, ob
    return out_a, out_b


def rglru_scan(a: Tensor, bx: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """h_t = a_t * h_{t-1} + bx_t over axis 1; ``h0`` folds into the first
    step."""
    if h0 is not None:
        bx = bx.clone()
        bx[:, 0] = bx[:, 0] + a[:, 0] * h0
    return _assoc_scan(a, bx)[1]


def rglru_block(p: RGLRU, x: Tensor, cache: Optional[dict] = None):
    """Griffin's recurrent block. x: (b, s, d) -> ((b, s, d) bf16, the new
    cache, or None without one). cache: {"h": (b, d_rnn) fp32, "conv":
    (b, width - 1, d_rnn) bf16}."""
    xc = bf16(x)
    if isinstance(p.w_rnn_in, Blocks):
        return _rglru_split(p, xc, cache)
    gate = gelu(xc @ bf16(p.w_rnn_gate))
    u = xc @ bf16(p.w_rnn_in)
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = causal_conv1d(u, p.conv_w.to(u.dtype), conv_state)
    a, bx = _rglru_gates(p, u)
    h = rglru_scan(a, bx, cache["h"] if cache is not None else None)
    y = bf16(gate.float() * h)
    out = y @ bf16(p.w_rnn_out)
    new_cache = None
    if cache is not None:
        new_cache = {"h": h[:, -1], "conv": new_conv}
    return out, new_cache


def _rglru_split(p: RGLRU, xc: Tensor, cache: Optional[dict] = None):
    """The block with ``rnn`` split over a sharded step's group: each
    position runs its channels (input projections, conv, gates' output
    columns over the all-gathered input, the recurrence) and its fp32
    partial of the output product; their all-reduce rounds once. A cache
    (serving) holds each position's channels: ``h`` and ``conv`` as
    ``Blocks`` along rnn. Returns (out, the new cache or None)."""
    tp = p.w_rnn_in.group
    if any(not isinstance(w, Blocks) or w.dim != dim for w, dim in (
            (p.w_rnn_gate, 1), (p.conv_w, 1), (p.w_gate_a, 1),
            (p.w_gate_x, 1), (p.w_rnn_out, 0))):
        raise ValueError("the RG-LRU splits over the tensor-parallel axis "
                         "only along rnn")
    lam = p.lam if isinstance(p.lam, Blocks) else tp.split(p.lam, 0)
    xs = tp.broadcast(xc)
    states = [None] * tp.n if cache is None else cache["conv"]
    convs = [causal_conv1d(xm @ bf16(w), c.to(xc.dtype), st)
             for xm, w, c, st in zip(xs, p.w_rnn_in, p.conv_w, states)]
    us = [u for u, _ in convs]
    parts, hs = [], []
    for m, u_full in enumerate(tp.all_gather(us, 2)):
        a, bx = _gates(u_full, us[m], p.w_gate_a[m], p.w_gate_x[m], lam[m])
        gate = gelu(xs[m] @ bf16(p.w_rnn_gate[m]))
        h = rglru_scan(a, bx, None if cache is None else cache["h"][m])
        hs.append(h[:, -1])
        y = bf16(gate.float() * h)
        parts.append(dot_f32(y, p.w_rnn_out[m]))
    new = None if cache is None else {
        "h": Blocks(hs, 1, tp), "conv": Blocks([c for _, c in convs], 2, tp)}
    return bf16(tp.psum(parts)), new


def init_rglru_cache(batch: int, d_rnn: int, conv_width: int = 4,
                     device=None) -> dict:
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, d_rnn),
                                dtype=torch.bfloat16, device=device)}


def rglru_decode(p: RGLRU, x: Tensor, cache: dict):
    """Single-token step. x: (b, 1, d)."""
    return rglru_block(p, x, cache)


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, chunkwise-parallel)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``wqkv_lstm`` (d, 3, H, dh), ``w_gates`` (d, 2, H), ``w_lstm_out``
    (H, dh, d)."""

    def __init__(self, d: int, n_heads: int, head_dim: int, device=None):
        super().__init__()
        self.wqkv_lstm = _param((d, 3, n_heads, head_dim), device)
        self.w_gates = _param((d, 2, n_heads), device)
        self.w_lstm_out = _param((n_heads, head_dim, d), device)

    def reset_parameters(self, gen=None) -> None:
        d, _, h, dh = self.wqkv_lstm.shape
        normal_(self.wqkv_lstm, 1.0 / math.sqrt(d), gen)
        normal_(self.w_gates, 1.0 / math.sqrt(d), gen)
        normal_(self.w_lstm_out, 1.0 / math.sqrt(h * dh), gen)


def init_mlstm_cache(batch: int, n_heads: int, head_dim: int,
                     device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, head_dim, head_dim), **f32),
            "n": torch.zeros((batch, n_heads, head_dim), **f32),
            "m": torch.full((batch, n_heads), -1e30, **f32)}


def _mlstm_qkv_gates(p: MLSTM, x: Tensor):
    xc = bf16(x)
    d, _, H, dh = p.wqkv_lstm.shape
    qkv = (xc @ bf16(p.wqkv_lstm).reshape(d, 3 * H * dh)).unflatten(
        -1, (3, H, dh))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]     # (b, s, H, dh)
    # the gates take the bf16-rounded input widened back to fp32
    gates = (xc.float() @ p.w_gates.float().reshape(d, 2 * H)).unflatten(
        -1, (2, H))
    i_raw, f_raw = gates[:, :, 0], gates[:, :, 1]         # (b, s, H)
    log_f = -softplus(-f_raw)                             # log sigmoid
    q = q / weak_scalar(q, math.sqrt(dh))
    return q, k, v, i_raw, log_f


def _mlstm_chunk(C, n, m, qi, ki, vi, li, lf):
    """One chunk: state (C, n, m), q/k/v (b, H, L, dh) fp32, gates (b, H,
    L). Returns (h (b, H, L, dh), C, n, m)."""
    L = qi.shape[-2]
    bsum = torch.cumsum(lf, dim=-1)                       # inclusive
    # per-position stabiliser
    g = li - bsum
    gmax = torch.cummax(g, dim=-1).values
    m_t = torch.maximum(m[..., None] + bsum, bsum + gmax)
    # intra-chunk decay D[t, s] = exp(bsum_t - bsum_s + li_s - m_t)
    dlog = bsum[..., :, None] - bsum[..., None, :] + li[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=qi.device))
    dlog = torch.where(mask, dlog - m_t[..., :, None], -1e30)
    scores = torch.einsum("bhld,bhmd->bhlm", qi, ki) * torch.exp(dlog)
    num_intra = torch.einsum("bhlm,bhmd->bhld", scores, vi)
    den_intra = torch.sum(scores, dim=-1)
    # inter-chunk: scale exp(m_prev + bsum_t - m_t)
    w_inter = torch.exp(m[..., None] + bsum - m_t)
    num_inter = torch.einsum("bhld,bhdk->bhlk", qi, C) * w_inter[..., None]
    den_inter = torch.einsum("bhld,bhd->bhl", qi, n) * w_inter
    num = num_intra + num_inter
    den = den_intra + den_inter
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    # the state at the chunk's end
    m_l = m_t[..., -1]
    wk = torch.exp(bsum[..., -1:] - bsum + li - m_l[..., None])
    decay = torch.exp(m + bsum[..., -1] - m_l)
    C = decay[..., None, None] * C + torch.einsum("bhl,bhld,bhlk->bhdk", wk,
                                                  ki, vi)
    n = decay[..., None] * n + torch.einsum("bhl,bhld->bhd", wk, ki)
    return h, C, n, m_l


def mlstm_chunkwise(p: MLSTM, x: Tensor, cache: Optional[dict] = None,
                    chunk: int = 128):
    """Chunkwise-parallel mLSTM. x: (b, s, d). Returns ((b, s, d) bf16,
    the new cache)."""
    b, s, _ = x.shape
    q, k, v, log_i, log_f = _mlstm_qkv_gates(p, x)
    H, dh = q.shape[2], q.shape[3]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:  # identity pad: f = 1, i = 0, so the state does not move
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
        log_f = F.pad(log_f, (0, 0, 0, pad))
    if cache is None:
        cache = init_mlstm_cache(b, H, dh, x.device)
    C, n, m = cache["C"], cache["n"], cache["m"]
    # (b, S, H, ...) -> (b, H, S, ...), fp32
    q32, k32, v32 = (t.float().transpose(1, 2) for t in (q, k, v))
    li, lf = log_i.transpose(1, 2), log_f.transpose(1, 2)
    hs = []
    for lo in range(0, s + pad, chunk):
        hi = lo + chunk
        h, C, n, m = _mlstm_chunk(C, n, m, q32[:, :, lo:hi], k32[:, :, lo:hi],
                                  v32[:, :, lo:hi], li[:, :, lo:hi],
                                  lf[:, :, lo:hi])
        hs.append(h)
    h = torch.cat(hs, dim=2).transpose(1, 2)[:, :s]       # (b, s, H, dh)
    out = bf16(h).flatten(-2) @ bf16(p.w_lstm_out).reshape(H * dh, -1)
    return out, {"C": C, "n": n, "m": m}


def mlstm_decode(p: MLSTM, x: Tensor, cache: dict):
    """Single-step recurrent mLSTM. x: (b, 1, d). The model's decode runs
    ``mlstm_chunkwise`` with chunk 1, as the reference's does."""
    q, k, v, log_i, log_f = _mlstm_qkv_gates(p, x)
    q1, k1, v1 = (t[:, 0].float() for t in (q, k, v))     # (b, H, dh)
    li, lf = log_i[:, 0], log_f[:, 0]                     # (b, H)
    C, n, m = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(lf + m, li)
    wf = torch.exp(lf + m - m_new)[..., None]
    wi = torch.exp(li - m_new)[..., None]
    C_new = wf[..., None] * C + torch.einsum("bhd,bhk->bhdk", wi * k1, v1)
    n_new = wf * n + wi * k1
    num = torch.einsum("bhd,bhdk->bhk", q1, C_new)
    den = torch.einsum("bhd,bhd->bh", q1, n_new)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    H, dh = h.shape[1], h.shape[2]
    out = bf16(h).flatten(-2) @ bf16(p.w_lstm_out).reshape(H * dh, -1)
    return out[:, None, :], {"C": C_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, true recurrence)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``w_slstm_in`` (d, 4, H, dh) for z, i, f, o; ``r_slstm`` (4, H, dh,
    dh) block-diagonal recurrent weights; ``w_lstm_out`` (H, dh, d)."""

    def __init__(self, d: int, n_heads: int, head_dim: int, device=None):
        super().__init__()
        self.w_slstm_in = _param((d, 4, n_heads, head_dim), device)
        self.r_slstm = _param((4, n_heads, head_dim, head_dim), device)
        self.w_lstm_out = _param((n_heads, head_dim, d), device)

    def reset_parameters(self, gen=None) -> None:
        d, _, h, dh = self.w_slstm_in.shape
        normal_(self.w_slstm_in, 1.0 / math.sqrt(d), gen)
        normal_(self.r_slstm, 1.0 / math.sqrt(dh), gen)
        normal_(self.w_lstm_out, 1.0 / math.sqrt(h * dh), gen)


def init_slstm_cache(batch: int, n_heads: int, head_dim: int,
                     device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.zeros((batch, n_heads, head_dim), **f32)
    return {"c": z, "n": z, "h": z,
            "m": torch.full((batch, n_heads, head_dim), -1e30, **f32)}


def slstm_block(p: SLSTM, x: Tensor, cache: Optional[dict] = None):
    """Sequential sLSTM. x: (b, s, d) -> ((b, s, d) bf16, the new cache)."""
    b, s, d = x.shape
    _, _, H, dh = p.w_slstm_in.shape
    proj = (x.float() @ p.w_slstm_in.float().reshape(d, 4 * H * dh)).unflatten(
        -1, (4, H, dh))                                   # (b, s, 4, H, dh)
    if cache is None:
        cache = init_slstm_cache(b, H, dh, x.device)
    c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    R = p.r_slstm.float()
    hs = []
    for t in range(s):
        rec = torch.einsum("bhk,ghkj->bghj", h, R)        # (b, 4, H, dh)
        pre = proj[:, t] + rec
        z = torch.tanh(pre[:, 0])
        o = sigmoid(pre[:, 3])
        log_f = -softplus(-pre[:, 2])
        ir = pre[:, 1]
        m_new = torch.maximum(log_f + m, ir)
        i = torch.exp(ir - m_new)
        f = torch.exp(log_f + m - m_new)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    out = bf16(torch.stack(hs, dim=1)).flatten(-2) \
        @ bf16(p.w_lstm_out).reshape(H * dh, d)
    return out, {"c": c, "n": n, "h": h, "m": m}


def slstm_decode(p: SLSTM, x: Tensor, cache: dict):
    return slstm_block(p, x, cache)
