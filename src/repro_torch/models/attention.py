"""Attention: GQA + RoPE + sliding window + softcap + KV caches, flash-style.
Mirrors ``repro.models.attention`` for the ``attn`` and ``local`` blocks.

No (S x S) score matrix is held: prefill and the full forward run the
reference's two-level chunked online softmax (query chunks outside, KV
chunks inside), and sliding-window layers slice only the (window +
q_chunk) span of KV each query chunk can see. The chunking is kept as the
reference has it: ``p = exp(s - m_new)`` is rounded to bf16 against each
chunk's running max before the PV product, which a one-shot softmax (or
``scaled_dot_product_attention``) would round differently.

Decode attends one position over the whole cache with a single softmax,
and its PV product has a bf16 result, as the reference's.

The encoder-decoder's cross attention (``cross_kv``, ``cross_attend``)
runs the same chunked core, non-causal, over the encoder's keys and
values.

Sequence-parallel core: where the current ``AxisRules`` set
``attn_core_seq_shard`` (the archs whose head count does not divide the
model axis), ``sq`` > 1 splits over that axis and ``banded_causal`` is
off, the queries split over the axis's positions, each slice runs at its
position with ``q_offset + index * s_loc`` and ``q_chunk = min(q_chunk,
s_loc)``, K and V stay whole, and the outputs join in sequence order: the
reference's ``shard_map`` branch, on the mesh's positions.

In a sharded train step's group (``models.model.ShardGroup``) the
projections split over the tensor-parallel axis in one of two layouts,
as the rules place them: Megatron's ``heads`` (wq and wo by heads, K and V
replicated) or ``head_dim`` (every projection by head_dim; an all-to-all
takes the queries to sequence slices for the core above, an all-gather
makes K and V whole, and the outputs go back by all-to-all). Each
position's output projection is an fp32 partial; their all-reduce rounds
to bf16 once.

Plain PyTorch: the reference computes attention in ``jnp`` outside any
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.distributed.sharding import (Blocks, current_rules,
                                              mesh_group)
from repro_torch.models.layers import (COMPUTE_DTYPE, _param, apply_rope,
                                       bf16, dot_f32, normal_, softcap)

NEG = -1e30  # mask value (no nan from -inf - -inf)


class Attention(nn.Module):
    """Projections: wq (d, H, dh), wk / wv (d, KV, dh), wo (H, dh, d). GQA
    groups the query heads as (KV, g): head h = kv * g + j."""

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int,
                 device=None):
        super().__init__()
        self.wq = _param((d, n_heads, head_dim), device)
        self.wk = _param((d, n_kv, head_dim), device)
        self.wv = _param((d, n_kv, head_dim), device)
        self.wo = _param((n_heads, head_dim, d), device)

    def reset_parameters(self, gen=None) -> None:
        d, h, dh = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            normal_(w, 1.0 / math.sqrt(d), gen)
        normal_(self.wo, 1.0 / math.sqrt(h * dh), gen)


def _proj(xc: Tensor, w: Tensor) -> Tensor:
    """einsum("bsd,dhk->bshk") in bf16."""
    d, h, k = w.shape
    return (xc @ bf16(w).reshape(d, h * k)).unflatten(-1, (h, k))


def _qkv(p: Attention, x: Tensor):
    xc = bf16(x)
    return _proj(xc, p.wq), _proj(xc, p.wk), _proj(xc, p.wv)


def _out(p: Attention, o: Tensor) -> Tensor:
    """einsum("bshk,hkd->bsd") in bf16."""
    h, k, d = p.wo.shape
    return bf16(o).flatten(-2) @ bf16(p.wo).reshape(h * k, d)


# ---------------------------------------------------------------------------
# Chunked online-softmax core
# ---------------------------------------------------------------------------

def _chunk_scores(q, ks, scale, cap):
    """q: (b, qc, KV, g, dh); ks: (b, kc, KV, dh) -> (b, KV, g, qc, kc)
    fp32."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", bf16(q).float(), bf16(ks).float())
    return softcap(s * scale, cap)


def _online_block(q, k, v, q_pos, kv_pos, *, scale, cap, causal, window,
                  kv_chunk):
    """Attend a q chunk over the whole given k/v, one KV chunk at a time.

    q: (b, qc, KV, g, dh); k, v: (b, skv, KV, dh); q_pos: (qc,) absolute;
    kv_pos: (skv,) absolute (-1 = invalid slot). Returns (b, qc, KV, g, dh)
    fp32."""
    b, qc, KV, g, dh = q.shape
    m = torch.full((b, KV, g, qc), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, KV, g, qc), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, KV, g, qc, dh), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, k.shape[1], kv_chunk):
        ks, vs = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
        kp = kv_pos[lo:lo + kv_chunk]
        s = _chunk_scores(q, ks, scale, cap)             # (b, KV, g, qc, kc)
        ok = kp[None, :] >= 0
        if causal:
            ok = ok & (q_pos[:, None] >= kp[None, :])
        if window > 0:
            ok = ok & (q_pos[:, None] - kp[None, :] < window)
        s = torch.where(ok, s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        upd = torch.einsum("bhgqk,bkhd->bhgqd", bf16(p).float(),
                           bf16(vs).float())
        acc = acc * alpha[..., None] + upd
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)                    # (b, qc, KV, g, dh)


def seq_core_group(sq: int, banded_causal: bool = False, tp=None):
    """The positions the core's queries split over, or None: the current
    rules' ``attn_core_seq_shard`` axis (``tp``, a sharded step's group,
    where it runs along that axis, else the rules' mesh along it), where
    ``sq`` > 1 splits evenly and ``banded_causal`` is off."""
    r = current_rules()
    ax = r.rules.get("attn_core_seq_shard") if r and r.mesh else None
    if ax is None or banded_causal:
        return None
    if tp is not None and tp.axis == ax:
        group = tp
    else:
        group = mesh_group(r.mesh, ax, {})
    return group if sq > 1 and sq % group.n == 0 else None


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset: int = 0, scale: Optional[float] = None,
                      cap: Optional[float] = None, q_chunk: int = 512,
                      kv_chunk: int = 512, banded_causal: bool = False,
                      _no_seq_shard: bool = False) -> Tensor:
    """q: (b, sq, H, dh); k, v: (b, skv, KV, dh). Returns (b, sq, H, dh)
    bf16.

    ``window`` > 0 (with ``causal``) restricts attention to the last
    ``window`` positions and takes the banded path: each query chunk sees
    a span of ``ceil((window + q_chunk) / kv_chunk) * kv_chunk`` KV
    positions with a clipped start. ``banded_causal`` truncates each query
    chunk's KV at its causal limit. Under rules with
    ``attn_core_seq_shard`` the core runs sequence-parallel
    (``seq_core_group``; ``_no_seq_shard``: one position's slice, as the
    reference's ``shard_map`` body calls it)."""
    b, sq, H, dh = q.shape
    group = None if _no_seq_shard else seq_core_group(sq, banded_causal)
    if group is not None:
        s_loc = sq // group.n
        outs = [chunked_attention(
            qm, km, vm, causal=causal, window=window,
            q_offset=q_offset + m * s_loc, scale=scale, cap=cap,
            q_chunk=min(q_chunk, s_loc), kv_chunk=kv_chunk,
            _no_seq_shard=True)
            for m, (qm, km, vm) in enumerate(zip(
                group.split(q, 1), group.broadcast(k), group.broadcast(v)))]
        return group.gathered(outs, 1)
    KV = k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    q = q.reshape(b, sq, KV, g, dh)

    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, k.shape[1])
    # pad q/kv to chunk multiples (padded KV slots carry kv_pos = -1)
    sq_orig, skv_orig = sq, k.shape[1]
    q_pad = (-sq) % q_chunk
    kv_pad = (-skv_orig) % kv_chunk
    if q_pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, q_pad))
        sq += q_pad
    kv_pos = torch.arange(skv_orig, dtype=torch.int32, device=q.device)
    if kv_pad:
        k = F.pad(k, (0, 0, 0, 0, 0, kv_pad))
        v = F.pad(v, (0, 0, 0, 0, 0, kv_pad))
        kv_pos = torch.cat([kv_pos, torch.full((kv_pad,), -1,
                                               dtype=torch.int32,
                                               device=q.device)])
    skv = k.shape[1]
    kw = dict(scale=scale, cap=cap, kv_chunk=kv_chunk)
    outs = []
    for i in range(sq // q_chunk):
        qs = q[:, i * q_chunk:(i + 1) * q_chunk]
        q0 = q_offset + i * q_chunk
        q_pos = q0 + torch.arange(q_chunk, dtype=torch.int32,
                                  device=q.device)
        if window > 0 and causal:
            # banded: each q chunk sees a fixed (window + q_chunk) KV span
            span = min(math.ceil((window + q_chunk) / kv_chunk) * kv_chunk,
                       skv)
            start = min(max(q0 + q_chunk - span, 0), skv - span)
            kp = start + torch.arange(span, dtype=torch.int32,
                                      device=q.device)
            o = _online_block(qs, k[:, start:start + span],
                              v[:, start:start + span], q_pos, kp,
                              causal=True, window=window, **kw)
        elif causal and banded_causal:
            # FLOP-exact causal: q chunk i scans only the chunks it can see
            hi_chunk = min((q0 + q_chunk + kv_chunk - 1) // kv_chunk,
                           skv // kv_chunk)
            hi = max(hi_chunk * kv_chunk, kv_chunk)
            o = _online_block(qs, k[:, :hi], v[:, :hi], q_pos, kv_pos[:hi],
                              causal=True, window=0, **kw)
        else:
            o = _online_block(qs, k, v, q_pos, kv_pos, causal=causal,
                              window=window, **kw)
        outs.append(o)
    out = torch.cat(outs, dim=1).reshape(b, sq, H, dh)
    return bf16(out[:, :sq_orig])


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def cache_size(max_len: int, window: int = 0) -> int:
    """Slots of a cache: a local (window > 0) cache is a rolling buffer of
    ``max(128, roundup(min(max_len, window), 128))`` slots; a global one is
    ``max_len`` rounded up to 128 (at least 128), clipped to ``max_len``."""
    size = min(max_len, window) if window > 0 else max_len
    size = max(128, ((size + 127) // 128) * 128)
    return min(size, max_len) if window == 0 else size


def init_kv_cache(batch: int, n_kv: int, head_dim: int, max_len: int,
                  window: int = 0, dtype=COMPUTE_DTYPE, device=None) -> dict:
    size = cache_size(max_len, window)
    return {
        "k": torch.zeros((batch, size, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, size, n_kv, head_dim), dtype=dtype,
                         device=device),
        # absolute position held by each slot (-1: empty)
        "slot_pos": torch.full((size,), -1, dtype=torch.int32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),  # next
    }


def cache_update_prefill(cache: dict, k: Tensor, v: Tensor) -> dict:
    """A new cache holding a prefill of length s at positions [0, s)."""
    s = k.shape[1]
    size = cache["k"].shape[1]
    dev = k.device
    if s >= size:  # keep the last `size` positions (the rolling case)
        pos = torch.arange(s - size, s, dtype=torch.int32, device=dev)
        # slot = pos % size, so decode writes continue seamlessly
        order = torch.argsort(pos % size)
        return {"k": k[:, s - size:][:, order], "v": v[:, s - size:][:, order],
                "slot_pos": pos[order],
                "pos": torch.tensor(s, dtype=torch.int32, device=dev)}
    nk, nv, sp = (cache[n].clone() for n in ("k", "v", "slot_pos"))
    nk[:, :s] = k.to(nk.dtype)
    nv[:, :s] = v.to(nv.dtype)
    sp[:s] = torch.arange(s, dtype=torch.int32, device=dev)
    return {"k": nk, "v": nv, "slot_pos": sp,
            "pos": torch.tensor(s, dtype=torch.int32, device=dev)}


def cache_update_decode(cache: dict, k1: Tensor, v1: Tensor) -> dict:
    """A new cache with one more position (k1, v1: (b, 1, KV, dh)) at slot
    ``pos % size``. The slot stays on the device: no host sync."""
    size = cache["k"].shape[1]
    pos = cache["pos"]
    slot = torch.remainder(pos, size).long().reshape(1)
    return {
        "k": cache["k"].index_copy(1, slot, k1.to(cache["k"].dtype)),
        "v": cache["v"].index_copy(1, slot, v1.to(cache["v"].dtype)),
        "slot_pos": cache["slot_pos"].index_copy(0, slot, pos.reshape(1)),
        "pos": pos + 1,
    }


def decode_attend(q: Tensor, cache: dict, *, window: int = 0, scale=None,
                  cap=None) -> Tensor:
    """Single-step attention over the cache. q: (b, 1, H, dh); one softmax
    over every slot, the PV product in bf16."""
    b, sq, H, dh = q.shape
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    KV = k.shape[2]
    g = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    pos = cache["pos"] - 1  # position of the query token
    qh = q.reshape(b, sq, KV, g, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", bf16(qh).float(), bf16(k).float())
    s = softcap(s * scale, cap)
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        ok = ok & (pos - slot_pos < window)
    s = torch.where(ok, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", bf16(p), bf16(v))
    return o.reshape(b, sq, H, dh)


# ---------------------------------------------------------------------------
# Attention blocks (full forward / prefill / decode)
# ---------------------------------------------------------------------------

def _positions(x: Tensor) -> Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32,
                        device=x.device).expand(x.shape[:2])


def attn_forward(p: Attention, x, *, causal: bool, window: int = 0,
                 positions=None, rope_theta: float = 10000.0,
                 use_rope: bool = True, cap=None, q_chunk=512, kv_chunk=512,
                 banded_causal: bool = False):
    """The full-sequence forward, no cache. x: (b, s, d)."""
    if any(_split_dims(p)):
        if use_rope:
            positions = _positions(x) if positions is None else positions
        return _split_attend(p, x, None, rope=(positions, rope_theta)
                             if use_rope else None, causal=causal,
                             window=window, cap=cap, q_chunk=q_chunk,
                             kv_chunk=kv_chunk, banded_causal=banded_causal)
    q, k, v = _qkv(p, x)
    if use_rope:
        positions = _positions(x) if positions is None else positions
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = chunked_attention(q, k, v, causal=causal, window=window, cap=cap,
                          q_chunk=q_chunk, kv_chunk=kv_chunk,
                          banded_causal=banded_causal)
    return _out(p, o)


def attn_prefill(p: Attention, x, cache, *, window: int = 0,
                 rope_theta: float = 10000.0, use_rope: bool = True,
                 cap=None, q_chunk=512, kv_chunk=512):
    """The prompt's attention and its cache. In a sharded step's group
    (``p`` a view) the projections run split as ``_split_attend`` runs
    them, and the cache's k and v come out split along the sequence over
    the group's ``kv_group`` (the rules' ``kv_seq`` axes): ``Blocks``."""
    kvg = getattr(p, "kv_group", None)
    if kvg is not None:
        return _group_prefill(p, x, cache, kvg, window=window,
                              rope_theta=rope_theta, use_rope=use_rope,
                              cap=cap, q_chunk=q_chunk, kv_chunk=kv_chunk)
    q, k, v = _qkv(p, x)
    if use_rope:
        positions = _positions(x)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = chunked_attention(q, k, v, causal=True, window=window, cap=cap,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    return _out(p, o), cache_update_prefill(cache, k, v)


def attn_decode(p: Attention, x, cache, *, window: int = 0,
                rope_theta: float = 10000.0, use_rope: bool = True,
                cap=None):
    """x: (b, 1, d), the one new token. A cache whose k and v are
    ``Blocks`` along the sequence (a sharded step's group) takes
    ``_group_decode``."""
    if isinstance(cache["k"], Blocks):
        return _group_decode(p, x, cache, window=window,
                             rope_theta=rope_theta, use_rope=use_rope,
                             cap=cap)
    q, k, v = _qkv(p, x)
    if use_rope:
        pos = cache["pos"].expand(x.shape[0], 1)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    cache = cache_update_decode(cache, k, v)
    return _out(p, decode_attend(q, cache, window=window, cap=cap)), cache


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_kv(p: Attention, enc_out: Tensor):
    """The encoder output's keys and values, (b, s_enc, KV, dh) bf16 each
    (in a sharded step's group, in its layout: ``Blocks`` of head_dim, or
    replicated)."""
    xc = bf16(enc_out)
    if any(_split_dims(p)) and _layout(p) == "head_dim":
        tp = p.wk.group
        xs = tp.broadcast(xc)
        return tuple(Blocks([_proj(xm, w) for xm, w in zip(xs, ws)], 3, tp)
                     for ws in (p.wk, p.wv))
    return _proj(xc, p.wk), _proj(xc, p.wv)


def cross_attend(p: Attention, x: Tensor, k, v, *, q_chunk=512,
                 kv_chunk=512, cap=None) -> Tensor:
    """x: (b, s, d) attends, non-causal and without RoPE, over the encoder's
    k, v (in a sharded step's group: ``Blocks`` of head_dim, or of the
    sequence, which ``_combine_attend`` reads)."""
    if isinstance(k, Blocks) and k.dim == 1:
        tp = p.wq.group if isinstance(p.wq, Blocks) else None
        return _split_out(p, _combine_attend(
            _whole_queries(p, x), k, v, lambda j, kj: None, cap=cap, tp=tp))
    if any(_split_dims(p)):
        return _split_attend(p, x, (k, v), rope=None, causal=False,
                             window=0, cap=cap, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    q = _proj(bf16(x), p.wq)
    o = chunked_attention(q, k, v, causal=False, cap=cap, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)
    return _out(p, o)


# ---------------------------------------------------------------------------
# Attention with its projections split over a sharded step's group
# ---------------------------------------------------------------------------

def _split_dims(p) -> tuple:
    """The dim each of wq, wk, wv, wo splits along over a sharded step's
    group (None: whole)."""
    return tuple(w.dim if isinstance(w, Blocks) else None
                 for w in (p.wq, p.wk, p.wv, p.wo))


def _layout(p) -> str:
    """``"heads"`` (wq by heads, wo by heads, wk/wv replicated) or
    ``"head_dim"`` (wq, wk, wv and wo by head_dim); other splits raise."""
    layouts = {(1, None, None, 0): "heads", (2, 2, 2, 1): "head_dim"}
    dims = _split_dims(p)
    if dims not in layouts:
        raise ValueError(f"attention splits over the tensor-parallel axis "
                         f"by heads (wk, wv replicated) or by head_dim, not "
                         f"along {dims}")
    return layouts[dims]


def _rope(t: Tensor, rope, lo: int = 0) -> Tensor:
    """RoPE on ``t`` (b, s, h, dh) at ``rope``'s positions ``lo`` on."""
    if rope is None:
        return t
    positions, theta = rope
    positions = positions.to(t.device)[:, lo:lo + t.shape[1]]
    return apply_rope(t, positions, theta)


def _kv_heads(m: int, n_q: int, g: int) -> slice:
    """The KV heads the query heads [m n_q, (m + 1) n_q) read (head h reads
    h // g)."""
    if n_q % g and g % n_q:
        raise ValueError(f"{n_q} query heads a position do not align with "
                         f"GQA groups of {g}")
    lo = m * n_q // g
    return slice(lo, lo + max(n_q // g, 1))


def _split_attend(p, x: Tensor, kv, *, rope, causal: bool, window: int,
                  cap, q_chunk: int, kv_chunk: int,
                  banded_causal: bool = False, want_kv: bool = False):
    """Attention of x (b, s, d) over its own keys and values (``kv`` None)
    or over ``kv`` (cross attention, ``cross_kv``'s), with the
    projections split over the group's tensor-parallel axis. Returns
    (b, s, d) bf16; with ``want_kv``, also the whole keys (after RoPE) and
    values, (b, s, KV, dh) each, as the group holds them."""
    layout = _layout(p)
    tp = p.wq.group
    core = dict(causal=causal, window=window, cap=cap, kv_chunk=kv_chunk,
                banded_causal=banded_causal, _no_seq_shard=True)
    xs = tp.broadcast(bf16(x))
    q = [_proj(xm, w) for xm, w in zip(xs, p.wq)]
    if kv is None:
        if layout == "heads":
            xc = bf16(x)
            k, v = _proj(xc, p.wk), _proj(xc, p.wv)
        else:
            k, v = ([_proj(xm, w) for xm, w in zip(xs, ws)]
                    for ws in (p.wk, p.wv))
    else:
        k, v = kv
    if layout == "heads":
        k = _rope(k, rope)
        whole = (k, v)
        g = p.wq[0].shape[1] * tp.n // k.shape[2]
        o = []
        for m, (qm, km, vm) in enumerate(zip(q, tp.broadcast(k),
                                             tp.broadcast(v))):
            sel = _kv_heads(m, qm.shape[2], g)
            o.append(chunked_attention(_rope(qm, rope), km[:, :, sel],
                                       vm[:, :, sel], q_chunk=q_chunk,
                                       **core))
    else:
        s = x.shape[1]
        group = seq_core_group(s, banded_causal, tp)
        if group is tp:
            s_loc = s // tp.n
            qs = tp.all_to_all(q, 1, 3)
            ks, vs = tp.all_gather(k, 3), tp.all_gather(v, 3)
            ks = [_rope(km, rope) for km in ks]
            whole = (ks[0], vs[0])
            outs = [chunked_attention(
                _rope(qm, rope, m * s_loc), km, vm,
                q_offset=m * s_loc, q_chunk=min(q_chunk, s_loc), **core)
                for m, (qm, km, vm) in enumerate(zip(qs, ks, vs))]
            o = tp.all_to_all(outs, 3, 1)
        else:
            qf, kf, vf = (tp.gathered(t, 3) for t in (q, k, v))
            kf = _rope(kf, rope)
            whole = (kf, vf)
            o = tp.split(chunked_attention(
                _rope(qf, rope), kf, vf, q_chunk=q_chunk, **core), 3)
    out = _split_out(p, o)
    return (out, whole) if want_kv else out


def _split_out(p, o) -> Tensor:
    """The output projection of attention outputs ``o`` split as wo is
    (each position's heads or head_dim columns; whole ``o`` is cut),
    fp32 partials joined by an all-reduce that rounds once."""
    if not isinstance(p.wo, Blocks):
        return _out(p, o)
    tp = p.wo.group
    if isinstance(o, Tensor):
        o = tp.split(o, 2 if _layout(p) == "heads" else 3)
    d = p.wo[0].shape[-1]
    return bf16(tp.psum([dot_f32(om.flatten(-2), w.reshape(-1, d))
                         for om, w in zip(o, p.wo)]))


# ---------------------------------------------------------------------------
# Serving in a sharded step's group: caches split along the sequence
# ---------------------------------------------------------------------------

def _group_prefill(p, x, cache, kvg, *, window, rope_theta, use_rope, cap,
                   q_chunk, kv_chunk):
    """``attn_prefill`` in a group: the output as ``_split_attend``
    computes it (whole projections where none is split), the cache filled
    whole and then cut along the sequence over ``kvg`` (a replicated value
    each position keeps its block of)."""
    rope = (_positions(x), rope_theta) if use_rope else None
    if any(_split_dims(p)):
        out, (k, v) = _split_attend(p, x, None, rope=rope, causal=True,
                                    window=window, cap=cap, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk, want_kv=True)
    else:
        q, k, v = _qkv(p, x)
        q, k = _rope(q, rope), _rope(k, rope)
        out = _out(p, chunked_attention(q, k, v, causal=True, window=window,
                                        cap=cap, q_chunk=q_chunk,
                                        kv_chunk=kv_chunk))
    new = cache_update_prefill(cache, k, v)
    if kvg.n > 1:
        new = dict(new, k=kvg.split(new["k"], 1), v=kvg.split(new["v"], 1))
    return out, new


def _whole_queries(p, x) -> list:
    """Each tensor-parallel position's copy of the whole queries (b, s, H,
    dh): the split projections all-gathered (or one whole projection)."""
    if not isinstance(p.wq, Blocks):
        return [_proj(bf16(x), p.wq)]
    tp = p.wq.group
    q = [_proj(xm, w) for xm, w in zip(tp.broadcast(bf16(x)), p.wq)]
    return tp.all_gather(q, 2 if _layout(p) == "heads" else 3)


def _whole_kv(p, x) -> tuple:
    """The new token's whole keys and values: each tensor-parallel
    position's copy (one where the projections are whole)."""
    if not isinstance(p.wk, Blocks):
        xc = bf16(x)
        return [_proj(xc, p.wk)], [_proj(xc, p.wv)]
    tp = p.wk.group
    xs = tp.broadcast(bf16(x))
    return tuple(tp.all_gather([_proj(xm, w) for xm, w in zip(xs, ws)], 3)
                 for ws in (p.wk, p.wv))


def _member_of(kvg, tp) -> list:
    """For each member of ``kvg``, the index of the ``tp`` member whose
    positions it shares (whose copy of a whole value it reads)."""
    if tp is None or tp.positions is None or kvg.positions is None:
        return [0] * kvg.n
    return [next(m for m, q in enumerate(tp.positions) if q & pos)
            for pos in kvg.positions]


def _combine_attend(qs: list, kb: Blocks, vb: Blocks, ok_fn, *, cap=None,
                    tp=None) -> Tensor:
    """Attention of whole queries over keys and values split along the
    sequence (``kb``, ``vb``: ``Blocks`` of dim 1 over a group): each
    position's partial softmax, shifted by the group's max (an all-reduce
    max) and normalised by the group's sum (an all-reduce), its PV
    product in fp32, the partials' all-reduce rounded to bf16 once.
    ``ok_fn(j, k_j)`` masks position j's slots (None: all valid); ``qs``
    is each ``tp`` member's copy. Returns (b, s, H, dh) bf16."""
    kvg = kb.group
    which = _member_of(kvg, tp)
    b, sq, H, dh = qs[0].shape
    KV = kb[0].shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(dh)
    scores = []
    for j, (kj, m) in enumerate(zip(kb, which)):
        qh = qs[m if len(qs) > 1 else 0].reshape(b, sq, KV, g, dh)
        sj = torch.einsum("bqhgd,bkhd->bhgqk", bf16(qh).float(),
                          bf16(kj).float())
        sj = softcap(sj * scale, cap)
        ok = ok_fn(j, kj)
        scores.append(sj if ok is None else torch.where(ok, sj, NEG))
    mx = kvg.pmax([torch.amax(sj, dim=-1) for sj in scores])
    es = [torch.exp(sj - mx.to(sj.device)[..., None]) for sj in scores]
    l = kvg.psum([torch.sum(e, dim=-1) for e in es])
    outs = [torch.einsum("bhgqk,bkhd->bqhgd",
                         bf16(e / l.to(e.device)[..., None]).float(),
                         bf16(vj).float()) for e, vj in zip(es, vb)]
    return bf16(kvg.psum(outs)).reshape(b, sq, H, dh)


def _group_decode(p, x, cache, *, window, rope_theta, use_rope, cap):
    """``attn_decode`` over a cache whose k and v are ``Blocks`` along the
    sequence: the new token's key and value written at slot ``pos % size``
    by the position holding it (a masked index copy at each, no host
    sync), then ``_combine_attend`` over every position's slots."""
    kb, vb = cache["k"], cache["v"]
    kvg = kb.group
    tp = p.wq.group if isinstance(p.wq, Blocks) else None
    which = _member_of(kvg, tp)
    qs = _whole_queries(p, x)
    k1, v1 = _whole_kv(p, x)
    pos = cache["pos"]
    if use_rope:
        at = pos.expand(x.shape[0], 1)
        qs = [apply_rope(qm, at, rope_theta) for qm in qs]
        k1 = [apply_rope(km, at, rope_theta) for km in k1]
    blk = kb[0].shape[1]
    size = blk * kvg.n
    slot = torch.remainder(pos, size).long().reshape(1)
    new_k, new_v = [], []
    for j, (kj, vj) in enumerate(zip(kb, vb)):
        local = slot - j * blk
        inside = (local >= 0) & (local < blk)
        loc = local.clamp(0, blk - 1)
        m = which[j] if len(k1) > 1 else 0
        for old, one, out in ((kj, k1[m], new_k), (vj, v1[m], new_v)):
            val = torch.where(inside, one.to(old.dtype),
                              old.index_select(1, loc))
            out.append(old.index_copy(1, loc, val))
    slot_pos = cache["slot_pos"].index_copy(0, slot, pos.reshape(1))
    new_k, new_v = Blocks(new_k, 1, kvg), Blocks(new_v, 1, kvg)

    def ok(j, kj):
        sp = slot_pos[j * blk:(j + 1) * blk]
        m = (sp >= 0) & (sp <= pos)
        if window > 0:
            m = m & (pos - sp < window)
        return m

    o = _combine_attend(qs, new_k, new_v, ok, cap=cap, tp=tp)
    return _split_out(p, o), {"k": new_k, "v": new_v, "slot_pos": slot_pos,
                              "pos": pos + 1}
