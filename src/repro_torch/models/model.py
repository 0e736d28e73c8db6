"""Decoder LMs over a cycled pattern of attention blocks. Mirrors
``repro.models.model`` for the dense decoder archs.

A model is ``cfg.pattern`` cycled over ``n_layers``: ``"attn"`` (global
causal attention) and ``"local"`` (sliding-window causal attention), each
block [norm -> mixer -> residual] + [norm -> MLP -> residual], with
optional post-norms and softcaps. The reference scans stacked periods of
blocks (``lax.scan`` under ``remat``); here the blocks are one
``nn.ModuleList`` in layer order, which is what serving needs.
``params_from_jax`` unstacks the reference's param tree into it, so the
same weights compute in both packages.

Not ported yet, and refused with the ROADMAP item that ports them (never
computed some other way): MoE (A13b), the recurrent blocks ``rec``,
``mlstm`` and ``slstm`` (A13c), the encoder-decoder with cross attention
(A13d), and ``lm_loss`` with training (A13e). The passes run without
autograd (``torch.no_grad``): gradients come with A13e.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import Tensor, nn

from repro_torch.core.clustering import Seed, make_generator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embedding, LayerNorm, RMSNorm,
                                       Unembed, bf16, weak_scalar,
                                       sinusoidal_positions, softcap, unembed)

UNPORTED_KINDS = {"rec": "A13c", "mlstm": "A13c", "slstm": "A13c"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = ("attn",)
    window: int = 4096
    mlp_kind: str = "swiglu"          # swiglu | geglu | gelu | none
    norm_kind: str = "rms"            # rms | ln
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    pos_kind: str = "rope"            # rope | sinusoidal | none
    rope_theta: float = 10000.0
    post_norm: bool = False
    embed_scale: bool = False
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"            # none | audio_stub | vision_stub
    n_prefix: int = 0
    d_rnn: int = 0
    conv_width: int = 4
    lstm_chunk: int = 128
    tie_embeddings: bool = True
    q_chunk: int = 512
    kv_chunk: int = 512
    banded_causal: bool = False
    remat: bool = True
    sub_quadratic: bool = False       # state bounded in sequence length

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def rest_kinds(self) -> tuple:
        return self.pattern[: self.n_layers % self.period]

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def layer_kinds(self) -> list:
        return [self.pattern[i % self.period] for i in range(self.n_layers)]


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what the port
    does not run yet."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet (ROADMAP A13b)")
    if cfg.enc_dec or cfg.frontend == "audio_stub":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder, cross attention and the "
            "audio stub's frames are not ported yet (ROADMAP A13d)")
    for kind in set(cfg.pattern):
        if kind in UNPORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} blocks are not ported yet (ROADMAP "
                f"{UNPORTED_KINDS[kind]})")
        if kind not in ("attn", "local"):
            raise ValueError(f"unknown block kind {kind}")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _make_norm(cfg: ModelConfig, device):
    return (RMSNorm(cfg.d_model, device) if cfg.norm_kind == "rms"
            else LayerNorm(cfg.d_model, device))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.norm1 = _make_norm(cfg, device)
        self.mixer = attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, device)
        if cfg.mlp_kind != "none":
            self.norm2 = _make_norm(cfg, device)
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
        if cfg.post_norm:
            self.norm1_post = _make_norm(cfg, device)
            if cfg.mlp_kind != "none":
                self.norm2_post = _make_norm(cfg, device)


def apply_block(bp: Block, x: Tensor, cfg: ModelConfig, mode: str,
                cache=None):
    """One block; ``mode`` in {"train", "prefill", "decode"}. Returns (x,
    the block's new cache)."""
    h = bp.norm1(x)
    window = cfg.window if bp.kind == "local" else 0
    use_rope = cfg.pos_kind == "rope"
    kw = dict(window=window, rope_theta=cfg.rope_theta, use_rope=use_rope,
              cap=cfg.attn_softcap)
    new_cache = cache
    if mode == "train":
        mix = attn.attn_forward(bp.mixer, h, causal=True, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk,
                                banded_causal=cfg.banded_causal, **kw)
    elif mode == "prefill":
        mix, new_cache = attn.attn_prefill(bp.mixer, h, cache,
                                           q_chunk=cfg.q_chunk,
                                           kv_chunk=cfg.kv_chunk, **kw)
    elif mode == "decode":
        mix, new_cache = attn.attn_decode(bp.mixer, h, cache, **kw)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if cfg.post_norm:
        mix = bp.norm1_post(mix)
    x = x + mix
    if cfg.mlp_kind != "none":
        ff = bp.mlp(bp.norm2(x))
        if cfg.post_norm:
            ff = bp.norm2_post(ff)
        x = x + ff
    return x, new_cache


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """Parameters at the reference's names and shapes: ``embed.embedding``
    (padded_vocab, d), ``layers[i]`` (``norm1``, ``mixer.{wq,wk,wv,wo}``,
    ``norm2``, ``mlp.{w_in,w_gate,w_out}``, post-norms), ``final_norm`` and,
    untied, ``unembed.lm_head`` (d, padded_vocab). Made empty: fill it with
    ``init_params`` or ``params_from_jax``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, device)
        self.layers = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in cfg.layer_kinds())
        self.final_norm = _make_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.unembed = Unembed(cfg.d_model, cfg.padded_vocab, device)

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device


def init_params(rng: Seed, cfg: ModelConfig,
                device: DeviceLike = "cuda") -> Model:
    """A model on ``device`` with weights drawn from ``rng`` (a seed, or a
    ``torch.Generator`` on that device) at the reference's shapes and stds:
    N(0, 1/d) embeddings and input projections, N(0, 1/(H dh)) for ``wo``,
    N(0, 1/d_ff) for ``w_out``; RMSNorm scales 0, LayerNorm 1 and 0. Not
    bit-equal to the reference's ``jax.random`` draws: carry its weights
    across with ``params_from_jax``. ``device="meta"`` makes the shapes
    only (``param_count`` of a full config without memory)."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    gen = None if dev.type == "meta" else make_generator(rng, dev)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    return model


def param_count(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device: DeviceLike = "cuda") -> Model:
    """A model on ``device`` holding the reference's params (``tree``, the
    ``init_params`` dict with numpy leaves). ``decoder.scan[j]``'s leaves,
    stacked over periods, unstack into layer ``p * period + j``;
    ``decoder.rest[i]`` is layer ``n_periods * period + i``."""
    dev = resolve_device(device)
    state = {}

    def put(prefix, sub, index=None):
        for name, leaf in sub.items():
            if isinstance(leaf, dict):
                put(f"{prefix}{name}.", leaf, index)
            else:
                a = np.asarray(leaf, np.float32)
                state[prefix + name] = torch.tensor(
                    a if index is None else a[index])

    put("embed.", tree["embed"])
    put("final_norm.", tree["final_norm"])
    if "unembed" in tree:
        put("unembed.", tree["unembed"])
    dec = tree["decoder"]
    for j, slot in enumerate(dec["scan"]):
        for p in range(cfg.n_periods):
            put(f"layers.{p * cfg.period + j}.", slot, p)
    for i, bp in enumerate(dec["rest"]):
        put(f"layers.{cfg.n_periods * cfg.period + i}.", bp)
    model = Model(cfg, dev)
    model.load_state_dict(state, strict=True)
    return model


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _embed_in(model: Model, tokens: Tensor, offset=0) -> Tensor:
    """Token embeddings in bf16, scaled and with sinusoidal positions from
    ``offset`` (a decode step's: the cache's position) where the config
    asks."""
    cfg = model.cfg
    x = model.embed(tokens)
    if cfg.embed_scale:
        x = x * weak_scalar(x, math.sqrt(cfg.d_model))
    if cfg.pos_kind == "sinusoidal":
        pe = sinusoidal_positions(tokens.shape[1], cfg.d_model, x.device,
                                  offset)
        x = x + pe[None].to(x.dtype)
    return x


@torch.no_grad()
def _logits(model: Model, x: Tensor) -> Tensor:
    cfg = model.cfg
    x = model.final_norm(x)
    w = (model.embed.embedding.T if cfg.tie_embeddings
         else model.unembed.lm_head)
    return softcap(unembed(x, w), cfg.final_softcap)


def _with_prefix(model: Model, x: Tensor, batch: dict) -> Tensor:
    """The vision stub's precomputed patch embeddings ahead of the
    tokens'."""
    if model.cfg.frontend == "vision_stub":
        x = torch.cat([bf16(torch.as_tensor(batch["patches"],
                                            device=x.device)), x], dim=1)
    return x


def _tokens(model: Model, batch: dict) -> Tensor:
    return torch.as_tensor(batch["tokens"], device=model.device).long()


@torch.no_grad()
def forward_hidden(model: Model, batch: dict) -> Tensor:
    """Teacher-forced full-sequence final hidden states (before the final
    norm), (b, n_prefix + s, d) bf16. ``batch``: ``tokens`` (b, s) and, for
    a vision-stub frontend, ``patches`` (b, n_prefix, d)."""
    x = _with_prefix(model, _embed_in(model, _tokens(model, batch)), batch)
    for bp in model.layers:
        x, _ = apply_block(bp, x, model.cfg, "train")
    return x


@torch.no_grad()
def forward(model: Model, batch: dict) -> Tensor:
    """Teacher-forced full-sequence logits (b, s, padded_vocab), fp32."""
    return _logits(model, forward_hidden(model, batch))


def pooled_embedding(model: Model, tokens, batch_size: int = 256) -> Tensor:
    """Document embeddings: the mean over positions of the fp32 final hidden
    states of token rows (n, s), ``batch_size`` rows a forward. Returns an
    (n, d) fp32 tensor on the model's device."""
    tokens = torch.as_tensor(tokens, device=model.device)
    out = []
    for lo in range(0, tokens.shape[0], batch_size):
        h = forward_hidden(model, {"tokens": tokens[lo:lo + batch_size]})
        out.append(torch.mean(h.float(), dim=1))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Caches / serving
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device) -> dict:
    window = cfg.window if kind == "local" else 0
    return attn.init_kv_cache(batch, cfg.n_kv_heads, cfg.head_dim, max_len,
                              window=window, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> list:
    """One KV cache a layer, in layer order (the reference stacks them by
    pattern slot)."""
    check_ported(cfg)
    dev = resolve_device(device)
    return [_block_cache(cfg, kind, batch, max_len, dev)
            for kind in cfg.layer_kinds()]


@torch.no_grad()
def prefill(model: Model, batch: dict, max_len: int):
    """Process the prompt; returns (the last position's logits (b, 1, V),
    the cache ``{"self": [a cache a layer]}``; the reference's also holds
    the encoder-decoder's cross caches, A13d)."""
    tokens = _tokens(model, batch)
    caches = init_cache(model.cfg, tokens.shape[0], max_len, model.device)
    x = _with_prefix(model, _embed_in(model, tokens), batch)
    new = []
    for bp, c in zip(model.layers, caches):
        x, c = apply_block(bp, x, model.cfg, "prefill", c)
        new.append(c)
    return _logits(model, x[:, -1:]), {"self": new}


@torch.no_grad()
def decode_step(model: Model, token, cache: dict):
    """token: (b, 1) -> (logits (b, 1, V), the new cache). The position is
    the caches' (every ported block is an attention block)."""
    token = torch.as_tensor(token, device=model.device)
    x = _embed_in(model, token, offset=cache["self"][0]["pos"])
    new = []
    for bp, c in zip(model.layers, cache["self"]):
        x, c = apply_block(bp, x, model.cfg, "decode", c)
        new.append(c)
    return _logits(model, x), {"self": new}
