"""The LMs of every registered arch: a cycled pattern of blocks, and the
whisper encoder-decoder. Mirrors ``repro.models.model``.

A model is ``cfg.pattern`` cycled over ``n_layers``:

  "attn"   - global causal attention (RoPE, softcap optional)
  "local"  - sliding-window causal attention
  "rec"    - the RG-LRU recurrent block (Griffin / RecurrentGemma)
  "mlstm"  - xLSTM's matrix-memory block (chunkwise-parallel)
  "slstm"  - xLSTM's scalar-memory block (sequential)

each block [norm -> mixer -> residual] + [norm -> MLP or MoE -> residual],
with optional post-norms and softcaps. The encoder-decoder (whisper) runs
an encoder stack of non-causal attention blocks over the audio stub's
frames and adds cross attention to each decoder block; the vision and
audio frontends are stubs that supply precomputed patch or frame
embeddings. The reference scans stacked periods of blocks (``lax.scan``
under ``remat``); here each stack is one ``nn.ModuleList`` in layer
order. ``params_from_jax`` unstacks the reference's param tree into it,
so the same weights compute in both packages, and ``params_to_jax``
stacks it back (``to_jax_tree`` / ``from_jax_tree`` map any tensors keyed
by parameter name, gradients and optimizer moments too).

Training: ``lm_loss`` is the reference's next-token loss with its
sequence-chunked, rematerialised unembedding over ``train_hidden``;
``train_hidden``, ``encode`` and ``_logits`` build an autograd graph where
grad is enabled, and in ``"train"`` mode each decoder block runs under
``torch.utils.checkpoint`` when ``cfg.remat`` is set. The serving and
evaluation entry points (``forward_hidden``, ``forward``,
``pooled_embedding``, ``prefill``, ``decode_step``) run under
``torch.no_grad``: they build no graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import Tensor, nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.core.clustering import Seed, make_generator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (AxisRules, Blocks,
                                              CollectiveStats, Placed,
                                              _leaf_logical, axes_of,
                                              block_slices, mark, mesh_group,
                                              positions, quiet_ops, scope)
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (MLP, Embedding, LayerNorm, RMSNorm,
                                       Unembed, bf16, weak_scalar,
                                       sinusoidal_positions, softcap, unembed)
from repro_torch.models.moe import MoE, apply_moe

ATTENTION = ("attn", "local")


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


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _make_norm(cfg: ModelConfig, device):
    return (RMSNorm(cfg.d_model, device) if cfg.norm_kind == "rms"
            else LayerNorm(cfg.d_model, device))


def _attention(cfg: ModelConfig, device):
    return attn.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, device)


class Block(nn.Module):
    """One block of ``kind``; ``cross`` adds the decoder's cross attention
    (``norm_cross``, ``cross``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 cross: bool = False):
        super().__init__()
        self.kind = kind
        self.norm1 = _make_norm(cfg, device)
        if kind in ATTENTION:
            self.mixer = _attention(cfg, device)
        elif kind == "rec":
            self.mixer = rec.RGLRU(cfg.d_model, cfg.d_rnn, cfg.conv_width,
                                   device)
        elif kind == "mlstm":
            self.mixer = rec.MLSTM(cfg.d_model, cfg.n_heads, cfg.head_dim,
                                   device)
        elif kind == "slstm":
            self.mixer = rec.SLSTM(cfg.d_model, cfg.n_heads, cfg.head_dim,
                                   device)
        else:
            raise ValueError(f"unknown block kind {kind}")
        if cross:
            self.norm_cross = _make_norm(cfg, device)
            self.cross = _attention(cfg, device)
        if cfg.mlp_kind != "none":
            self.norm2 = _make_norm(cfg, device)
            if cfg.is_moe:
                self.moe = MoE(cfg.d_model, cfg.moe_d_ff, cfg.moe_experts,
                               device)
            else:
                self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, device)
        if cfg.post_norm:
            self.norm1_post = _make_norm(cfg, device)
            if cfg.mlp_kind != "none":
                self.norm2_post = _make_norm(cfg, device)


MODES = ("train", "encode", "prefill", "decode")


def _mix(bp: Block, h: Tensor, cfg: ModelConfig, mode: str, cache):
    """The block's mixer; returns (its output, the block's new cache)."""
    kind = bp.kind
    if kind in ATTENTION:
        kw = dict(window=cfg.window if kind == "local" else 0,
                  rope_theta=cfg.rope_theta,
                  use_rope=cfg.pos_kind == "rope", cap=cfg.attn_softcap)
        if mode == "train":
            return attn.attn_forward(bp.mixer, h, causal=True,
                                     q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk,
                                     banded_causal=cfg.banded_causal,
                                     **kw), cache
        if mode == "encode":
            kw["window"] = 0
            return attn.attn_forward(bp.mixer, h, causal=False,
                                     q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk, **kw), cache
        if mode == "prefill":
            return attn.attn_prefill(bp.mixer, h, cache, q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk, **kw)
        return attn.attn_decode(bp.mixer, h, cache, **kw)
    if kind == "rec":
        return rec.rglru_block(bp.mixer, h, cache)
    if kind == "mlstm":
        # every mode, decode included (chunk 1), as the reference
        return rec.mlstm_chunkwise(bp.mixer, h, cache,
                                   chunk=min(cfg.lstm_chunk, h.shape[1]))
    return rec.slstm_block(bp.mixer, h, cache)


def apply_block(bp: Block, x: Tensor, cfg: ModelConfig, mode: str,
                cache=None, enc_out: Optional[Tensor] = None,
                cross_cache=None):
    """One block; ``mode`` in {"train", "encode", "prefill", "decode"}
    ("encode": non-causal attention, the encoder's). A decoder block with
    cross attention attends over ``cross_cache`` (k, v) where given, else
    over ``enc_out``'s. Returns (x, the block's new cache)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    mix, new_cache = _mix(bp, bp.norm1(x), cfg, mode, cache)
    if cfg.post_norm:
        mix = bp.norm1_post(mix)
    x = x + mix
    if hasattr(bp, "cross"):
        hc = bp.norm_cross(x)
        ck, cv = (cross_cache if cross_cache is not None
                  else attn.cross_kv(bp.cross, enc_out))
        x = x + attn.cross_attend(bp.cross, hc, ck, cv, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk,
                                  cap=cfg.attn_softcap)
    if cfg.mlp_kind != "none":
        h2 = bp.norm2(x)
        if cfg.is_moe:
            ff = apply_moe(bp.moe, h2, top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor)
        else:
            ff = bp.mlp(h2)
        if cfg.post_norm:
            ff = bp.norm2_post(ff)
        x = x + ff
    return x, new_cache


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """Parameters at the reference's names and shapes: ``embed.embedding``
    (padded_vocab, d), ``layers[i]`` (``norm1``; ``mixer``: attention's
    ``{wq,wk,wv,wo}``, RG-LRU's, mLSTM's or sLSTM's weights; ``norm2`` with
    ``mlp.{w_in,w_gate,w_out}`` or ``moe.{w_router,we_in,we_gate,we_out}``;
    post-norms; the decoder's ``norm_cross`` and ``cross``), ``final_norm``,
    untied ``unembed.lm_head`` (d, padded_vocab), and for the
    encoder-decoder ``encoder[i]`` and ``enc_norm``. Made empty: fill it
    with ``init_params`` or ``params_from_jax``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, device)
        if cfg.enc_dec:
            self.encoder = nn.ModuleList(Block(cfg, "attn", device)
                                         for _ in range(cfg.n_enc_layers))
            self.enc_norm = _make_norm(cfg, device)
        self.layers = nn.ModuleList(Block(cfg, kind, device,
                                          cross=cfg.enc_dec)
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
    N(0, 1/d) embeddings, input projections, gates, router and experts'
    inputs; N(0, 1/(H dh)) for ``wo`` and the LSTMs' ``w_lstm_out``;
    N(0, 1/d_ff) for ``w_out`` and ``we_out``; N(0, 1/d_rnn) for the
    RG-LRU's conv, gates and output, N(0, 1/dh) for the sLSTM's recurrent
    weights; RG-LRU ``lam`` so that sigmoid(lam)^8 is uniform in [0.9,
    0.999]; RMSNorm scales 0, LayerNorm 1 and 0. Not bit-equal to the
    reference's ``jax.random`` draws: carry its weights across with
    ``params_from_jax``. ``device="meta"`` makes the shapes only
    (``param_count`` of a full config without memory)."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    gen = None if dev.type == "meta" else make_generator(rng, dev)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    return model


def param_count(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    """``{"a": {"b": x}}`` -> ``{prefix + "a.b": x}``."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out.update(_flat(sub, f"{prefix}{name}."))
        else:
            out[prefix + name] = sub
    return out


def _stack(layers: dict, period: int, n_periods: int) -> dict:
    """One stack of the reference's tree from ``{layer index: {name:
    tensor}}``: ``scan[j]`` stacks layers ``p * period + j`` over p,
    ``rest[i]`` is layer ``n_periods * period + i``."""
    scan = [_nest({name: torch.stack([layers[p * period + j][name]
                                      for p in range(n_periods)])
                   for name in layers[j]})
            for j in range(period)] if n_periods else []
    rest = [_nest(layers[i]) for i in range(n_periods * period, len(layers))]
    return {"scan": scan, "rest": rest}


_TOPS = ("embed", "final_norm", "unembed", "enc_norm")


def _stacks(cfg: ModelConfig) -> list:
    """(tree key, parameter name prefix, period, periods) of each stack."""
    out = [("decoder", "layers", cfg.period, cfg.n_periods)]
    if cfg.enc_dec:
        out.append(("encoder", "encoder", 1, cfg.n_enc_layers))
    return out


def to_jax_tree(named: dict, cfg: ModelConfig) -> dict:
    """The reference's param tree (``embed``, ``decoder`` / ``encoder``
    stacks of ``scan`` and ``rest``, norms, ``unembed``) from tensors keyed
    by the port's parameter names: the params, or gradients or optimizer
    moments of them. Stacked leaves are new tensors on the leaves'
    device."""
    top: dict = {}
    for name, leaf in named.items():
        head, rest = name.split(".", 1)
        top.setdefault(head, {})[rest] = leaf
    tree = {head: _nest(top[head]) for head in _TOPS if head in top}
    for key, head, period, n_periods in _stacks(cfg):
        layers: dict = {}
        for name, leaf in top[head].items():
            i, rest = name.split(".", 1)
            layers.setdefault(int(i), {})[rest] = leaf
        tree[key] = _stack(layers, period, n_periods)
    return tree


def from_jax_tree(tree: dict, cfg: ModelConfig) -> dict:
    """The inverse of ``to_jax_tree``: ``{parameter name: leaf}``, each
    stacked leaf indexed by its period (a view of a numpy or torch leaf).
    A stack's ``scan[j]`` leaves unstack into layer ``p * period + j``;
    ``rest[i]`` is layer ``n_periods * period + i``: ``decoder`` into
    ``layers``, ``encoder`` (period 1) into ``encoder``."""
    named = {}
    for head in _TOPS:
        if head in tree:
            named.update(_flat(tree[head], f"{head}."))
    for key, head, period, n_periods in _stacks(cfg):
        for j, slot in enumerate(tree[key]["scan"]):
            for name, leaf in _flat(slot).items():
                for p in range(n_periods):
                    named[f"{head}.{p * period + j}.{name}"] = leaf[p]
        for i, bp in enumerate(tree[key]["rest"]):
            for name, leaf in _flat(bp).items():
                named[f"{head}.{n_periods * period + i}.{name}"] = leaf
    return named


def params_from_jax(tree: dict, cfg: ModelConfig,
                    device: DeviceLike = "cuda") -> Model:
    """A model on ``device`` holding the reference's params (``tree``, the
    ``init_params`` dict with numpy leaves), unstacked by
    ``from_jax_tree``."""
    dev = resolve_device(device)
    state = {name: torch.tensor(np.asarray(leaf, np.float32))
             for name, leaf in from_jax_tree(tree, cfg).items()}
    model = Model(cfg, dev)
    model.load_state_dict(state, strict=True)
    return model


def params_to_jax(model: Model, device: DeviceLike = "cpu") -> dict:
    """The inverse of ``params_from_jax``: the reference's param tree of
    the model's weights (``to_jax_tree``), fp32 tensors copied to
    ``device`` (``"meta"``: shapes and dtypes only)."""
    return to_jax_tree({name: p.detach().to(device)
                        for name, p in model.named_parameters()}, model.cfg)


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

def reference_path(name: str, cfg: ModelConfig) -> tuple:
    """A parameter's path in the reference's param tree (``to_jax_tree``'s
    layout, ``/``-joined) and whether it lies under a ``scan`` stack (whose
    leaves carry a leading periods dim)."""
    head, rest = name.split(".", 1)
    for key, prefix, period, n_periods in _stacks(cfg):
        if head == prefix:
            i, sub = rest.split(".", 1)
            i, sub = int(i), sub.replace(".", "/")
            if i < n_periods * period:
                return f"{key}/scan/{i % period}/{sub}", True
            return f"{key}/rest/{i - n_periods * period}/{sub}", False
    return name.replace(".", "/"), False


def param_specs(cfg: ModelConfig, rules: AxisRules) -> dict:
    """Each parameter's spec, by name: the reference's
    ``param_spec_tree`` entry of its path, without a scanned leaf's
    leading periods entry."""
    out = {}
    for name, p in Model(cfg, torch.device("meta")).named_parameters():
        path, scanned = reference_path(name, cfg)
        spec = rules.spec(*_leaf_logical(path, p.ndim + scanned, scanned))
        out[name] = spec[1:] if scanned else spec
    return out


# block kinds whose products the port does not split: a group gathers
# their parameters whole at the start of the layer
GATHERED = (rec.MLSTM, rec.SLSTM)


class ShardGroup:
    """One batch group of a sharded step: the positions that share a block
    of the batch (coordinates ``coords`` on the rules' batch axes), one
    along the tensor-parallel axis each (``tp``: the mesh's one axis the
    batch does not split, or, where several are left, the one the
    parameters split over; the others are replica axes, whose positions
    run the group's program alike). The model runs over the group with
    its parameters as the group's positions hold them: a parameter split
    over the tensor-parallel axis is ``Blocks``, one block a position,
    which the model's layers compute on and join with ``tp``'s
    collectives; any other is one tensor, used once for all of them.
    Dimensions split over batch axes (FSDP) are gathered whole at the
    layer's first use, as are the parameters of the ``GATHERED`` kinds.
    Each parameter becomes a leaf of the group's autograd graph, so
    ``grads`` gives each position's gradient of its blocks.

    A gathered leaf is kept for the group's whole run where autograd is
    on (the train step's backward reads it again). Without autograd (the
    serving passes) one first gathered inside a ``layer()`` is dropped
    where that layer ends, so a pass holds one layer's gathered weights at
    a time and still gathers each weight once."""

    def __init__(self, mesh, rules: AxisRules, coords: dict, params: dict,
                 stats: Optional[CollectiveStats] = None):
        self.mesh, self.coords, self.params = mesh, coords, params
        self.stats, self.rules = stats, rules
        self.batch_axes = axes_of(rules.rules.get("batch"))
        other = [a for a in mesh.axis_names if a not in self.batch_axes]
        split = other if len(other) <= 1 else sorted(
            {a for p in params.values() for e in p.spec for a in axes_of(e)
             if a in other}, key=mesh.axis_names.index)
        if len(split) > 1:
            raise ValueError(f"parameters split over {split} besides the "
                             f"batch's {self.batch_axes}: one "
                             "tensor-parallel axis at most")
        # the other axes the parameters do not split are replica axes:
        # their positions run the group's program alike
        self.tp_axis = split[0] if split else None
        self.tp = (mesh_group(mesh, self.tp_axis, coords, stats)
                   if split else mesh_group(mesh, (), coords, stats))
        if not split:
            self.tp.axis = "-"
        self.home = self.tp.home
        # the flat mesh indices of the group's positions (``sharding.scope``)
        self.positions = sorted(set().union(*self.tp.positions))
        # the positions a KV cache's sequence splits over (``kv_seq``)
        kv_axes = axes_of(rules.rules.get("kv_seq"))
        self.kv = (self.tp if kv_axes == (self.tp_axis,) else
                   mesh_group(mesh, kv_axes, coords, stats))
        self.leaves: dict = {}
        self._opened: Optional[list] = None   # gathered in the open layer

    def use_stats(self, stats: Optional[CollectiveStats]) -> None:
        """Record the group's collectives into ``stats`` from now on."""
        self.stats = self.tp.stats = self.kv.stats = stats

    def local(self, p: Placed):
        """A placed serving input (a batch block, a cache leaf) as the
        group holds it: its block where only batch axes split it, else
        ``Blocks`` over the group's tensor-parallel axis or its ``kv``
        axes, whichever splits its one other dimension."""
        dims = [(i, axes_of(e)) for i, e in enumerate(p.spec)
                if axes_of(e) and not set(axes_of(e)) <= set(self.batch_axes)]
        if not dims:
            return p.block(self.coords)
        if len(dims) > 1:
            raise ValueError(f"spec {p.spec} splits two dimensions inside "
                             "a batch group")
        dim, axes = dims[0]
        group = next((g for g in (self.tp, self.kv)
                      if g.axis == ",".join(axes)), None)
        if group is None:
            raise ValueError(f"spec {p.spec} splits over {axes}: neither the "
                             f"group's {self.tp.axis!r} nor its "
                             f"{self.kv.axis!r}")
        return Blocks([p.block({**self.coords, **c})
                       for c in group.member_coords], dim, group)

    @contextlib.contextmanager
    def layer(self):
        """A layer of a pass: without autograd, the leaves first gathered
        inside it are dropped at its end."""
        if torch.is_grad_enabled():
            yield
            return
        outer, self._opened = self._opened, []
        try:
            yield
        finally:
            for name in self._opened:
                del self.leaves[name]
            self._opened = outer

    def param(self, name: str, gather: bool = False):
        if name not in self.leaves:
            self.leaves[name], gathered = self._leaf(self.params[name])
            if gathered and self._opened is not None:
                self._opened.append(name)
        leaf = self.leaves[name]
        if gather and isinstance(leaf, Blocks):
            return self.tp.gathered(leaf, leaf.dim)
        return leaf

    def _leaf(self, p: Placed):
        """(the group's leaf of ``p``, whether it was gathered)."""
        tp_dim, fsdp = None, []
        for i, entry in enumerate(p.spec):
            axes = axes_of(entry)
            if self.tp_axis in axes:
                if len(axes) > 1:
                    raise ValueError(f"spec {p.spec} splits a dimension "
                                     "over the tensor-parallel axis and "
                                     "another")
                tp_dim = i
            elif axes:
                fsdp.append(i)
        leaves = []
        for m in range(self.tp.n if tp_dim is not None else 1):
            coords = dict(self.coords)
            if self.tp_axis is not None:
                coords[self.tp_axis] = m
            # a leaf the tensor-parallel axis does not split is the whole
            # group's value, gathered once on its first device
            held = (self.tp.positions[m] if tp_dim is not None
                    else frozenset(self.positions))
            t = (self._gathered(p, coords, fsdp, held) if fsdp
                 else p.block(coords))
            leaves.append(t.detach().requires_grad_())
        return (Blocks(leaves, tp_dim, self.tp) if tp_dim is not None
                else leaves[0]), bool(fsdp)

    def _gathered(self, p: Placed, coords: dict, dims: list,
                  held: frozenset) -> Tensor:
        """The position's block with its batch-axis dimensions whole: an
        all-gather over those axes, its result the value of ``held`` (and
        held by them alone: a cost trace charges a collective's buffer to
        the scope it is made in)."""
        dev = self.mesh.device_at(coords)
        mine = p.block(coords)
        shape = [p.shape[i] if i in dims else s
                 for i, s in enumerate(mine.shape)]
        parts, seen = [], set()
        with scope(held), quiet_ops():
            out = mark(torch.empty(shape, dtype=mine.dtype, device=dev),
                       held)
            for _, c in positions(self.mesh):
                if any(c[a] != v for a, v in coords.items()
                       if a not in self.batch_axes):
                    continue
                sl = block_slices(self.mesh, p.spec, p.shape, c)
                key = tuple((sl[i].start, sl[i].stop) for i in dims)
                if key not in seen:
                    seen.add(key)
                    part = p.block(c)
                    parts.append(part)
                    out[tuple(sl[i] if i in dims else slice(None)
                              for i in range(len(shape)))] = part.to(dev)
        if self.stats is not None:
            axes = sorted({a for i in dims for a in axes_of(p.spec[i])},
                          key=self.mesh.axis_names.index)
            self.stats.add("all-gather", ",".join(axes),
                           sum(t.numel() * t.element_size() for t in parts))
        return out

    def view(self, structure: "Model") -> "_View":
        return _View(structure, "", self)

    def grads(self, loss: Tensor) -> dict:
        """``{name: [each tensor-parallel position's gradient]}`` (one
        entry where the parameter is not split over that axis; zeros for a
        parameter the forward did not use)."""
        names = list(self.params)
        for name in names:
            self.param(name)
        flat = []
        for name in names:
            leaf = self.leaves[name]
            flat.extend(leaf if isinstance(leaf, Blocks) else [leaf])
        gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        out = {}
        for name in names:
            leaf = self.leaves[name]
            ls = leaf if isinstance(leaf, Blocks) else [leaf]
            out[name] = [g if g is not None else torch.zeros_like(lf)
                         for lf, g in zip(ls, gs)]
        return out


class _View:
    """A module of the model as a ``ShardGroup`` runs it: parameters are
    the group's (``ShardGroup.param``), submodules are views, anything
    else (``kind``, ``cfg``) the module's own, and ``tp_group`` the
    group's tensor-parallel ``AxisGroup`` (``sharding.group_of``); calling
    it runs the module's ``forward`` on the view."""

    __slots__ = ("_module", "_prefix", "_group")

    def __init__(self, module: nn.Module, prefix: str, group: ShardGroup):
        self._module, self._prefix, self._group = module, prefix, group

    def __getattr__(self, name: str):
        m = self._module
        if name in m._parameters:
            return self._group.param(self._prefix + name,
                                     gather=isinstance(m, GATHERED))
        if name in m._modules:
            return _View(m._modules[name], f"{self._prefix}{name}.",
                         self._group)
        if name == "device":
            return self._group.home
        if name == "tp_group":
            return self._group.tp
        if name == "kv_group" and isinstance(m, attn.Attention):
            return self._group.kv
        return getattr(m, name)

    def __getitem__(self, i: int) -> "_View":
        return _View(self._module[i], f"{self._prefix}{i}.", self._group)

    def __len__(self) -> int:
        return len(self._module)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __call__(self, *args):
        return type(self._module).forward(self, *args)


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


def _logits(model: Model, x: Tensor):
    """fp32 logits (b, s, padded_vocab); in a ``ShardGroup`` whose
    unembedding splits over vocab, ``Blocks`` of each position's columns
    (dim 2)."""
    cfg = model.cfg
    x = model.final_norm(x)
    w = model.embed.embedding if cfg.tie_embeddings else \
        model.unembed.lm_head
    vocab_dim = 0 if cfg.tie_embeddings else 1
    if isinstance(w, Blocks):
        if w.dim != vocab_dim:
            raise ValueError("the unembedding splits over the "
                             "tensor-parallel axis only along vocab")
        xs = w.group.broadcast(x)
        return Blocks([softcap(unembed(xm, wm.T if cfg.tie_embeddings
                                       else wm), cfg.final_softcap)
                       for xm, wm in zip(xs, w)], 2, w.group)
    w = w.T if cfg.tie_embeddings else w
    return softcap(unembed(x, w), cfg.final_softcap)


def _with_prefix(model: Model, x: Tensor, batch: dict) -> Tensor:
    """A decoder-only model's stub frontend ahead of the tokens: the vision
    stub's precomputed patch embeddings, or the audio stub's frames where
    the batch holds them."""
    cfg = model.cfg
    key = None
    if cfg.frontend == "vision_stub":
        key = "patches"
    elif cfg.frontend == "audio_stub" and "frames" in batch:
        key = "frames"
    if not cfg.enc_dec and key is not None:
        x = torch.cat([bf16(torch.as_tensor(batch[key], device=x.device)), x],
                      dim=1)
    return x


def _tokens(model: Model, batch: dict) -> Tensor:
    return torch.as_tensor(batch["tokens"], device=model.device).long()


@contextlib.contextmanager
def _layer(i: int, model, encoder: bool = False):
    """The profiler range of a loop's work on layer ``i`` (an encoder
    layer's where ``encoder``): the serving loops name their layers, which
    ``torch.profiler`` shows and a cost trace cuts its live bytes by
    (``launch.cost_analysis``). Where ``model`` is a ``ShardGroup``'s view,
    also the group's ``layer()``, inside the range."""
    with record_function(f"encoder layer {i}" if encoder else f"layer {i}"):
        if isinstance(model, _View):
            with model._group.layer():
                yield
        else:
            yield


def encode(model: Model, frames) -> Tensor:
    """The whisper encoder over precomputed frame embeddings (the conv
    stub's), (b, s_enc, d): sinusoidal positions where the config asks,
    the non-causal encoder blocks, ``enc_norm``. Returns (b, s_enc, d)
    bf16."""
    cfg = model.cfg
    x = bf16(torch.as_tensor(frames, device=model.device))
    if cfg.pos_kind == "sinusoidal":
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device)[None].to(x.dtype)
    for i, bp in enumerate(model.encoder):
        with _layer(i, model, encoder=True):
            x, _ = apply_block(bp, x, cfg, "encode")
    return model.enc_norm(x)


def _block_out(bp: Block, x: Tensor, cfg: ModelConfig,
               enc_out: Optional[Tensor]) -> Tensor:
    return apply_block(bp, x, cfg, "train", enc_out=enc_out)[0]


def train_hidden(model: Model, batch: dict) -> Tensor:
    """Teacher-forced full-sequence final hidden states (before the final
    norm), (b, n_prefix + s, d) bf16, with autograd where grad is enabled:
    the training path (``lm_loss``). ``batch``: ``tokens`` (b, s); for the
    encoder-decoder ``frames`` (b, s_enc, d); for a vision-stub frontend
    ``patches`` (b, n_prefix, d).

    With grad enabled and ``cfg.remat``, each decoder block runs under
    ``torch.utils.checkpoint``: the forward keeps only the block's input,
    and the backward recomputes the block from it, one block at a time.
    This is the inner level of the reference's two-level remat; its outer
    level (one saved input a period) exists for its ``lax.scan`` over
    periods, which would otherwise keep every block's input of the scan.
    A Python loop over layers keeps one (b, s, d) bf16 input a layer
    (0.5 GB for gemma3-1b at 8 x 1024 tokens), and a second level would
    buy back most of that at the price of running every block a third
    time. The recomputation runs the same ops on the same inputs, so the
    gradients equal those without remat bit for bit. The encoder's stack
    runs in ``"encode"`` mode, without remat, as the reference's does."""
    cfg = model.cfg
    x = _embed_in(model, _tokens(model, batch))
    enc_out = None
    if cfg.enc_dec:
        enc_out = encode(model, batch["frames"])
    else:
        x = _with_prefix(model, x, batch)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in model.layers:
        if remat:
            x = checkpoint(_block_out, bp, x, cfg, enc_out,
                           use_reentrant=False)
        else:
            x = _block_out(bp, x, cfg, enc_out)
    return x


@torch.no_grad()
def forward_hidden(model: Model, batch: dict) -> Tensor:
    """``train_hidden`` without autograd: the teacher-forced pass that
    embedding and evaluation call (the reference's ``forward_hidden``),
    which holds full-width activations it never differentiates."""
    return train_hidden(model, batch)


@torch.no_grad()
def forward(model: Model, batch: dict) -> Tensor:
    """Teacher-forced full-sequence logits (b, s, padded_vocab), fp32."""
    return _logits(model, forward_hidden(model, batch))


@torch.no_grad()
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
    if kind in ATTENTION:
        window = cfg.window if kind == "local" else 0
        return attn.init_kv_cache(batch, cfg.n_kv_heads, cfg.head_dim,
                                  max_len, window=window, device=device)
    if kind == "rec":
        return rec.init_rglru_cache(batch, cfg.d_rnn, cfg.conv_width, device)
    if kind == "mlstm":
        return rec.init_mlstm_cache(batch, cfg.n_heads, cfg.head_dim, device)
    if kind == "slstm":
        return rec.init_slstm_cache(batch, cfg.n_heads, cfg.head_dim, device)
    raise ValueError(f"unknown block kind {kind}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> list:
    """One cache a layer, in layer order (the reference stacks them by
    pattern slot): a KV cache for an attention block, the recurrent state
    for the others."""
    dev = resolve_device(device)
    return [_block_cache(cfg, kind, batch, max_len, dev)
            for kind in cfg.layer_kinds()]


def _cache_pos(cfg: ModelConfig, caches: list):
    """The decode position: the first attention layer's cache's, else 0
    (the reference's ``_cache_pos``; its only use is the sinusoidal
    positions)."""
    for kind, c in zip(cfg.layer_kinds(), caches):
        if kind in ATTENTION:
            return c["pos"]
    return 0


@torch.no_grad()
def prefill(model: Model, batch: dict, max_len: int, caches=None):
    """Process the prompt; returns (the last position's logits (b, 1, V),
    the cache ``{"self": [a cache a layer], "cross": [(k, v) a layer] or
    None}``). The encoder-decoder encodes ``batch["frames"]`` once here and
    keeps each decoder layer's cross keys and values. ``caches``: the
    empty caches to fill (default ``init_cache``'s)."""
    cfg = model.cfg
    tokens = _tokens(model, batch)
    if caches is None:
        caches = init_cache(cfg, tokens.shape[0], max_len, model.device)
    x = _embed_in(model, tokens)
    cross = None
    if cfg.enc_dec:
        cross = build_cross_cache(model, encode(model, batch["frames"]))
    else:
        x = _with_prefix(model, x, batch)
    new = []
    for i, (bp, c) in enumerate(zip(model.layers, caches)):
        with _layer(i, model):
            x, c = apply_block(bp, x, cfg, "prefill", c,
                               cross_cache=None if cross is None
                               else cross[i])
        new.append(c)
    return _logits(model, x[:, -1:]), {"self": new, "cross": cross}


def build_cross_cache(model: Model, enc_out: Tensor) -> list:
    """Each decoder layer's cross keys and values over ``enc_out``."""
    out = []
    for i, bp in enumerate(model.layers):
        with _layer(i, model):
            out.append(attn.cross_kv(bp.cross, enc_out))
    return out


def init_cross_cache(cfg: ModelConfig, batch: int, enc_len: int,
                     device: DeviceLike = "cuda") -> list:
    """Zero cross caches, (k, v) of (batch, enc_len, KV, dh) bf16 a decoder
    layer."""
    dev = resolve_device(device)
    shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return [tuple(torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                  for _ in range(2)) for _ in range(cfg.n_layers)]


@torch.no_grad()
def decode_step(model: Model, token, cache: dict):
    """token: (b, 1) -> (logits (b, 1, V), the new cache). The position
    (for sinusoidal positions) is the first attention layer's cache's, or
    0 where there is none; the cross caches pass through."""
    cfg = model.cfg
    token = torch.as_tensor(token, device=model.device)
    x = _embed_in(model, token, offset=_cache_pos(cfg, cache["self"]))
    cross = cache.get("cross")
    new = []
    for i, (bp, c) in enumerate(zip(model.layers, cache["self"])):
        with _layer(i, model):
            x, c = apply_block(bp, x, cfg, "decode", c,
                               cross_cache=None if cross is None
                               else cross[i])
        new.append(c)
    return _logits(model, x), {"self": new, "cross": cross}


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

def batch_groups(rules: AxisRules) -> list:
    """The coordinates of each batch group on the rules' batch axes,
    row-major."""
    axes = axes_of(rules.rules.get("batch"))
    shape = [rules.mesh.shape[a] for a in axes]
    return [dict(zip(axes, idx)) for idx in np.ndindex(*shape)]


def _group_caches(view, cfg: ModelConfig, batch: int, max_len: int) -> list:
    """Empty caches in a group's layout: attention's whole (``attn_prefill``
    cuts them along the sequence), the RG-LRU's channels as ``Blocks``
    where its weights split over rnn, the LSTMs' whole."""
    out = []
    for i, kind in enumerate(cfg.layer_kinds()):
        with _layer(i, view):
            c = _block_cache(cfg, kind, batch, max_len, view.device)
            w = view.layers[i].mixer.w_rnn_in if kind == "rec" else None
            if isinstance(w, Blocks):
                c = {"h": w.group.split(c["h"], 1),
                     "conv": w.group.split(c["conv"], 2)}
        out.append(c)
    return out


def _seq_split(kv, group: ShardGroup):
    """A cross cache's (k, v) along the sequence over the group's ``kv``
    axes, as ``cache_pspecs`` lays it out: from head_dim ``Blocks`` of the
    same group by an all-to-all, from a whole value by a cut."""
    kvg = group.kv
    if kvg.n == 1:
        return kv
    out = []
    for t in kv:
        if isinstance(t, Blocks):
            if t.group is not kvg:
                raise ValueError("a cross cache split over another group "
                                 "than its sequence's")
            out.append(kvg.all_to_all(t, 1, t.dim))
        else:
            out.append(kvg.split(t, 1))
    return tuple(out)


def sharded_prefill(structure: Model, params: dict, batch: dict,
                    max_len: int, rules: AxisRules,
                    stats: Optional[CollectiveStats] = None,
                    groups: Optional[list] = None) -> list:
    """``prefill`` sharded by ``rules``: each batch group (``groups``,
    default all of ``batch_groups``) runs over its positions with
    ``params`` and ``batch`` as they hold them (``{name: Placed}``, the
    batch's rows split over the batch axes), under ``sharding.scope`` of
    its positions. The KV caches come out along the sequence over the
    rules' ``kv_seq`` axes, the RG-LRU's over rnn, the cross caches along
    the sequence too. A weight split over batch axes (FSDP) is gathered
    at its layer's first use and dropped at the layer's end
    (``ShardGroup.layer``). Returns [(logits, cache)] a group:
    logits ``Blocks`` of vocab where the unembedding splits, else one
    tensor."""
    cfg = structure.cfg
    out = []
    for coords in (batch_groups(rules) if groups is None else groups):
        s = ShardGroup(rules.mesh, rules, coords, params, stats)
        mb = {k: s.local(v) for k, v in batch.items()}
        with scope(s.positions), torch.no_grad():
            view = s.view(structure)
            b = mb["tokens"].shape[0]
            logits, cache = prefill(view, mb, max_len,
                                    _group_caches(view, cfg, b, max_len))
            cross = cache["cross"] or []
            for i in range(len(cross)):
                with _layer(i, view):
                    cross[i] = _seq_split(cross[i], s)
        out.append((logits, cache))
    return out


def sharded_decode_step(structure: Model, params: dict, token: Placed,
                        cache: dict, rules: AxisRules,
                        stats: Optional[CollectiveStats] = None,
                        groups: Optional[list] = None) -> list:
    """``decode_step`` sharded by ``rules`` over placed params, token and
    cache (``cache_pspecs``' layout: k and v along the sequence over the
    ``kv_seq`` axes, each position attending over its slots and the
    partial softmaxes joined by the group's all-reduce max and sum; the
    RG-LRU's state over rnn), FSDP weights gathered a layer at a time as
    in ``sharded_prefill``. Returns [(logits, new cache)] a group."""
    out = []
    for coords in (batch_groups(rules) if groups is None else groups):
        s = ShardGroup(rules.mesh, rules, coords, params, stats)
        local = [{k: s.local(v) for k, v in c.items()}
                 for c in cache["self"]]
        cross = None if cache.get("cross") is None else [
            tuple(s.local(t) for t in kv) for kv in cache["cross"]]
        with scope(s.positions), torch.no_grad():
            out.append(decode_step(s.view(structure), s.local(token),
                                   {"self": local, "cross": cross}))
    return out


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _chunk_nll(model: Model, xc: Tensor, lc: Tensor, mc: Tensor):
    """One chunk's (sum of masked NLL, sum of masked log Z), fp32."""
    cfg = model.cfg
    lg = _logits(model, xc)
    if isinstance(lg, Blocks):
        return _chunk_nll_split(cfg, lg, lc, mc)
    lg = lg.float()
    if cfg.padded_vocab != cfg.vocab_size:
        valid = torch.arange(cfg.padded_vocab, device=lg.device) \
            < cfg.vocab_size
        lg = torch.where(valid, lg, -1e30)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, lc[..., None])[..., 0]
    return torch.sum((logz - gold) * mc), torch.sum(logz * mc)


def _chunk_nll_split(cfg: ModelConfig, lgs: Blocks, lc: Tensor,
                     mc: Tensor):
    """``_chunk_nll`` over vocab-split logits: log Z from the positions'
    max (an all-reduce max, outside autograd: log Z's gradient does not
    depend on the shift) and their sums of exp (an all-reduce), the gold
    logit from the position holding its column (an all-reduce)."""
    tp = lgs.group
    cols, lo = [], 0
    for lg in lgs:
        cols.append(torch.arange(lo, lo + lg.shape[-1], device=lg.device))
        lo += lg.shape[-1]
    lgs = [lg.float() if cfg.padded_vocab == cfg.vocab_size else
           torch.where(c < cfg.vocab_size, lg.float(), -1e30)
           for lg, c in zip(lgs, cols)]
    mx = tp.pmax([torch.amax(lg, dim=-1) for lg in lgs])
    se = tp.psum([torch.sum(torch.exp(lg - mx.to(lg.device)[..., None]),
                            dim=-1) for lg in lgs])
    logz = mx + torch.log(se)
    golds = []
    for lg, c in zip(lgs, cols):
        local = lc.to(lg.device) - c[0]
        ok = (local >= 0) & (local < lg.shape[-1])
        g = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])
        golds.append(torch.where(ok, g[..., 0], 0.0))
    gold = tp.psum(golds)
    return torch.sum((logz - gold) * mc), torch.sum(logz * mc)


def _labels_mask(tokens: Tensor, batch: dict) -> tuple:
    """The next-token labels and the loss mask (the last position masked,
    times ``batch["loss_mask"]`` where given), fp32."""
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * torch.as_tensor(batch["loss_mask"],
                                      device=tokens.device)
    return labels, mask


def loss_tokens(model: Model, batch: dict) -> Tensor:
    """The number of positions the loss counts: the mask's sum."""
    return torch.sum(_labels_mask(_tokens(model, batch), batch)[1])


def loss_sums(model: Model, batch: dict, seq_chunk: int = 512) -> tuple:
    """(sum of masked NLL, sum of masked log Z, the mask's sum), 0-d fp32
    tensors: ``lm_loss`` before its division, which a sharded step sums
    over the batch's blocks (the global batch's mean, not a mean of the
    blocks' means)."""
    x = train_hidden(model, batch)                  # (b, s_total, d)
    tokens = _tokens(model, batch)
    x = x[:, x.shape[1] - tokens.shape[1]:]
    labels, mask = _labels_mask(tokens, batch)
    s = x.shape[1]
    seq_chunk = min(seq_chunk, s)
    pad = (-s) % seq_chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    remat = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    logz_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s + pad, seq_chunk):
        args = (model, x[:, lo:lo + seq_chunk], labels[:, lo:lo + seq_chunk],
                mask[:, lo:lo + seq_chunk])
        nll_c, logz_c = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                         if remat else _chunk_nll(*args))
        nll = nll + nll_c
        logz_sum = logz_sum + logz_c
    return nll, logz_sum, torch.sum(mask)


def lm_loss(model: Model, batch: dict, seq_chunk: int = 512) -> tuple:
    """Next-token cross-entropy with a sequence-chunked, rematerialised
    unembedding, as the reference's ``lm_loss``: the (b, s, V) logits never
    exist. Each chunk of ``seq_chunk`` positions computes its fp32 logits
    (padded-vocab columns at -1e30), reduces them to log Z and the gold
    logit a token, and is recomputed in the backward pass
    (``torch.utils.checkpoint``, where grad is enabled): one chunk's
    logits at a time, (b, seq_chunk, V) fp32.

    The prefix positions (a vision stub's patches) are cut off; labels are
    the tokens shifted by one with the last position masked, times
    ``batch["loss_mask"]`` where given; the sequence is padded to a
    multiple of ``seq_chunk`` with masked positions. Returns (loss, metrics
    ``loss``, ``ppl_log``, ``tokens``, ``logz_mean``), 0-d fp32 tensors,
    the loss over ``max(sum(mask), 1)``."""
    nll, logz_sum, count = loss_sums(model, batch, seq_chunk)
    denom = torch.clamp_min(count, 1.0)
    loss = nll / denom
    metrics = {"loss": loss, "ppl_log": loss, "tokens": denom,
               "logz_mean": logz_sum / denom}
    return loss, metrics
