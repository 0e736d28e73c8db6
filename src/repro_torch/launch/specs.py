"""Per-arch sharding rules and ZeRO-1's moment shardings. Mirrors the
layout half of ``repro.launch.specs`` (``SHAPES``, ``ARCH_RULES``, the
serving and training extras, ``arch_rules``, ``cell_applicable``,
``zero1_specs``); its input specs and the dry-run cells are not ported.

Archs whose head count divides the 16-way model axis use Megatron tensor
parallelism over heads (the default rules); the rest split the attention
projections over head_dim and run the attention core sequence-parallel
(``_SEQ_CORE``). granite's 40 experts do not divide 16, so its experts
replicate and each expert's FFN splits over d_ff; xlstm (125M) replicates
its mixers.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed.sharding import AxisRules, axes_of

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

_SEQ_CORE = {"heads": None, "head_dim": "model",
             "attn_core_seq_shard": "model"}
# serving: no gradient sync, so the data axis is free capacity for weight
# sharding (dbrx's expert weights: EP over model x per-expert ff over data)
SERVE_EXTRA_RULES = {
    "dbrx-132b": {"moe_ff": ("pod", "data")},
}
# training: dbrx's expert weights exceed a device under pure EP -> FSDP the
# per-expert ff over data (and pods on 2 x 16 x 16)
TRAIN_EXTRA_RULES = {
    "dbrx-132b": {"moe_ff": ("pod", "data")},
}

ARCH_RULES = {
    "whisper-large-v3": _SEQ_CORE,
    "starcoder2-7b": _SEQ_CORE,
    "gemma3-1b": _SEQ_CORE,
    "recurrentgemma-2b": _SEQ_CORE,
    "granite-moe-3b-a800m": {**_SEQ_CORE, "experts": None, "moe_ff": "model"},
    "xlstm-125m": {"heads": None, "head_dim": None, "rnn": None},
}


def arch_rules(mesh, arch: str, extra: Optional[dict] = None) -> AxisRules:
    rules = dict(ARCH_RULES.get(arch, {}))
    if extra:
        rules.update(extra)
    return AxisRules(mesh, rules)


def cell_applicable(cfg, shape: str) -> tuple:
    """(runnable, reason): a 500k-token decode cache only for archs whose
    state stays bounded (``cfg.sub_quadratic``)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode cache skipped"
    return True, ""


def zero1_specs(shapes, base_specs, rules: AxisRules):
    """Additionally split optimizer moments over the data axis (ZeRO-1):
    for each leaf, the first unsplit dim that the data axis's size divides
    takes it; a leaf already split over the data axis, or with no such
    dim, keeps its spec. Under a ``("pod", "data")`` batch the moments
    split within a pod only (the tuple's last axis). ``shapes`` and
    ``base_specs`` are trees of one structure (dicts and lists; leaves:
    anything with ``shape``, or a shape tuple, and spec tuples)."""
    data_axis = rules.rules.get("batch")
    if data_axis is None:
        return base_specs
    if isinstance(data_axis, tuple):
        data_axis = data_axis[-1]  # shard moments within-pod only
    size = rules.mesh.shape[data_axis]

    def one(shape, spec):
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if any(data_axis in axes_of(e) for e in entries):
            return spec  # leaf already FSDP-sharded over the data axis
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and dim % size == 0 and dim >= size:
                entries[i] = data_axis
                return tuple(entries)
        return spec

    def visit(sh, sp):
        if isinstance(sh, dict):
            return {k: visit(sh[k], sp[k]) for k in sh}
        if isinstance(sh, list):
            return [visit(a, b) for a, b in zip(sh, sp)]
        return one(tuple(getattr(sh, "shape", sh)), sp)

    return visit(shapes, base_specs)
