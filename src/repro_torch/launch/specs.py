"""Per-arch sharding rules, input specs and the dry-run's cells. Mirrors
``repro.launch.specs``: ``SHAPES``, ``ARCH_RULES``, the serving and
training extras, ``arch_rules``, ``cell_applicable``, ``zero1_specs``, the
input specs (meta tensors stand in for ``ShapeDtypeStruct``s), the batch
and cache specs, ``Cell``/``build_cell`` for train, prefill and decode, and
``FCVI_SHAPES``/``build_fcvi_cell`` (every variant: ``base``, ``bf16``
and the IVF layouts ``ivf8``, ``ivf8-trunc``, ``opt``).
A cell holds its inputs placed on the mesh (``Placed``: on the meta device
for a dry-run, on a card or the CPU for a real run) and a ``step`` that runs
the port's sharded program over them under the cell's rules.

Archs whose head count divides the 16-way model axis use Megatron tensor
parallelism over heads (the default rules); the rest split the attention
projections over head_dim and run the attention core sequence-parallel
(``_SEQ_CORE``). granite's 40 experts do not divide 16, so its experts
replicate and each expert's FFN splits over d_ff; xlstm (125M) replicates
its mixers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import (AxisRules, CollectiveStats,
                                              axes_of, block_slices, place,
                                              positions, quiet_ops, scope,
                                              use_rules)

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


WHISPER_DEC_LEN = 448  # whisper's decoder context


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------

def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def train_batch_specs(cfg, seq: int, batch: int, device="meta") -> dict:
    """The train batch: whisper's encoder frames carry ``seq`` (its
    decoder ``WHISPER_DEC_LEN`` tokens); a vision stub's patches fill
    ``n_prefix`` of it."""
    if cfg.enc_dec:
        return {"frames": _empty((batch, seq, cfg.d_model), torch.float32,
                                 device),
                "tokens": _empty((batch, WHISPER_DEC_LEN), torch.int32,
                                 device)}
    if cfg.frontend == "vision_stub":
        return {"patches": _empty((batch, cfg.n_prefix, cfg.d_model),
                                  torch.float32, device),
                "tokens": _empty((batch, seq - cfg.n_prefix), torch.int32,
                                 device)}
    return {"tokens": _empty((batch, seq), torch.int32, device)}


def prefill_batch_specs(cfg, seq: int, batch: int, device="meta") -> dict:
    return train_batch_specs(cfg, seq, batch, device)


def decode_input_specs(cfg, seq: int, batch: int, device="meta"):
    """(token (batch, 1) int32, cache): the port's caches, one a layer
    (``models.model.init_cache``; whisper's self cache of 512 and cross
    caches over ``seq`` encoder positions)."""
    from repro_torch.models import model as M
    token = _empty((batch, 1), torch.int32, device)
    if cfg.enc_dec:
        return token, {"self": M.init_cache(cfg, batch, 512, device),
                       "cross": M.init_cross_cache(cfg, batch, seq, device)}
    return token, {"self": M.init_cache(cfg, batch, seq, device),
                   "cross": None}


# ---------------------------------------------------------------------------
# Spec trees of the inputs
# ---------------------------------------------------------------------------

def batch_pspecs(cfg, batch_specs: dict, rules: AxisRules) -> dict:
    return {k: rules.spec("batch", *([None] * (v.ndim - 1)))
            for k, v in batch_specs.items()}


def _kv_cache_pspec(rules: AxisRules, lead: tuple = ()) -> dict:
    return {"k": rules.spec(*lead, "batch", "kv_seq", "kv_heads", None),
            "v": rules.spec(*lead, "batch", "kv_seq", "kv_heads", None),
            "slot_pos": rules.spec(*lead, None),
            "pos": rules.spec(*lead)}


def _block_cache_pspec(cfg, kind: str, rules: AxisRules,
                       lead: tuple = ()) -> dict:
    if kind in ("attn", "local"):
        return _kv_cache_pspec(rules, lead)
    if kind == "rec":
        return {"h": rules.spec(*lead, "batch", "rnn"),
                "conv": rules.spec(*lead, "batch", None, "rnn")}
    if kind == "mlstm":
        return {"C": rules.spec(*lead, "batch", "heads", None, None),
                "n": rules.spec(*lead, "batch", "heads", None),
                "m": rules.spec(*lead, "batch", "heads")}
    if kind == "slstm":
        v = rules.spec(*lead, "batch", "heads", None)
        return {"c": v, "n": v, "h": v, "m": v}
    raise ValueError(kind)


def cache_pspecs(cfg, rules: AxisRules, enc_dec_cross: bool) -> dict:
    """The specs of ``decode_input_specs``' cache, one a layer (the
    reference's stacked ``scan`` slots, their leading periods entry
    dropped, in layer order)."""
    self_spec = [_block_cache_pspec(cfg, kind, rules)
                 for kind in cfg.layer_kinds()]
    cross = None
    if enc_dec_cross:
        kv = rules.spec("batch", "kv_seq", "kv_heads", None)
        cross = [(kv, kv) for _ in range(cfg.n_layers)]
    return {"self": self_spec, "cross": cross}


def _place_tree(tree, specs, mesh):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _place_tree(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(a, b, mesh) for a, b in
                          zip(tree, specs))
    return place(tree, specs, mesh)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One (arch, shape) cell on a mesh: ``inputs`` placed by the rules,
    ``run(stats)`` the port's sharded step over them (its collectives
    recorded into ``stats``)."""
    arch: str
    shape: str
    kind: str
    cfg: object
    mesh: object
    rules: object
    inputs: dict
    run: object
    n_micro: int = 1


def _cell_rules(arch: str, kind: str, batch: int, mesh,
                extra_rules: Optional[dict]) -> AxisRules:
    extra = dict(extra_rules or {})
    if kind in ("prefill", "decode"):
        extra = {**SERVE_EXTRA_RULES.get(arch, {}), **extra}
    if kind == "train":
        extra = {**TRAIN_EXTRA_RULES.get(arch, {}), **extra}
    if kind == "decode" and batch == 1:
        # long-context decode: batch replicated, the KV sequence over
        # data x model
        extra.setdefault("batch", None)
        extra.setdefault("kv_seq", ("data", "model"))
    return arch_rules(mesh, arch, extra)


def _random_batch(cfg, specs: dict, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(v.shape, generator=gen)
    return out


def _model(cfg, device, dtype):
    """The cell's params: shapes only on meta, else drawn from seed 0;
    bf16 in production (mixed precision keeps fp32 masters apart)."""
    from repro_torch.models import model as M
    dev = torch.device(device)
    model = (M.Model(cfg, dev) if dev.type == "meta"
             else M.init_params(0, cfg, dev))
    return model.to(dtype)


def build_cell(cfg, arch: str, shape: str, mesh, n_micro: int = 1,
               extra_rules: Optional[dict] = None, device="meta",
               param_dtype=torch.bfloat16) -> Optional[Cell]:
    """The cell of ``arch`` at ``shape`` on ``mesh`` (None where
    ``cell_applicable`` says no). Train: bf16 params, fp32 masters and
    ZeRO-1 moments, ``n_micro`` microbatches (halved until each stays
    divisible by the data-parallel degree); prefill and decode: bf16
    params, decode's cache laid out by ``cache_pspecs``. On a device
    other than meta the params are drawn from seed 0, the batch from 1.
    A train cell's ``run(stats, groups, micro, fill)`` takes
    ``sharded_grads``' ``groups`` and ``micro``, and ``fill(grads)`` sets
    the entries of the groups it did not differentiate before the sync."""
    from repro_torch.models import model as M
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt
    ok, _ = cell_applicable(cfg, shape)
    if not ok:
        return None
    info = SHAPES[shape]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    rules = _cell_rules(arch, kind, batch, mesh, extra_rules)
    meta = torch.device(device).type == "meta"
    model = _model(cfg, device, param_dtype)
    structure = M.Model(cfg, torch.device("meta"))
    specs = M.param_specs(cfg, rules)
    params = {k: place(p, specs[k], mesh)
              for k, p in model.named_parameters()}

    if kind == "train":
        dp = 1
        for a in axes_of(rules.rules.get("batch")):
            dp *= mesh.shape[a]
        while n_micro > 1 and (batch // n_micro) % max(dp, 1):
            n_micro //= 2
        named = dict(model.named_parameters())
        _, state, zspecs = train_loop.place_train_state(
            model, opt.init(named), rules)
        del named
        bspecs = train_batch_specs(cfg, seq, batch, device)
        data = bspecs if meta else _random_batch(cfg, bspecs, 1)
        placed = train_loop.place_batch(data, rules)
        adamw = opt.AdamWConfig()
        inputs = {"params": params, "state": state, "batch": placed}

        def run(stats: CollectiveStats, groups=None, micro=None, fill=None):
            with use_rules(rules):
                grads, metrics = train_loop.sharded_grads(
                    cfg, structure, inputs["params"], inputs["batch"],
                    rules, n_micro, stats, groups, micro)
                if fill is not None:
                    fill(grads)
                return train_loop.apply_grads(
                    adamw, grads, metrics, inputs["params"],
                    inputs["state"], zspecs, rules, stats)

        return Cell(arch, shape, "train", cfg, mesh, rules, inputs, run,
                    n_micro)

    if kind == "prefill":
        bspecs = prefill_batch_specs(cfg, seq, batch, device)
        data = bspecs if meta else _random_batch(cfg, bspecs, 1)
        placed = {k: place(v, sp, mesh) for (k, v), sp in zip(
            data.items(), batch_pspecs(cfg, data, rules).values())}
        inputs = {"params": params, "batch": placed}

        def run(stats: CollectiveStats, groups=None):
            with use_rules(rules):
                return M.sharded_prefill(structure, inputs["params"],
                                         inputs["batch"], seq, rules, stats,
                                         groups)

        return Cell(arch, shape, "prefill", cfg, mesh, rules, inputs, run)

    token, cache = decode_input_specs(cfg, seq, batch, device)
    if not meta:
        token = _random_batch(cfg, {"t": token}, 1)["t"]
    inputs = {"params": params,
              "token": place(token, rules.spec("batch", None), mesh),
              "cache": _place_tree(cache, cache_pspecs(cfg, rules,
                                                       cfg.enc_dec), mesh)}
    del token, cache

    def run(stats: CollectiveStats, groups=None):
        with use_rules(rules):
            return M.sharded_decode_step(structure, inputs["params"],
                                         inputs["token"], inputs["cache"],
                                         rules, stats, groups)

    return Cell(arch, shape, "decode", cfg, mesh, rules, inputs, run)


# ---------------------------------------------------------------------------
# The FCVI serving cell: the paper's technique on the production mesh
# ---------------------------------------------------------------------------

FCVI_SHAPES = {
    # 268M corpus vectors (SIFT-like d=128, m=8 filters), 1024-query batches
    "serve_268m": dict(n=1 << 28, d=128, m=8, batch=1024, k=100, kprime=400),
}
FCVI_VARIANTS = ("base", "bf16", "ivf8", "ivf8-trunc", "opt")
IVF_VARIANTS = ("ivf8", "ivf8-trunc", "opt")
NLIST, NPROBE = 64, 8        # an IVF shard's lists and the lists it probes
QUERY_CHUNK = 64             # the reference's query chunk (``qc``)
K_LOCAL = 64                 # ivf8-trunc / opt: candidates a block keeps


def ivf_sizes(n: int, shards: int, batch: int) -> tuple:
    """(rows a shard, rows a list) of the IVF layout. Raises where n does
    not split into ``shards`` blocks of ``NLIST`` equal lists, or the batch
    into the reference's query chunks (its scan drops the rest)."""
    if n % shards or (n // shards) % NLIST:
        raise ValueError(f"n={n} does not split into {shards} shards of "
                         f"{NLIST} equal lists")
    if batch % QUERY_CHUNK:
        raise ValueError(f"batch={batch} is not a multiple of the "
                         f"reference's query chunk {QUERY_CHUNK}")
    return n // shards, n // shards // NLIST


def _corpus_shards(mesh) -> tuple:
    """(the corpus axes, their extents, the number of row blocks)."""
    axes = tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)
    sizes = tuple(mesh.shape[a] for a in axes)
    return axes, sizes, int(np.prod(sizes)) if sizes else 1


def build_fcvi_cell(shape, mesh, extra_rules: Optional[dict] = None,
                    variant: str = "base", device="meta",
                    data: Optional[dict] = None) -> Cell:
    """The distributed FCVI query step: the psi transform of the queries,
    a top-k' over the corpus split in row blocks over every mesh axis, the
    tree merge over the axes (the last first), the lambda-weighted cosine
    re-rank of the candidates and its top-k.
    ``base``: an exact scan of the fp32 corpus (``index.distributed.
    sharded_search_fn``: B2 on each block), the candidates' rows gathered
    from the blocks holding them (an all-reduce of each block's hits);
    ``bf16``: the same over the transformed corpus stored in bf16 (re-rank
    rows stay fp32). The IVF layouts (the reference's shard-major slab,
    ``fcvi_inputs``): each block probes its ``NPROBE`` of ``NLIST`` lists
    and scans them with B7; ``ivf8`` keeps k' a block; ``ivf8-trunc``
    keeps its first ``K_LOCAL`` and every merge stage but the last keeps
    ``K_LOCAL``, the last k' padded (-inf, id 0) where its pool is
    smaller (the pads are re-ranked as row 0, as in the reference);
    ``opt`` is ``ivf8-trunc`` with the re-rank computed where the rows
    are (four (b, k') partials a block, summed by an all-reduce).
    ``shape``: a key of ``FCVI_SHAPES`` or a dict of its fields.
    ``data``: the inputs to place (default: meta stand-ins, or
    ``fcvi_inputs`` on another device). ``run`` returns the top-k (scores,
    ids) and the k' candidates' ids."""
    if variant not in FCVI_VARIANTS:
        raise ValueError(f"FCVI variant {variant!r}: the port builds "
                         f"{FCVI_VARIANTS}")
    info = FCVI_SHAPES[shape] if isinstance(shape, str) else dict(shape)
    n, d, m, batch = info["n"], info["d"], info["m"], info["batch"]
    rules = AxisRules(mesh, dict(extra_rules or {}))
    axes, _, shards = _corpus_shards(mesh)
    ivf = variant in IVF_VARIANTS
    if ivf:
        n_loc, list_sz = ivf_sizes(n, shards, batch)
    meta = torch.device(device).type == "meta"
    if data is None and not meta:
        data = fcvi_inputs(info, variant, device, 0, shards)
    if data is None and ivf:
        data = {"grouped": _empty((shards, NLIST, list_sz, d),
                                  torch.bfloat16, device),
                "grouped_sq": _empty((shards, NLIST, list_sz),
                                     torch.float32, device),
                "centroids": _empty((shards, NLIST, d), torch.float32,
                                    device)}
    elif data is None:
        dtype = torch.bfloat16 if variant == "bf16" else torch.float32
        data = {"corpus_t": _empty((n, d), dtype, device),
                "sq_norms": _empty((n,), torch.float32, device)}
    if meta and "q" not in data:
        data.update(vectors_n=_empty((n, d), torch.float32, device),
                    filters_n=_empty((n, m), torch.float32, device),
                    q=_empty((batch, d), torch.float32, device),
                    fq=_empty((batch, m), torch.float32, device))
    specs = {"corpus_t": (axes, None), "sq_norms": (axes,),
             "grouped": (axes, None, None, None),
             "grouped_sq": (axes, None, None), "centroids": (axes, None, None),
             "vectors_n": (axes, None), "filters_n": (axes, None),
             "q": (), "fq": ()}
    inputs = {name: place(t, specs[name], mesh) for name, t in data.items()}
    del data
    run = (_ivf_step if ivf else _flat_step)(info, variant, mesh, inputs)
    return Cell("fcvi", shape if isinstance(shape, str) else "custom",
                "fcvi_serve", None, mesh, rules, inputs, run)


def _cos(c: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    num = torch.sum(c * qv[:, None, :], dim=-1)
    den = (torch.linalg.norm(c, dim=-1)
           * torch.linalg.norm(qv, dim=-1)[:, None] + 1e-8)
    return num / den


def _rerank(x: dict, cand: torch.Tensor, k: int, axes, stats):
    """The candidates' rows gathered, the lambda = 0.5 cosine score, its
    first-occurrence top-k: (scores, ids)."""
    from repro_torch.kernels.ref import topk_first
    q, fq = (x[name].blocks.flat[0] for name in ("q", "fq"))
    cv, cf = gather_rows(x["vectors_n"], x["filters_n"], cand, axes, stats)
    score = 0.5 * _cos(cv, q) + 0.5 * _cos(cf, fq)
    vals, pos = topk_first(score, k)
    return vals, torch.gather(cand, -1, pos)


def _flat_step(info: dict, variant: str, mesh, inputs: dict):
    from repro_torch.core.transform import psi_partition
    from repro_torch.index.distributed import sharded_search_fn
    axes, _, _ = _corpus_shards(mesh)

    def run(stats: CollectiveStats):
        x = inputs
        search = sharded_search_fn(mesh, axes, info["kprime"], stats=stats)
        q, fq = (x[name].blocks.flat[0] for name in ("q", "fq"))
        q_t = psi_partition(q, fq, 1.0)
        if variant == "bf16":
            # the queries as the bf16 rows' scan takes them: rounded to
            # bf16 (the reference's cast), held in fp32
            q_t = q_t.to(torch.bfloat16).float()
        _, cand = search(x["corpus_t"], x["sq_norms"], q_t)
        return _rerank(x, cand, info["k"], axes, stats) + (cand,)

    return run


def _ivf_step(info: dict, variant: str, mesh, inputs: dict):
    """The IVF layouts' step (``build_fcvi_cell``): each block, under the
    scope of the positions holding it, takes its probes (the fp32 product
    of the transformed queries with its centroids, first-occurrence top
    ``NPROBE``) and runs B7 over its (NLIST, list_sz, d) bf16 slab with
    the queries rounded to bf16 (the reference's ``qs.astype(rows.dtype)``;
    B7 keeps the fp32 sum of the bf16 products, where the reference's
    bf16 einsum rounds it to bf16); slot ids become global
    (``shard * n_loc + list * list_sz + slot``), then the tree merge."""
    from repro_torch.core.transform import psi_partition
    from repro_torch.index.distributed import (_pool, _tree, holders_of,
                                               merge_stats, shard_coords)
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import topk_first
    axes, sizes, shards = _corpus_shards(mesh)
    b, kprime = info["batch"], info["kprime"]
    n_loc, list_sz = ivf_sizes(info["n"], shards, b)
    kl = K_LOCAL if variant in ("ivf8-trunc", "opt") else kprime
    holders = holders_of(mesh, axes)

    def run(stats: CollectiveStats):
        x = inputs
        q, fq = (x[name].blocks.flat[0] for name in ("q", "fq"))
        q_t = psi_partition(q, fq, 1.0)
        q_b = q_t.to(torch.bfloat16).float()
        vals, ids, valid = [], [], {}
        for s in range(shards):
            c = shard_coords(s, axes, sizes)
            with scope(holders[s]):
                gr = x["grouped"].block(c)[0]
                dev = gr.device
                if dev not in valid:
                    valid[dev] = torch.ones((NLIST, list_sz), device=dev)
                probes = topk_first(q_t.to(dev) @ x["centroids"].block(c)[0].T,
                                    NPROBE)[1].to(torch.int32)
                v, i = ops.ivf_score_topk_batch(
                    gr, x["grouped_sq"].block(c)[0], valid[dev], probes,
                    q_b.to(dev), kprime)
                vals.append(v[:, :kl].to(q.device))
                ids.append(i[:, :kl].to(q.device) + s * n_loc)
        if stats is not None:
            merge_stats(stats, mesh, axes, b, kl, kl)
        v, cand, _ = _tree(vals, ids, None, sizes, kprime, inner=kl)
        if v.shape[-1] < kprime:
            v, cand, _ = _pool([v], [cand], [], kprime)
        if variant != "opt":
            return _rerank(x, cand, info["k"], axes, stats) + (cand,)
        nv, dv, nf, df = rescore_partials(x["vectors_n"], x["filters_n"],
                                          cand, q, fq, axes, stats)
        qn = torch.linalg.norm(q, dim=-1)[:, None]
        fqn = torch.linalg.norm(fq, dim=-1)[:, None]
        score = (0.5 * nv / (dv * qn + 1e-8)
                 + (1 - 0.5) * nf / (df * fqn + 1e-8))
        top, pos = topk_first(score, info["k"])
        return top, torch.gather(cand, -1, pos), cand

    return run


def fcvi_inputs(info: dict, variant: str, device, seed: int,
                shards: int = 1) -> dict:
    """Random FCVI inputs on ``device``: unit-normalised rows and filters,
    queries with their filters, and the transformed corpus (psi of the
    rows with their filters): for ``base`` / ``bf16`` the rows (bf16
    stored for ``bf16``) and their squared norms; for the IVF layouts
    the reference's shard-major slab over ``shards`` row blocks
    (``ivf_layout``), with ``vectors_n`` / ``filters_n`` in its order."""
    from repro_torch.core.transform import psi_partition
    from repro_torch.device import resolve_device
    n, d, m, b = info["n"], info["d"], info["m"], info["batch"]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn((n, d), generator=gen, device=dev)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    f = torch.rand((n, m), generator=gen, device=dev)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)
    corpus = psi_partition(v, f, 1.0)
    q = torch.randn((b, d), generator=gen, device=dev)
    fq = torch.rand((b, m), generator=gen, device=dev)
    if variant in IVF_VARIANTS:
        ivf_sizes(n, shards, b)
        out = ivf_layout(corpus, shards, gen)
        order = out.pop("order")
        del corpus
        return dict(out, vectors_n=v[order], filters_n=f[order], q=q, fq=fq)
    if variant == "bf16":
        corpus = corpus.to(torch.bfloat16)
    sq = torch.sum(corpus.float() ** 2, dim=-1)
    return {"corpus_t": corpus, "sq_norms": sq, "vectors_n": v,
            "filters_n": f, "q": q, "fq": fq}


def ivf_layout(corpus: torch.Tensor, shards: int, gen) -> dict:
    """The IVF cells' shard-major layout of the transformed rows
    ``corpus`` (n, d) fp32: each of ``shards`` row blocks cut into
    ``NLIST`` equal lists, its rows sorted by their nearest of ``NLIST``
    centres drawn from its rows (ties to the first, the sort stable) and
    cut in order. Returns ``grouped`` (S, NLIST, list_sz, d) bf16,
    ``grouped_sq`` (S, NLIST, list_sz) fp32 (the bf16 rows' squared
    norms), ``centroids`` (S, NLIST, d) fp32 (each list's mean of its
    fp32 rows) and ``order`` (n,) int64, the rows in the slab's order (a
    global id ``shard * n_loc + list * list_sz + slot`` names row
    ``order[id]``)."""
    n, d = corpus.shape
    n_loc = n // shards
    list_sz = n_loc // NLIST
    grouped, sq, cen, order = [], [], [], []
    for s in range(shards):
        xs = corpus[s * n_loc:(s + 1) * n_loc]
        pick = torch.randperm(n_loc, generator=gen, device=xs.device)[:NLIST]
        centres = xs[pick]
        near = torch.argmax(2.0 * xs @ centres.T
                            - torch.sum(centres * centres, -1), dim=-1)
        perm = torch.sort(near, stable=True).indices
        rows = xs[perm].reshape(NLIST, list_sz, d)
        g = rows.to(torch.bfloat16)
        grouped.append(g)
        sq.append(torch.sum(g.float() ** 2, dim=-1))
        cen.append(rows.mean(dim=1))
        order.append(perm + s * n_loc)
    return {"grouped": torch.stack(grouped), "grouped_sq": torch.stack(sq),
            "centroids": torch.stack(cen), "order": torch.cat(order)}


def _held_rows(vectors, filters, cand: torch.Tensor, axes):
    """For each row block of ``vectors`` / ``filters`` (``Placed`` over
    ``axes``), in block order: the rows of the candidates ``cand`` (b, k')
    it holds, zeros for the others, yielded inside ``sharding.scope`` of
    the block's positions (the caller's work on them runs there too)."""
    mesh = vectors.mesh
    for coords, vb in vectors.unique():
        fb = filters.block(coords)
        lo = block_slices(mesh, vectors.spec, vectors.shape, coords)[0].start
        holders = [f for f, (_, c) in enumerate(positions(mesh))
                   if all(c[a] == coords[a] for a in axes)]
        with scope(holders):
            local = cand.to(vb.device) - lo
            own = (local >= 0) & (local < vb.shape[0])
            ix = local.clamp(0, vb.shape[0] - 1).long()
            yield (torch.where(own[..., None], vb[ix], 0.0),
                   torch.where(own[..., None], fb[ix], 0.0))


def _block_sum(parts: list) -> torch.Tensor:
    """The blocks' tensors summed in block order, as a collective's own
    arithmetic."""
    with quiet_ops():
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
    return total


def gather_rows(vectors, filters, cand: torch.Tensor, axes,
                stats: Optional[CollectiveStats] = None) -> tuple:
    """The rows of ``cand`` (b, k') ids from row blocks (``Placed`` over
    ``axes``): each block gathers the candidates it holds (zeros for the
    others) under ``sharding.scope`` of its positions, and the blocks'
    rows are summed (an all-reduce over ``axes``, at each position's
    (b, k', d + m) fp32). Equal to indexing the whole tables."""
    held = list(_held_rows(vectors, filters, cand, axes))
    if stats is not None:
        b, kp = cand.shape
        stats.add("all-reduce", ",".join(axes), vectors.mesh.size * b * kp
                  * 4 * (vectors.shape[1] + filters.shape[1]))
    return (_block_sum([cv for cv, _ in held]),
            _block_sum([cf for _, cf in held]))


def rescore_partials(vectors, filters, cand: torch.Tensor, q: torch.Tensor,
                     fq: torch.Tensor, axes,
                     stats: Optional[CollectiveStats] = None) -> tuple:
    """The compute-to-data re-rank's sums over the candidates ``cand``
    (b, k'): each row block (``Placed`` over ``axes``), under the scope of
    its positions, computes q.v, ||v||, fq.f and ||f|| of the candidates
    it holds (zeros for the others), and the blocks' partials are summed
    in block order (an all-reduce over ``axes`` of 4 (b, k') fp32 a
    position). Each sum is the holder's value exactly (x + 0 = x), so the
    scores equal ``gather_rows``' cosines."""
    parts = []
    for cv, cf in _held_rows(vectors, filters, cand, axes):
        qd, fd = q.to(cv.device), fq.to(cv.device)
        parts.append(torch.stack([
            torch.sum(cv * qd[:, None, :], dim=-1),
            torch.linalg.norm(cv, dim=-1),
            torch.sum(cf * fd[:, None, :], dim=-1),
            torch.linalg.norm(cf, dim=-1)]))
        del cv, cf
    if stats is not None:
        b, kp = cand.shape
        stats.add("all-reduce", ",".join(axes),
                  vectors.mesh.size * 4 * b * kp * 4)
    return tuple(_block_sum(parts))
