"""Train-step factory: loss -> grad -> AdamW, with microbatch accumulation.
Mirrors ``repro.train.loop``.

Unsharded, the params live in the model: a step computes the gradients
of ``lm_loss`` with ``torch.autograd.grad`` (nothing is kept in ``.grad``),
runs ``optimizer.update`` and writes the new params into the model under
``torch.no_grad``. With ``n_micro`` > 1 the batch's rows split into
``n_micro`` equal microbatches, run one after another (activation memory
/ n_micro), and the fp32 gradients and the loss accumulate ``/ n_micro``
in the reference's order.

Sharded: as in the reference, the same step runs sharded when its params,
optimizer state and batch come placed on a mesh (``place_train_state``,
``place_batch``) and it is called under ``use_rules(rules)`` of that mesh.
The rules' batch axes split the batch; each block of it (a batch group)
runs the model over the positions that share it, one along the mesh's
tensor-parallel axis each, as ``models.model.ShardGroup`` says. Each
position's gradients are then reduced over the batch axes by
``cross_pod_grad_sync``: an fp32 sum within a pod and, where the mesh has
a ``pod`` axis, int8 across pods. ``grad_shardings`` (``launch.specs.zero1_specs``
of the param specs) lays the gradients out as ZeRO-1 does: the within-pod
sum is a reduce-scatter to that layout. ``optimizer.update`` runs on each
position's shard of the gradients, mu, nu and master with the global
gradient norm, and the new params are all-gathered to their specs. The
loss is the global batch's mean: each group's NLL sum over the global
count of masked tokens. Microbatch i holds the global batch's rows [i b /
n_micro, (i + 1) b / n_micro), split over the groups as the batch is; a
group whose rows another holds receives them (an all-to-all). The metrics
add ``collectives``: the step's collective bytes by kind and axis
(``CollectiveStats``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.compression import cross_pod_grad_sync
from repro_torch.distributed.sharding import (AxisRules, CollectiveStats,
                                              Placed, axes_of, block_slices,
                                              current_rules, from_blocks,
                                              join, mark, place, positions,
                                              quiet_ops, scope)
from repro_torch.launch.mesh import ShardMesh
from repro_torch.launch.specs import zero1_specs
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt


def make_loss_fn(cfg):
    def loss_fn(model, batch):
        return M.lm_loss(model, batch)
    return loss_fn


def _grads(loss_fn, model, batch):
    """((loss, metrics), {name: grad}) of ``loss_fn`` at the model's
    params."""
    named = dict(model.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), dict(zip(named, grads))


def make_train_step(cfg, adamw: opt.AdamWConfig, n_micro: int = 1,
                    grad_shardings: Optional[dict] = None):
    """``train_step(params, opt_state, batch) -> (params, new_opt_state,
    metrics)``. Unsharded, ``params`` is the model, whose params are
    replaced by the step's new params, and ``batch`` numpy arrays or
    tensors, the batch axis first. Sharded (module docstring), ``params``
    is ``{name: Placed}``, the state's leaves too, and ``batch``
    ``place_batch``'s; ``grad_shardings``: ``{name: spec}``."""
    loss_fn = make_loss_fn(cfg)
    structure = M.Model(cfg, torch.device("meta"))

    def train_step(params, opt_state, batch):
        if isinstance(params, dict):
            return _sharded_step(cfg, structure, adamw, n_micro,
                                 grad_shardings, params, opt_state,
                                 batch)
        if grad_shardings is not None:
            raise ValueError("grad_shardings lays out a sharded step's "
                             "gradients: place the params on a mesh")
        model = params
        if n_micro <= 1:
            (_, metrics), grads = _grads(loss_fn, model, batch)
        else:
            def split(x, i):
                x = torch.as_tensor(x)
                b = x.shape[0]
                return x.reshape(n_micro, b // n_micro, *x.shape[1:])[i]

            grads, loss = None, 0.0
            for i in range(n_micro):
                mb = {k: split(v, i) for k, v in batch.items()}
                (mloss, _), g = _grads(loss_fn, model, mb)
                if grads is None:
                    grads = {k: torch.zeros(v.shape, dtype=torch.float32,
                                            device=v.device)
                             for k, v in g.items()}
                grads = {k: grads[k] + g[k].float() / n_micro for k in g}
                loss = loss + mloss / n_micro
            metrics = {"loss": loss}

        params = dict(model.named_parameters())
        new_params, new_opt, opt_metrics = opt.update(adamw, grads,
                                                      opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_params[k])
        return model, new_opt, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg):
    loss_fn = make_loss_fn(cfg)

    @torch.no_grad()
    def eval_step(model, batch):
        _, metrics = loss_fn(model, batch)
        return metrics

    return eval_step


# ---------------------------------------------------------------------------
# Placement of the train state and the batch
# ---------------------------------------------------------------------------

def place_train_state(model, state: opt.AdamWState, rules: AxisRules,
                      zero1: bool = True) -> tuple:
    """``(params, state, grad_shardings)`` placed on ``rules.mesh``: each
    param by ``models.model.param_specs``, mu, nu and master by
    ``zero1_specs`` of those (``zero1=False``: by the param specs, and
    ``grad_shardings`` None); the step counter stays one tensor."""
    mesh = rules.mesh
    specs = M.param_specs(model.cfg, rules)
    named = dict(model.named_parameters())
    zspecs = zero1_specs(named, specs, rules) if zero1 else specs

    def put(tree, sp):
        return {k: place(v, sp[k], mesh) for k, v in tree.items()}

    placed = opt.AdamWState(step=state.step, mu=put(state.mu, zspecs),
                            nu=put(state.nu, zspecs),
                            master=put(state.master, zspecs))
    return put(named, specs), placed, zspecs if zero1 else None


def place_batch(batch: dict, rules: AxisRules, device=None) -> dict:
    """The batch's arrays placed on ``rules.mesh``, their rows split over
    the batch axes (``rules.spec("batch", None, ...)``)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        spec = rules.spec("batch", *([None] * (t.ndim - 1)))
        out[k] = place(t if device is None else t.to(device), spec,
                       rules.mesh)
    return out


def gather_train_state(params: dict, state: opt.AdamWState, cfg,
                       device=None) -> tuple:
    """The inverse of ``place_train_state``: a model holding the joined
    params on ``device`` and the state's joined leaves (a sharded run's
    checkpoint is an unsharded run's: ``launch.train.save_train``)."""
    first = next(iter(params.values()))
    dev = device if device is not None else first.mesh.devices.flat[0]
    model = M.Model(cfg, torch.device("meta")).to_empty(device=dev)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(join(params[k], dev))

    def joined(tree):
        return {k: join(v, dev) for k, v in tree.items()}

    return model, opt.AdamWState(step=state.step.to(dev),
                                 mu=joined(state.mu), nu=joined(state.nu),
                                 master=joined(state.master))


def per_position_bytes(tree: dict) -> int:
    """The bytes one position holds of placed leaves."""
    return sum(p.nbytes() for p in tree.values())


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def _batch_axes(rules: AxisRules) -> tuple:
    return axes_of(rules.rules.get("batch"))


batch_groups = M.batch_groups


def _rows(batch: dict, groups: list, g: int, i: int, n_micro: int,
          shard: M.ShardGroup, rules: AxisRules,
          stats: CollectiveStats) -> dict:
    """Group ``g``'s rows of microbatch ``i`` on ``shard``'s home device,
    from the group holding them (rows another group holds arrive by an
    all-to-all, and are then the value of ``shard``'s positions)."""
    out = {}
    n_groups = len(groups)
    for k, p in batch.items():
        rows = p.shape[0]
        if rows % (n_micro * n_groups):
            raise ValueError(f"batch {k!r} of {rows} rows does not split "
                             f"into {n_micro} microbatches over "
                             f"{n_groups} batch groups")
        per, held = rows // (n_micro * n_groups), rows // n_groups
        start = i * (rows // n_micro) + g * per
        holder = start // held
        t = p.block(groups[holder])[start - holder * held:
                                    start - holder * held + per]
        t = t.to(shard.home)
        if holder != g:
            stats.add("all-to-all", ",".join(_batch_axes(rules)),
                      t.numel() * t.element_size())
            t = mark(t, shard.positions)
        out[k] = t
    return out


def sharded_grads(cfg, structure, params: dict, batch: dict,
                  rules: AxisRules, n_micro: int, stats: CollectiveStats,
                  groups: Optional[list] = None,
                  micro: Optional[list] = None) -> tuple:
    """Each batch group's gradients (``ShardGroup.grads``, accumulated
    ``/ n_micro`` in fp32 over microbatches) and the loss metrics. Each
    group runs under ``sharding.scope`` of its positions; the profiler
    ranges ``"microbatch i"`` (a microbatch's work once its rows arrive)
    and ``"batch group g"`` (a group's forward and backward) name the
    parts.

    ``groups``: the indices of the batch groups to differentiate (default
    all; the others' entries are None); ``micro``: the microbatches to run
    (default all): a partial accumulation, as a cost trace runs one group's
    first microbatches to stand for the rest."""
    shard_coords = batch_groups(rules)
    axes = ",".join(_batch_axes(rules))
    run = set(range(len(shard_coords)) if groups is None else groups)
    grads = [None] * len(shard_coords)
    loss = nll_all = logz_all = denom = None
    for i in (range(n_micro) if micro is None else micro):
        shards = [M.ShardGroup(rules.mesh, rules, c, params, stats)
                  for c in shard_coords]
        mbs = [_rows(batch, shard_coords, g, i, n_micro, s, rules, stats)
               for g, s in enumerate(shards)]
        home = shards[0].home
        with torch.profiler.record_function(f"microbatch {i}"):
            counts = []
            for s, mb in zip(shards, mbs):
                with scope(s.positions):
                    counts.append(M.loss_tokens(s.view(structure), mb))
            # the cross-group sums are the all-reduces' own arithmetic
            stats.add("all-reduce", axes, 4 * len(counts))
            with quiet_ops():
                denom = torch.clamp_min(sum(c.to(home) for c in counts),
                                        1.0)
            nll_all = logz_all = 0.0
            for g, (s, mb) in enumerate(zip(shards, mbs)):
                if g not in run:
                    continue
                with torch.profiler.record_function(f"batch group {g}"), \
                        scope(s.positions), torch.enable_grad():
                    nll, logz, _ = M.loss_sums(s.view(structure), mb)
                    gs = s.grads(nll / denom.to(s.home))
                with quiet_ops():
                    nll_all = nll_all + nll.detach().to(home)
                    logz_all = logz_all + logz.detach().to(home)
                if n_micro > 1:
                    with scope(s.positions):
                        gs = {k: [t.float() / n_micro for t in v]
                              for k, v in gs.items()}
                        if grads[g] is not None:
                            gs = {k: [a + b for a, b in zip(grads[g][k], v)]
                                  for k, v in gs.items()}
                grads[g] = gs
            stats.add("all-reduce", axes, 8 * len(shard_coords))
            mloss = nll_all / denom
            loss = mloss if n_micro <= 1 else (
                (0.0 if loss is None else loss) + mloss / n_micro)
    if n_micro > 1:
        return grads, {"loss": loss}
    return grads, {"loss": loss, "ppl_log": loss, "tokens": denom,
                   "logz_mean": logz_all / denom}


def _submesh(mesh: ShardMesh, rules: AxisRules, tp_axis, t: int):
    """The batch axes' positions at tensor-parallel index ``t``."""
    axes = _batch_axes(rules)
    shape = tuple(mesh.shape[a] for a in axes)
    devs = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        coords = dict(zip(axes, idx))
        if tp_axis is not None:
            coords[tp_axis] = t
        devs[idx] = mesh.device_at(coords)
    return ShardMesh(devices=devs, axis_names=axes)


def sync_grads(grads: list, params: dict, rules: AxisRules,
               grad_specs: Optional[dict], gen: torch.Generator,
               int8: bool, stats: CollectiveStats) -> dict:
    """The groups' gradients reduced over the batch axes
    (``cross_pod_grad_sync``; ``int8``: the pod hop's codes, as the step
    syncs, else an fp32 sum there too, as the reference's step sums) and
    laid out by ``grad_specs`` (default: the param specs): ``{name:
    Placed}``."""
    mesh = rules.mesh
    axes = _batch_axes(rules)
    groups = batch_groups(rules)
    tp_axis = next((a for a in mesh.axis_names if a not in axes), None)
    n_tp = mesh.shape[tp_axis] if tp_axis else 1
    inner = [a for a in axes if a != "pod"]
    out = {}
    for name, p in params.items():
        zspec = grad_specs[name] if grad_specs else p.spec
        extra = [i for i, (a, b) in enumerate(zip(p.spec, zspec)) if a != b]
        if extra and (len(extra) > 1 or p.spec[extra[0]] is not None
                      or not set(axes_of(zspec[extra[0]])) <= set(inner)):
            raise ValueError(f"{name}: gradient spec {zspec} is its param "
                             f"spec {p.spec} with one more dimension split "
                             f"over axes of {inner}, or the same")
        # the within-pod sum is a reduce-scatter where the extra dimension
        # splits over every inner batch axis; over fewer of them (a batch
        # over data x model, ZeRO-1 over its last axis) an all-reduce, each
        # position then keeping its block
        dim = (extra[0] if extra and axes_of(zspec[extra[0]]) == tuple(inner)
               else None)
        fsdp = [i for i, e in enumerate(p.spec)
                if axes_of(e) and tp_axis not in axes_of(e)]
        if extra and dim is None:
            fsdp = fsdp + extra
        per_t = len(grads[0][name])
        synced = []
        for t in range(per_t):
            sub = _submesh(mesh, rules, tp_axis, t)
            blocks = np.empty(sub.devices.shape, dtype=object)
            for pos, coords in positions(sub):
                blocks[pos] = grads[groups.index(coords)][name][t]
            # a param the tensor-parallel axis does not split syncs once
            # for all its positions; each would sync its own copy
            once = CollectiveStats()
            sync = cross_pod_grad_sync(sub, "pod", once, int8=int8)
            synced.append(sync(blocks, gen, dim))
            stats.merge(once, times=n_tp if per_t == 1 else 1)

        def make(coords, dev, synced=synced, p=p, zspec=zspec, fsdp=fsdp):
            t = coords[tp_axis] if (tp_axis and per_t > 1) else 0
            g = synced[t][tuple(coords[a] for a in axes)]
            if fsdp:
                sl = block_slices(mesh, zspec, p.shape, coords)
                g = g[tuple(sl[i] if i in fsdp else slice(None)
                            for i in range(len(p.shape)))]
            return g.to(dev).contiguous()

        out[name] = from_blocks(mesh, zspec, p.shape, make)
    return out


def sharded_update(adamw: opt.AdamWConfig, grads: dict,
                   state: opt.AdamWState, params: dict,
                   stats: CollectiveStats) -> tuple:
    """``optimizer.update`` on each position's shard (the gradients' and
    the state's layout), with the global gradient norm; the new params
    all-gathered to their specs. Returns (params, state, metrics)."""
    mesh = next(iter(params.values())).mesh
    home = mesh.devices.flat[0]
    for name, g in grads.items():
        for tree in (state.mu, state.nu, state.master):
            if tree[name].spec != g.spec:
                raise ValueError(f"{name}: the optimizer state is placed by "
                                 f"{tree[name].spec}, its gradient by "
                                 f"{g.spec} (grad_shardings)")
    sums = []
    for g in grads.values():
        leaf = None
        for _, t in _distinct_blocks(g):
            part = torch.sum(torch.square(t.float())).to(home)
            leaf = part if leaf is None else leaf + part
        sums.append(leaf)
    stats.add("all-reduce", ",".join(mesh.axis_names),
              4 * len(sums) * mesh.size)
    gnorm = torch.sqrt(sum(sums))
    by_dev: dict = {}
    for name, g in grads.items():
        for coords, t in g.unique():
            key = (name, id(t))
            dev = t.device
            d = by_dev.setdefault(dev, ({}, {}, {}, {}, {}))
            d[0][key] = t
            for j, tree in enumerate((state.mu, state.nu, state.master)):
                d[j + 1][key] = tree[name].block(coords)
            d[4][key] = torch.empty(0, dtype=params[name].dtype, device=dev)
    new: dict = {}
    metrics = None
    new_step = None
    for dev, (g, mu, nu, master, dtypes) in by_dev.items():
        st = opt.AdamWState(step=state.step.to(dev), mu=mu, nu=nu,
                            master=master)
        p_new, s_new, m = opt.update(adamw, g, st, dtypes,
                                     gnorm=gnorm.to(dev))
        for key in g:
            new[key] = (p_new[key], s_new.mu[key], s_new.nu[key],
                        s_new.master[key])
        if dev == home or metrics is None:
            metrics, new_step = m, s_new.step.to(home)

    def relaid(name, j):
        g = grads[name]
        return from_blocks(mesh, g.spec, g.shape, lambda coords, dev: new[
            (name, id(g.block(coords)))][j].to(dev))

    new_state = opt.AdamWState(
        step=new_step, mu={k: relaid(k, 1) for k in grads},
        nu={k: relaid(k, 2) for k in grads},
        master={k: relaid(k, 3) for k in grads})
    new_params = {}
    for name, p in params.items():
        cast = relaid(name, 0)
        if cast.spec == p.spec:
            new_params[name] = cast
            continue
        dim = next(i for i, (a, b) in enumerate(zip(p.spec, cast.spec))
                   if a != b)
        axes = axes_of(cast.spec[dim])
        stats.add("all-gather", ",".join(axes), mesh.size * cast.nbytes())

        def make(coords, dev, cast=cast, dim=dim, axes=axes):
            parts = []
            for idx in np.ndindex(*[mesh.shape[a] for a in axes]):
                parts.append(cast.block({**coords,
                                         **dict(zip(axes, idx))}).to(dev))
            return torch.cat(parts, dim)

        new_params[name] = from_blocks(mesh, p.spec, p.shape, make)
    return new_params, new_state, {"grad_norm": metrics["grad_norm"].to(
        home), "lr": metrics["lr"].to(home)}


def _distinct_blocks(p: Placed) -> list:
    """Each block of ``p`` once, whichever device holds it."""
    seen, out = set(), []
    for coords, t in p.unique():
        key = tuple((s.start, s.stop) for s in
                    block_slices(p.mesh, p.spec, p.shape, coords))
        if key not in seen:
            seen.add(key)
            out.append((coords, t))
    return out


def pod_generator(home: torch.device, step) -> Optional[torch.Generator]:
    """The int8 pod hop's noise generator, seeded with the step; None on
    the meta device (a cost trace: no values, so no noise)."""
    if home.type == "meta":
        return None
    return torch.Generator(device=home).manual_seed(int(step))


def _sharded_step(cfg, structure, adamw, n_micro, grad_specs, params,
                  state, batch):
    rules = current_rules()
    mesh = next(iter(params.values())).mesh
    if rules is None or rules.mesh is not mesh:
        raise ValueError("a placed step runs under use_rules(AxisRules) of "
                         "its params' mesh")
    stats = CollectiveStats()
    grads, metrics = sharded_grads(cfg, structure, params, batch, rules,
                                   n_micro, stats)
    return apply_grads(adamw, grads, metrics, params, state, grad_specs,
                       rules, stats)


def apply_grads(adamw, grads: list, metrics: dict, params: dict, state,
                grad_specs: Optional[dict], rules: AxisRules,
                stats: CollectiveStats) -> tuple:
    """The sharded step after ``sharded_grads``: the groups' gradients
    synced (the pod hop at int8) and the ZeRO-1 update. ``grads`` is
    emptied once synced, so that its memory goes before the update.
    Returns (params, state, metrics with the step's ``collectives``)."""
    home = rules.mesh.devices.flat[0]
    gen = pod_generator(home, state.step)
    synced = sync_grads(grads, params, rules, grad_specs, gen, True, stats)
    grads.clear()
    new_params, new_state, opt_metrics = sharded_update(
        adamw, synced, state, params, stats)
    return new_params, new_state, {**metrics, **opt_metrics,
                                   "collectives": stats.by_kind}
