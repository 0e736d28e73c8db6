"""Logical-axis sharding rules, placement on a mesh, and the mesh's
collectives. Mirrors ``repro.distributed.sharding``.

``AxisRules`` maps a logical name to the mesh axes it shards over (or to
None, replicated): the model's names (``batch``, ``heads``, ``head_dim``,
``ff``, ``vocab``, ``experts``, ``rnn``, ...) and serving's (``corpus``,
``ivf_lists``). As in the reference, axes the mesh lacks are dropped
(``"pod"`` on a single-pod mesh), and an entry left with no axis
replicates. ``use_rules`` makes a set of rules current; ``param_spec_tree``
derives each parameter's spec from its leaf name in the reference's param
tree (``models.model.param_specs`` maps the port's parameter names to
it). A spec is a tuple with one entry a dimension (None, a mesh axis or a
tuple of axes): the counterpart of a ``PartitionSpec``.

The reference leaves placement and communication to XLA; here both are
explicit:

* ``place`` cuts a tensor into the block each position of a ``ShardMesh``
  holds under a spec (``Placed``), and ``join`` puts the blocks back
  together. A dimension split over a tuple of axes is cut in row-major
  order of their coordinates, the last axis fastest. Positions that hold
  the same block on the same device share one tensor.
* ``AxisGroup`` is the positions along one mesh axis, with the collectives
  a sharded step needs: sum (all-reduce), all-gather, reduce-scatter,
  all-to-all, and ``broadcast`` and ``split`` (a replicated value handed to
  each position, whole or cut). Each is a ``torch.autograd.Function``
  whose backward is its adjoint (sum <-> broadcast, all-gather <->
  reduce-scatter, split <-> all-gather, all-to-all <-> all-to-all back).
  Each records the bytes it moves into a ``CollectiveStats``, by kind and
  axis as ``repro.launch.hlo_analysis.collective_stats`` buckets a
  partitioned program's collectives: the operand bytes of every
  participant, summed over them (divide by the mesh's size for the bytes a
  position moves). A broadcast and a split move nothing forward, as a
  replicated value is already on every position.

A value that every position of a group holds alike is one tensor, on the
group's first device, and is computed once; a value the positions hold
differently is a list, one tensor a position on its device. On one card
every position is ``cuda:0`` and the collectives move nothing: they
count. A collective never falls back: mismatched shapes raise.

Which positions a tensor belongs to, for a cost trace
(``launch.cost_analysis``): ``place``/``from_blocks`` mark each block with
the positions holding it, a collective marks each position's output with
that position and runs its own arithmetic ``quiet`` (it is the
collective's, not the positions' compute), and ``scope`` names the
positions a batch group or a shard loop runs for. Outside a trace these
marks are read by nothing.
"""
from __future__ import annotations

import contextlib
import types
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

# the current rules, process-wide: the autograd engine runs a CUDA
# backward, and the recompute of a checkpointed block in it, on threads of
# its own, which must see them (the reference's rules are thread-local: JAX
# traces in the calling thread)
_state = types.SimpleNamespace(rules=None, scope=None, quiet=0)

# logical name -> mesh axis (or tuple of axes, or None = replicate)
DEFAULT_RULES = {
    "batch": ("pod", "data"),   # DP over pod x data
    "seq": None,                # replicated by default (TP keeps seq whole)
    "kv_seq": "model",          # decode KV caches: sequence-sharded
    "heads": "model",
    "kv_heads": None,           # few KV heads: replicate
    "embed": None,
    "head_dim": None,
    "ff": "model",
    "moe_ff": None,             # per-expert ff: unsharded under EP (experts
                                # take 'model'); granite overrides
    "vocab": "model",
    "experts": "model",         # EP
    "rnn": "model",
    "corpus": ("pod", "data"),  # FCVI corpus rows (flat/PQ slabs, rows)
    "ivf_lists": ("pod", "data"),  # FCVI IVF inverted lists (grouped slabs)
    "none": None,
}


class AxisRules:
    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        if mesh is not None:
            # drop axes the mesh does not have (e.g. "pod" on single-pod)
            have = set(mesh.axis_names)

            def fix(v):
                if v is None:
                    return None
                if isinstance(v, tuple):
                    kept = tuple(a for a in v if a in have)
                    return kept if kept else None
                return v if v in have else None

            self.rules = {k: fix(v) for k, v in self.rules.items()}

    def spec(self, *names: Optional[str]) -> Tuple:
        """The mesh axes of each dimension's logical name (None =
        replicated): the counterpart of a ``PartitionSpec``."""
        return tuple(self.rules.get(n or "none") for n in names)


def current_rules() -> Optional[AxisRules]:
    return _state.rules


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = _state.rules
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


@contextlib.contextmanager
def scope(positions):
    """Run with ``positions`` (flat row-major mesh indices) as the
    positions a value computed from no marked operand counts for."""
    prev = _state.scope
    _state.scope = frozenset(int(p) for p in positions)
    try:
        yield
    finally:
        _state.scope = prev


def current_scope():
    return _state.scope


def quiet() -> bool:
    """Whether a collective's own arithmetic is running."""
    return _state.quiet > 0


@contextlib.contextmanager
def quiet_ops():
    """Run a collective's own arithmetic (a cost trace counts its bytes as
    the collective's, not as the positions' compute)."""
    _state.quiet += 1
    try:
        yield
    finally:
        _state.quiet -= 1


def mark(t: Tensor, positions) -> Tensor:
    """Mark ``t`` as the value of ``positions`` (flat mesh indices)."""
    t._cost_pos = frozenset(int(p) for p in positions)
    return t


def marked(t: Tensor):
    """The positions ``t`` is marked with, or None."""
    return getattr(t, "_cost_pos", None)


def flat_index(mesh, coords: Dict[str, int]) -> int:
    """A position's flat row-major index (axes missing from ``coords``
    at 0)."""
    idx = 0
    for a in mesh.axis_names:
        idx = idx * mesh.shape[a] + int(coords.get(a, 0))
    return idx


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes: () for None, one for a name."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ---------------------------------------------------------------------------
# Parameter shardings by leaf path name
# ---------------------------------------------------------------------------

def _leaf_logical(path: str, ndim: int, scanned: bool) -> tuple:
    """Map a parameter leaf (by its path in the reference's param tree) to
    logical axis names, as the reference does. ``scanned`` leaves carry a
    leading stacked-periods dim (replicated)."""
    name = path.split("/")[-1]
    base: tuple
    if name in ("embedding",):
        base = ("vocab", "embed")
    elif name in ("wq",):
        base = ("embed", "heads", "head_dim")
    elif name in ("wk", "wv"):
        base = ("embed", "kv_heads", "head_dim")
    elif name in ("wo",):
        base = ("heads", "head_dim", "embed")
    elif name in ("w_in", "w_gate"):
        base = ("embed", "ff")
    elif name in ("w_out",):
        base = ("ff", "embed")
    elif name in ("we_in", "we_gate"):          # MoE expert weights
        base = ("experts", "embed", "moe_ff")
    elif name in ("we_out",):
        base = ("experts", "moe_ff", "embed")
    elif name in ("w_router",):
        base = ("embed", "experts")
    elif name in ("lm_head",):
        base = ("embed", "vocab")
    elif name in ("w_rnn_in", "w_rnn_gate"):    # RG-LRU input projections
        base = ("embed", "rnn")
    elif name in ("w_rnn_out",):
        base = ("rnn", "embed")
    elif name in ("w_gate_a", "w_gate_x"):      # RG-LRU recurrence gates:
        base = ("none", "rnn")                  # the output dim only
    elif name in ("conv_w",):                   # temporal conv (width, rnn)
        base = ("none", "rnn")
    elif name in ("wqkv_lstm",):                # xLSTM fused projections
        base = ("embed", "none", "heads", "head_dim")
    elif name in ("w_lstm_out",):
        base = ("heads", "head_dim", "embed")
    elif name in ("w_gates",):                  # xLSTM scalar gates
        base = ("embed", "none", "heads")
    else:
        base = tuple("none" for _ in range(ndim - (1 if scanned else 0)))
    if scanned:
        base = ("none",) + base
    # pad/trim against actual rank (bias vectors etc.)
    if len(base) != ndim:
        base = tuple("none" for _ in range(ndim))
    return base


def param_spec_tree(tree, rules: AxisRules):
    """The spec tree of a param tree in the reference's layout (nested
    dicts and lists whose leaves have ``ndim``; ``models.model.to_jax_tree``
    of the port's parameters, meta tensors will do), derived from each
    leaf's path as the reference derives it: a leaf under a ``scan`` stack
    has a leading periods dim, replicated."""

    def visit(path, node):
        if isinstance(node, dict):
            return {k: visit(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(path + (str(i),), v)
                              for i, v in enumerate(node))
        pstr = "/".join(path)
        return rules.spec(*_leaf_logical(pstr, node.ndim, "scan" in pstr))

    return visit((), tree)


# ---------------------------------------------------------------------------
# Placement: a tensor's blocks on the positions of a mesh
# ---------------------------------------------------------------------------

def _check_spec(spec: tuple, shape, mesh) -> tuple:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    seen = []
    for dim, entry in zip(shape, spec):
        axes = axes_of(entry)
        for a in axes:
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of "
                                 f"the mesh's {mesh.axis_names}")
        seen += axes
        n = int(np.prod([mesh.shape[a] for a in axes], dtype=np.int64))
        if dim % n:
            raise ValueError(f"dimension {dim} of shape {tuple(shape)} does "
                             f"not split over {axes} ({n} positions)")
    if len(set(seen)) != len(seen):
        raise ValueError(f"spec {spec} names an axis twice")
    return spec


def block_index(mesh, entry, coords: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of a position's block along one dimension split over
    ``entry``'s axes, row-major in their coordinates."""
    idx, count = 0, 1
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + coords[a]
        count *= mesh.shape[a]
    return idx, count


def block_slices(mesh, spec: tuple, shape, coords: Dict[str, int]) -> tuple:
    out = []
    for dim, entry in zip(shape, spec):
        idx, count = block_index(mesh, entry, coords)
        size = dim // count
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def positions(mesh):
    """Each mesh position's index tuple and coordinates, row-major."""
    for pos in np.ndindex(*mesh.devices.shape):
        yield pos, dict(zip(mesh.axis_names, pos))


class Placed:
    """A tensor of ``shape`` placed on ``mesh`` by ``spec``: ``blocks`` is
    an object array of the mesh's shape holding each position's block on
    its device (positions that hold the same block on one device share the
    tensor)."""

    def __init__(self, mesh, spec: tuple, shape, blocks: np.ndarray):
        self.mesh, self.spec, self.shape = mesh, spec, tuple(shape)
        self.blocks = blocks

    def block(self, coords: Dict[str, int]) -> Tensor:
        return self.blocks[tuple(coords.get(a, 0)
                                 for a in self.mesh.axis_names)]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.flat[0].dtype

    def unique(self) -> list:
        """Each distinct block tensor once, with the coordinates of the
        first position holding it."""
        seen, out = set(), []
        for pos, coords in positions(self.mesh):
            t = self.blocks[pos]
            if id(t) not in seen:
                seen.add(id(t))
                out.append((coords, t))
        return out

    def nbytes(self) -> int:
        """The bytes one position holds (every position holds as many)."""
        t = self.blocks.flat[0]
        return t.numel() * t.element_size()


def from_blocks(mesh, spec: tuple, shape, make) -> Placed:
    """A ``Placed`` whose block at each position is ``make(coords,
    device)``, called once for each distinct (block, device)."""
    spec = _check_spec(spec, shape, mesh)
    # each position's block index along every dimension, row-major over
    # the dimension's axes (vectorised over the mesh's positions)
    grid = np.indices(mesh.devices.shape).reshape(len(mesh.axis_names), -1)
    at = dict(zip(mesh.axis_names, grid))
    index = np.zeros((len(spec), mesh.size), dtype=np.int64)
    for i, e in enumerate(spec):
        for a in axes_of(e):
            index[i] = index[i] * mesh.shape[a] + at[a]
    devs = list(mesh.devices.flat)
    made, first, holders = {}, {}, {}
    keys = []
    for flat in range(mesh.size):
        key = (tuple(index[:, flat].tolist()), devs[flat])
        keys.append(key)
        if key not in first:
            first[key] = flat
            holders[key] = []
        holders[key].append(flat)
    for key, flat in first.items():
        coords = dict(zip(mesh.axis_names, grid[:, flat].tolist()))
        with scope(holders[key]):
            made[key] = mark(make(coords, key[1]), holders[key])
    blocks = np.empty(mesh.size, dtype=object)
    for flat, key in enumerate(keys):
        blocks[flat] = made[key]
    return Placed(mesh, spec, shape, blocks.reshape(mesh.devices.shape))


def place(x: Tensor, spec: tuple, mesh) -> Placed:
    """Cut ``x`` into each position's block under ``spec`` (the
    counterpart of ``device_put`` with a ``NamedSharding``). Raises where
    a dimension does not split over its axes."""
    x = x.detach()
    spec = _check_spec(spec, x.shape, mesh)
    return from_blocks(mesh, spec, x.shape, lambda coords, dev: x[
        block_slices(mesh, spec, x.shape, coords)].to(dev).contiguous())


def join(p: Placed, device=None) -> Tensor:
    """The tensor ``p`` holds, put together from its blocks on ``device``
    (default: the first position's)."""
    dev = device if device is not None else p.mesh.devices.flat[0]
    out = torch.empty(p.shape, dtype=p.dtype, device=dev)
    for coords, t in p.unique():
        out[block_slices(p.mesh, p.spec, p.shape, coords)] = t.to(dev)
    return out


# ---------------------------------------------------------------------------
# Collectives over one mesh axis
# ---------------------------------------------------------------------------

class CollectiveStats:
    """Bytes and counts of collectives, ``{kind: {"bytes", "count",
    "by_axis": {axis: bytes}}}`` with the reference's kinds
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``);
    bytes are the operand bytes of every participant, summed."""

    def __init__(self):
        self.by_kind: dict = {}

    def add(self, kind: str, axis: str, nbytes: int) -> None:
        rec = self.by_kind.setdefault(kind, {"bytes": 0, "count": 0,
                                             "by_axis": {}})
        rec["bytes"] += int(nbytes)
        rec["count"] += 1
        rec["by_axis"][axis] = rec["by_axis"].get(axis, 0) + int(nbytes)

    def merge(self, other: "CollectiveStats", times: int = 1) -> None:
        """Add ``other``'s records ``times`` over."""
        for kind, rec in other.by_kind.items():
            mine = self.by_kind.setdefault(kind, {"bytes": 0, "count": 0,
                                                  "by_axis": {}})
            mine["bytes"] += times * rec["bytes"]
            mine["count"] += times * rec["count"]
            for axis, b in rec["by_axis"].items():
                mine["by_axis"][axis] = mine["by_axis"].get(axis, 0) \
                    + times * b


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _to(x: Tensor, dev) -> Tensor:
    return x if x.device == dev else x.to(dev)


def _alias(x: Tensor, dev) -> Tensor:
    """``x`` on ``dev`` as a tensor of its own (each output of an autograd
    Function must be one)."""
    return x.view_as(x) if x.device == dev else x.to(dev)


def _sum(ts, dev) -> Tensor:
    """The sum of ``ts`` on ``dev`` in their order (fp32 stays fp32)."""
    out = _to(ts[0], dev)
    for t in ts[1:]:
        out = out + _to(t, dev)
    return out


def _collective(fn):
    """A collective's forward or backward: its arithmetic runs ``quiet``."""
    def run(ctx, *args):
        with quiet_ops():
            return fn(ctx, *args)
    return staticmethod(run)


def _own(group, m: int):
    """The scope member ``m``'s own output of a collective is made in: its
    positions, where a group's scope is open (a cost trace charges a
    collective's buffer to the scope it is made in, so a block each
    member keeps is not charged to every member)."""
    if group.positions is None or current_scope() is None:
        return contextlib.nullcontext()
    return scope(group.positions[m])


def _each(group, ts) -> tuple:
    """Each member's output, its own tensor marked with the member's
    positions."""
    out = tuple(_alias(t, d) for t, d in zip(ts, group.devices))
    if group.positions is not None:
        for t, p in zip(out, group.positions):
            mark(t, p)
    return out


class _Sum(torch.autograd.Function):
    @_collective
    def forward(ctx, group, *parts):
        ctx.group = group
        group.record("all-reduce", parts)
        return _sum(parts, group.home)

    @_collective
    def backward(ctx, g):
        return (None,) + _each(ctx.group, [g] * ctx.group.n)


class _Broadcast(torch.autograd.Function):
    @_collective
    def forward(ctx, group, x):
        ctx.group = group
        return _each(group, [x] * group.n)

    @_collective
    def backward(ctx, *gs):
        ctx.group.record("all-reduce", gs)
        return None, _sum(gs, ctx.group.home)


class _AllGather(torch.autograd.Function):
    @_collective
    def forward(ctx, group, dim, *parts):
        ctx.group, ctx.dim = group, dim
        ctx.sizes = [p.shape[dim] for p in parts]
        group.record("all-gather", parts)
        full = torch.cat([_to(p, group.home) for p in parts], dim)
        return _each(group, [full] * group.n)

    @_collective
    def backward(ctx, *gs):
        group = ctx.group
        group.record("reduce-scatter", gs)
        total = _sum(gs, group.home)
        return (None, None) + _each(group, total.split(ctx.sizes, ctx.dim))


class _ReduceScatter(torch.autograd.Function):
    @_collective
    def forward(ctx, group, dim, *parts):
        ctx.group, ctx.dim = group, dim
        group.record("reduce-scatter", parts)
        total = _sum(parts, group.home)
        out = []
        for m, b in enumerate(total.chunk(group.n, dim)):
            with _own(group, m):
                out.append(b.contiguous())
        return _each(group, out)

    @_collective
    def backward(ctx, *gs):
        group = ctx.group
        group.record("all-gather", gs)
        full = torch.cat([_to(g, group.home) for g in gs], ctx.dim)
        return (None, None) + _each(group, [full] * group.n)


def _exchange(group, parts, split_dim: int, concat_dim: int) -> tuple:
    n = group.n
    chunks = [p.chunk(n, split_dim) for p in parts]
    out = []
    for m, d in enumerate(group.devices):
        with _own(group, m):
            out.append(torch.cat([_to(chunks[j][m], d) for j in range(n)],
                                 concat_dim))
    return _each(group, out)


class _AllToAll(torch.autograd.Function):
    @_collective
    def forward(ctx, group, split_dim, concat_dim, *parts):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        group.record("all-to-all", parts)
        return _exchange(group, parts, split_dim, concat_dim)

    @_collective
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        ctx.group.record("all-to-all", gs)
        return (None, None, None) + _exchange(ctx.group, gs, concat_dim,
                                              split_dim)


class _Split(torch.autograd.Function):
    @_collective
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        out = []
        for m, b in enumerate(x.chunk(group.n, dim)):
            with _own(group, m):
                out.append(b.clone())
        return _each(group, out)

    @_collective
    def backward(ctx, *gs):
        group = ctx.group
        group.record("all-gather", gs)
        return None, None, torch.cat([_to(g, group.home) for g in gs],
                                     ctx.dim)


class Blocks(list):
    """A tensor split along ``dim`` over the ``AxisGroup`` ``group``: one
    block a position, in the group's order. A layer computing on blocks
    joins them with ``group``'s collectives."""

    def __init__(self, blocks, dim: int, group: "AxisGroup"):
        super().__init__(blocks)
        self.dim, self.group = dim, group


class AxisGroup:
    """The positions along one mesh axis, or a row-major product of axes
    (``axis``, the label the stats use: comma-joined), one device each in
    order: its collectives. With one position each is the identity and
    records nothing."""

    def __init__(self, devices: Sequence[torch.device], axis: str,
                 stats: Optional[CollectiveStats] = None,
                 positions: Optional[Sequence] = None):
        self.devices = list(devices)
        self.axis, self.stats = axis, stats
        self.n = len(self.devices)
        self.home = self.devices[0]
        # each member's flat mesh indices (its outputs' marks), where known:
        # the member's position, and the replicas running it alike
        self.positions = None if positions is None else [
            frozenset(p) for p in positions]

    def record(self, kind: str, ts) -> None:
        if self.stats is not None:
            self.stats.add(kind, self.axis,
                           _nbytes(t for t in ts if t is not None))

    def _check(self, parts, what: str) -> None:
        if len(parts) != self.n:
            raise ValueError(f"{what} over {self.axis!r} takes {self.n} "
                             f"blocks, got {len(parts)}")

    def psum(self, parts) -> Tensor:
        """All-reduce sum: the positions' tensors summed in order, one
        tensor on the first device (backward: the gradient handed to each
        position)."""
        self._check(parts, "psum")
        return parts[0] if self.n == 1 else _Sum.apply(self, *parts)

    def pmax(self, parts) -> Tensor:
        """All-reduce max, outside autograd (a softmax's shift)."""
        self._check(parts, "pmax")
        self.record("all-reduce", parts)
        with quiet_ops():
            out = _to(parts[0].detach(), self.home)
            for p in parts[1:]:
                out = torch.maximum(out, _to(p.detach(), self.home))
        return out

    def broadcast(self, x: Tensor) -> list:
        """A replicated value as each position's own (backward: the
        positions' gradients summed, an all-reduce)."""
        return [x] if self.n == 1 else list(_Broadcast.apply(self, x))

    def all_gather(self, parts, dim: int) -> list:
        """Each position's copy of the blocks joined along ``dim``
        (backward: a reduce-scatter). A replicated consumer takes
        ``gathered``."""
        self._check(parts, "all_gather")
        return list(parts) if self.n == 1 else list(
            _AllGather.apply(self, dim, *parts))

    def gathered(self, parts, dim: int) -> Tensor:
        """The blocks joined along ``dim`` as one value the group holds
        replicated, computed on by every member: ``all_gather``'s first
        copy, marked as every member's."""
        out = self.all_gather(parts, dim)[0]
        if self.positions is not None and self.n > 1:
            mark(out, frozenset().union(*self.positions))
        return out

    def reduce_scatter(self, parts, dim: int) -> Blocks:
        """The sum of equal-shaped tensors, each position keeping its
        block of ``dim`` (backward: an all-gather)."""
        self._check(parts, "reduce_scatter")
        if self.n == 1:
            return Blocks(parts, dim, self)
        return Blocks(_ReduceScatter.apply(self, dim, *parts), dim, self)

    def all_to_all(self, parts, split_dim: int, concat_dim: int) -> Blocks:
        """Blocks split along ``split_dim`` become blocks joined along
        ``concat_dim``: position m gets every position's m-th piece, in
        position order (backward: the exchange back)."""
        self._check(parts, "all_to_all")
        for p in parts:
            if p.shape[split_dim] % self.n:
                raise ValueError(f"dimension {split_dim} of {tuple(p.shape)}"
                                 f" does not split over {self.n} positions")
        if self.n == 1:
            return Blocks(parts, split_dim, self)
        return Blocks(_AllToAll.apply(self, split_dim, concat_dim, *parts),
                      split_dim, self)

    def split(self, x: Tensor, dim: int) -> Blocks:
        """A replicated value cut along ``dim``, each position keeping its
        block (backward: an all-gather)."""
        if x.shape[dim] % self.n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {self.n} positions")
        if self.n == 1:
            return Blocks([x], dim, self)
        return Blocks(_Split.apply(self, dim, x), dim, self)


def mesh_group(mesh, axis, coords: Dict[str, int],
               stats: Optional[CollectiveStats] = None) -> AxisGroup:
    """The positions along ``axis`` (a mesh axis or a tuple of them,
    row-major) at ``coords`` on the other axes. A mesh axis in neither
    ``axis`` nor ``coords`` is a replica axis: each member stands for its
    positions along it too, which run the member's program alike."""
    axes = axes_of(axis)
    members = [{**coords, **dict(zip(axes, idx))} for idx in
               np.ndindex(*[mesh.shape[a] for a in axes])]
    held: list = [[] for _ in members]
    for flat, (_, c) in enumerate(positions(mesh)):
        for i, m in enumerate(members):
            if all(c[a] == v for a, v in m.items()):
                held[i].append(flat)
    group = AxisGroup([mesh.device_at(c) for c in members], ",".join(axes),
                      stats, held)
    group.member_coords = members
    return group


def group_of(module) -> Optional[AxisGroup]:
    """The tensor-parallel ``AxisGroup`` a sharded step runs ``module``
    over (``tp_group`` of a ``models.model.ShardGroup``'s view of it), or
    None for a module run whole."""
    return getattr(module, "tp_group", None)
