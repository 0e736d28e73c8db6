"""Per-position cost accounting of the port's steps, and the H100's roofline.
The counterpart of ``repro.launch.hlo_analysis``.

The reference compiles a cell ahead of time and reads the partitioned HLO
text: dot FLOPs, bytes at fusion boundaries and collective bytes per
device. PyTorch has no such text. Here the step itself runs on the meta
device (shapes and dtypes, no allocation) under ``CostMode``, a
``TorchDispatchMode`` that counts while the trace runs:

* **dot FLOPs**: ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and attention,
  through ``torch.utils.flop_counter``'s registry (the counterpart of
  ``HloCost``'s ``dot`` FLOPs); convolutions apart (``conv_flops``: the
  reference counts only ``dot``);
* **op-boundary bytes**: each op reads its operands and writes its
  results; views are free, as ``hlo_analysis.FREE_OPS`` are. This is eager
  PyTorch's real traffic, not the reference's (``dryrun.py`` takes XLA's
  ``memory_analysis`` there, over fused ops);
* **live bytes**: storages made minus storages freed, their peak;
* **kernel calls**: an entry of ``kernels/ops.py`` reached on meta
  records its kernel's own work from the shapes (``record_kernel``), not
  the plain version's ops.

Collective bytes are not traced: the sharded code records them into a
``distributed.sharding.CollectiveStats`` as it runs, by kind and axis
(``collective_summary`` adds the reference's ``by_group_size``).

**Positions.** One process runs every mesh position back to back, so each
op is attributed as SPMD would run it (``distributed.sharding``'s marks):
an op counts for the positions its operands are marked with (a block of a
``Placed`` tensor, a position's output of a collective, and whatever is
computed from them), and an op on unmarked values for every position of
the current ``sharding.scope`` (a batch group: a value the group holds as
one tensor, computed once on its first device, is computed on each of its
positions under SPMD). An op whose operands belong to disjoint positions
joins blocks, which only a collective does: it counts nothing (its bytes
are the collective's), as does a collective's own arithmetic
(``sharding.quiet``). A fill (``zeros``, ``full``, ``arange``) is charged
to the positions of the first op that reads it.

Each count has two readings: per position (arrays over the mesh's flat
positions; a "per-device" figure is the largest) and as executed (each op
once, as the one process ran it: what ``FlopCounterMode`` and
``torch.cuda.max_memory_allocated`` see of the same run).

**Profiler ranges.** The code names parts of a step with
``torch.profiler.record_function``, which reaches the mode as an op of
the ``profiler`` namespace (free). ``weights`` counts the ops (and, read
through ``weight``, the collectives) inside a named range several times
over: ``train.loop.sharded_grads``' ``"microbatch 1"`` standing for every
later microbatch. With ``segments`` on, the ranges ``"layer i"`` and
``"encoder layer i"`` (the model's loops over its layers) cut the live
bytes into segments, each with its rise above its start and its net
change: what ``launch.dryrun`` replays to find a deeper model's peak.

Ops with the same function and argument metadata repeat often (the
chunked attention's blocks, the layers); their output metadata is cached,
so a repeat makes its outputs with ``empty_strided`` instead of running
the meta kernel again.
"""
from __future__ import annotations

import re
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding as S

# ---------------------------------------------------------------------------
# The card (NVIDIA H100 SXM5 data sheet), as measured with: NVIDIA H100 80GB
# HBM3 at a 700 W power limit
# ---------------------------------------------------------------------------

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700
PEAK_BF16_S = 989e12         # dense bf16 on the tensor cores, FLOP/s
PEAK_TF32_S = 495e12         # dense TF32 on the tensor cores
PEAK_FP32_S = 67e12          # fp32 SIMT
PEAK_BYTES_S = 3.35e12       # HBM3, bytes/s
DEVICE_BYTES = 80e9          # HBM a card
NVLINK_BYTES_S = 450e9       # NVLink 4, one direction, inside a node
IB_BYTES_S = 50e9            # NDR InfiniBand 400 Gb/s a card, across nodes
NODE = 8                     # cards a node: 8 consecutive mesh positions


def axis_rate(mesh, axes: str) -> float:
    """The link rate of a collective over ``axes`` (comma-joined mesh
    axes): NVLink where every group of positions along them lies inside
    one node of ``NODE`` consecutive flat positions, else InfiniBand."""
    names = [a for a in axes.split(",") if a]
    if not names or mesh is None:
        return NVLINK_BYTES_S
    node = {}
    for flat, (_, coords) in enumerate(S.positions(mesh)):
        key = tuple(coords[a] for a in mesh.axis_names if a not in names)
        node.setdefault(key, set()).add(flat // NODE)
    return NVLINK_BYTES_S if all(len(v) == 1 for v in node.values()) \
        else IB_BYTES_S


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   coll_bytes_by_axis: Dict[str, float], mesh=None,
                   peak: float = PEAK_BF16_S) -> dict:
    """Seconds a step for each roofline term, from per-device quantities:
    FLOPs at ``peak``, bytes at the HBM rate, and each axis's collective
    bytes at its link's rate (``axis_rate``; NVLink without a mesh)."""
    compute_s = per_device_flops / peak
    memory_s = per_device_bytes / PEAK_BYTES_S
    collective_s = sum(b / axis_rate(mesh, a)
                       for a, b in coll_bytes_by_axis.items())
    dominant = max([("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)], key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "step_lower_bound_s": max(compute_s, memory_s, collective_s)}


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6 N D for training, 2 N D for a forward-only serving step."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def collective_summary(stats: S.CollectiveStats, mesh) -> dict:
    """``stats``' records with the reference's ``by_group_size`` buckets
    (the positions of one group: the product of the axes' extents).
    Bytes are summed over every participant, as recorded."""
    out = {}
    for kind, rec in stats.by_kind.items():
        sizes: dict = {}
        for axes, b in rec["by_axis"].items():
            n = 1
            for a in axes.split(","):
                n *= mesh.shape.get(a, 1)
            sizes[str(n)] = sizes.get(str(n), 0) + b
        out[kind] = {"bytes": rec["bytes"], "count": rec["count"],
                     "by_axis": dict(rec["by_axis"]),
                     "by_group_size": sizes}
    return out


def by_axis(stats: S.CollectiveStats) -> dict:
    """Collective bytes by axis over every kind (summed over
    participants)."""
    out: dict = {}
    for rec in stats.by_kind.values():
        for a, b in rec["by_axis"].items():
            out[a] = out.get(a, 0) + b
    return out


# ---------------------------------------------------------------------------
# The dispatch mode
# ---------------------------------------------------------------------------

# a storage's holders where they are not positions (its bytes are charged
# to positions only when its holders are a frozenset of them)
_PENDING = "pending"          # a fill not yet read: its positions unknown
_INPUT = "input"              # a placed input's: counted from its blocks
_QUIET = "quiet"              # a collective's own buffer outside a group
_FILLS = {"empty", "empty_strided", "zeros", "ones", "full", "arange",
          "scalar_tensor", "new_zeros", "new_full", "new_empty",
          "new_ones", "zeros_like", "ones_like", "full_like", "empty_like",
          "rand", "randn", "lift_fresh"}


_LAYER = re.compile(r"^(encoder layer|layer) (\d+)$")


def layer_label(name: str):
    """``(loop, index)`` of a profiler range naming a layer, else None."""
    m = _LAYER.match(name)
    return None if m is None else (m.group(1), int(m.group(2)))


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)
_NO_KEY = object()            # an argument a cache key cannot hold


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors in nested tuples, lists and dicts ``x``, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _rebuild(spec, made):
    """``spec`` (nested tuples and lists, "T" for each tensor) with
    ``made``'s tensors in order."""
    if isinstance(spec, str) and spec == "T":
        return next(made)
    if isinstance(spec, (list, tuple)):
        return type(spec)(_rebuild(s, made) for s in spec)
    return spec


def _shape_spec(x):
    if isinstance(x, torch.Tensor):
        return "T"
    if isinstance(x, (list, tuple)):
        return type(x)(_shape_spec(y) for y in x)
    return x


def _aliases(func) -> bool:
    """Whether an output of ``func`` aliases an input (a view, or an op
    writing in place)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _writes(func) -> bool:
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


class CostMode(TorchDispatchMode):
    """Counts dot FLOPs, op-boundary bytes and live bytes by mesh position
    while a step runs (module docstring). ``mesh``: the positions (None:
    one). ``claim_inputs`` counts placed tensors made before the trace;
    ``start`` begins the count."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.n = mesh.size if mesh is not None else 1
        z = lambda: np.zeros(self.n, dtype=np.float64)   # noqa: E731
        self.flops, self.conv_flops, self.bytes = z(), z(), z()
        self.live, self.peak = z(), z()
        self.counting = True
        self.exec = {"flops": 0.0, "conv_flops": 0.0, "bytes": 0.0}
        self.exec_live = self.exec_peak = 0.0
        self.kernels: dict = {}
        self.ops = self.joins = self.hits = 0
        self._storages: dict = {}          # storage key -> record
        self._meta_cache: dict = {}
        self._idx: dict = {}
        self._aliasing: dict = {}
        self.all = frozenset(range(self.n))
        self.weights: Dict[str, float] = {}
        self.weight = 1.0
        self.ranges: list = []
        self.segments: Optional[list] = None
        self.start_live: Optional[np.ndarray] = None
        self._seg = None

    # -- positions ----------------------------------------------------------

    def _index(self, pos: frozenset) -> np.ndarray:
        idx = self._idx.get(pos)
        if idx is None:
            idx = self._idx[pos] = np.fromiter(sorted(pos), dtype=np.int64)
        return idx

    def _scope(self) -> frozenset:
        sc = S.current_scope()
        return self.all if sc is None else sc

    def _tag(self, t: torch.Tensor):
        m = S.marked(t)
        if m is not None:
            return m
        rec = self._storages.get(self._key(t))
        return None if rec is None or not isinstance(rec[1], frozenset) \
            else rec[1]

    # -- storages -------------------------------------------------------------

    @staticmethod
    def _key(t: torch.Tensor):
        return t.untyped_storage()._cdata

    def _alloc(self, t: torch.Tensor, pos, per_position: Optional[float]
               = None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        nbytes = float(st.nbytes())
        each = nbytes if per_position is None else float(per_position)
        free = self._free
        self._storages[key] = [each, pos, nbytes, 0.0,
                               weakref.ref(st, lambda _, k=key: free(k))]
        self.exec_live += nbytes
        if self.exec_live > self.exec_peak:
            self.exec_peak = self.exec_live
        if isinstance(pos, frozenset):
            self._charge_live(pos, each)

    def _charge_live(self, pos, each: float) -> None:
        if len(pos) == 1:
            (i,) = pos
            v = self.live[i] + each
            self.live[i] = v
            if v > self.peak[i]:
                self.peak[i] = v
            return
        idx = self._index(pos)
        self.live[idx] += each
        self.peak[idx] = np.maximum(self.peak[idx], self.live[idx])

    def _free(self, key) -> None:
        rec = self._storages.pop(key, None)
        if rec is None:
            return
        each, pos, nbytes = rec[:3]
        self.exec_live -= nbytes
        if isinstance(pos, frozenset):
            self.live[self._index(pos)] -= each

    def _settle(self, t: torch.Tensor, pos: frozenset) -> None:
        """A pending fill read by an op of ``pos``: charge it there."""
        rec = self._storages.get(self._key(t))
        if rec is not None and rec[1] is _PENDING:
            rec[1] = pos
            self._charge_live(pos, rec[0])
            if rec[3]:
                self.bytes[self._index(pos)] += rec[3]

    def claim_inputs(self, placed) -> None:
        """Count ``Placed`` inputs (made before the step) as SPMD holds
        them: each position its block's bytes, whatever storages the
        blocks share on this process's one device."""
        for p in placed:
            for flat, (pos, _) in enumerate(S.positions(p.mesh)):
                t = p.blocks[pos]
                self.live[flat] += _nbytes(t)
                rec = self._storages.get(self._key(t))
                if rec is not None and rec[1] is not _INPUT:
                    if isinstance(rec[1], frozenset):
                        self.live[self._index(rec[1])] -= rec[0]
                    rec[1] = _INPUT
        self.peak = np.maximum(self.peak, self.live)

    def start(self) -> None:
        """Start counting (after the inputs are made): the op counters at
        zero, the live bytes the inputs' alone (a step's meta ``structure``
        and whatever else set-up left holds no device memory in a real
        run), and the peaks at what is live now."""
        for key, rec in list(self._storages.items()):
            if rec[1] is not _INPUT:
                if isinstance(rec[1], frozenset):
                    self.live[self._index(rec[1])] -= rec[0]
                self.exec_live -= rec[2]
                del self._storages[key]
        self.counting = True
        for arr in (self.flops, self.conv_flops, self.bytes):
            arr[:] = 0.0
        self.exec = {"flops": 0.0, "conv_flops": 0.0, "bytes": 0.0}
        self.kernels.clear()
        self.peak = self.live.copy()
        self.exec_peak = self.exec_live
        self.ops = self.joins = 0
        self.start_live = np.append(self.live, self.exec_live)
        if self.segments is not None:
            self._seg_open(None)

    # -- segments -------------------------------------------------------------

    def _seg_open(self, label) -> None:
        self._seg = (label, np.append(self.live, self.exec_live), self.peak,
                     self.exec_peak)
        self.peak = self.live.copy()
        self.exec_peak = self.exec_live

    def _seg_close(self) -> None:
        label, start, peak0, epeak0 = self._seg
        top = np.append(self.peak, self.exec_peak)
        now = np.append(self.live, self.exec_live)
        if label is not None or np.any(top != start) or np.any(now != start):
            self.segments.append((label, top - start, now - start))
        self.peak = np.maximum(peak0, self.peak)
        self.exec_peak = max(epeak0, self.exec_peak)
        self._seg = None

    def end_segments(self) -> None:
        """Close the open segment and stop cutting: ``segments`` holds
        ``(label, rise, net)`` a segment in order, each an array over the
        positions and, last, the executed live bytes; ``label`` is
        ``layer_label``'s, or None between layers."""
        if self._seg is not None:
            self._seg_close()

    def _range(self, func, args, kwargs):
        """A profiler range opens or closes."""
        out = func(*args, **kwargs)
        if func.__name__.startswith("_record_function_enter"):
            name = args[0]
            self.ranges.append(name)
            opening = True
        elif self.ranges:
            name = self.ranges.pop()
            opening = False
        else:
            return out
        self.weight = 1.0
        for r in self.ranges:
            self.weight *= self.weights.get(r, 1.0)
        label = layer_label(name)
        if label is not None and self._seg is not None:
            self._seg_close()
            self._seg_open(label if opening else None)
        return out

    def adopt(self, t: torch.Tensor, positions) -> torch.Tensor:
        """Mark ``t`` (an empty made in the trace, not yet read) as held by
        ``positions``, whose live bytes already count it (``copy_positions``
        copied them): freeing it takes it off there."""
        rec = self._storages[self._key(t)]
        if rec[1] is not _PENDING:
            raise ValueError("adopt takes an empty no op has read")
        rec[1] = frozenset(positions)
        rec[3] = 0.0
        S.mark(t, rec[1])
        return t

    # -- kernels --------------------------------------------------------------

    def record_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of kernel ``name`` doing ``flops`` and moving
        ``nbytes``, for the positions of the current scope."""
        pos = self._scope()
        idx = self._index(pos)
        w = self.weight
        flops, nbytes = w * flops, w * nbytes
        rec = self.kernels.setdefault(name, {
            "calls": 0, "flops": 0.0, "bytes": 0.0,
            "per_position_calls": np.zeros(self.n)})
        rec["calls"] += w
        rec["flops"] += flops
        rec["bytes"] += nbytes
        rec["per_position_calls"][idx] += w
        self.flops[idx] += flops
        self.bytes[idx] += nbytes
        self.exec["flops"] += flops
        self.exec["bytes"] += nbytes

    # -- dispatch -------------------------------------------------------------

    def _signature(self, func, args, kwargs):
        """A hashable key of the call's metadata, or None where an
        argument has none (a generator): such a call is never cached."""
        def sig(x):
            if isinstance(x, torch.Tensor):
                return ("T", tuple(x.shape), x.stride(), x.dtype,
                        x.storage_offset(), x.device.type)
            if isinstance(x, _PLAIN):
                return x
            if isinstance(x, (list, tuple)):
                parts = tuple(sig(y) for y in x)
                return _NO_KEY if any(p is _NO_KEY for p in parts) else parts
            return _NO_KEY
        key = sig((args, tuple(kwargs.values())))
        return None if key is _NO_KEY else (func, tuple(kwargs), key)

    def _alias_of(self, func) -> bool:
        a = self._aliasing.get(func)
        if a is None:
            a = self._aliasing[func] = (_aliases(func), _writes(func))
        return a[0]

    def _run(self, func, args, kwargs, ins):
        """The op's outputs: from the metadata cache where an identical
        call made fresh meta outputs before, else by running it."""
        meta = all(x.device.type == "meta" for x in ins)
        key = None
        aliased = self._alias_of(func)
        if meta and not aliased:
            key = self._signature(func, args, kwargs)
            cached = self._meta_cache.get(key) if key is not None else None
            if cached is not None:
                self.hits += 1
                spec, outs = cached
                return _rebuild(spec, iter([
                    torch.empty_strided(sh, st, dtype=dt, device="meta")
                    for sh, st, dt in outs]))
        out = func(*args, **kwargs)
        if not aliased:
            # an op whose schema declares no alias but returns a view
            # (``_unsafe_view``): a view, never cached
            mine = {self._key(x) for x in ins}
            if any(self._key(t) in mine for t in _tensors(out, [])):
                self._aliasing[func] = (True, False)
                return out
        if key is not None:
            flat = _tensors(out, [])
            if all(t.device.type == "meta" for t in flat) and not isinstance(
                    out, dict):
                self._meta_cache[key] = (
                    _shape_spec(out),
                    [(tuple(t.shape), t.stride(), t.dtype) for t in flat])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":
            return self._range(func, args, kwargs)
        ins = _tensors(kwargs, _tensors(args, []))
        out = self._run(func, args, kwargs, ins)
        self.ops += 1
        outs = _tensors(out, [])
        name = func.overloadpacket.__name__
        if S.quiet() or not self.counting:
            # a collective's buffer is held by the group it runs in (an
            # all-gather's result by each member); outside a group (the
            # gradient sync's sums) by no position
            held = (self._scope() if S.current_scope() is not None
                    or not self.counting else _QUIET)
            for t in outs:
                self._alloc(t, held)
            return out
        scope = self._scope()
        tags = [self._tag(x) for x in ins]
        pending = [x for x, g in zip(ins, tags) if g is None and
                   self._storages.get(self._key(x), [0, None])[1]
                   is _PENDING]
        marked = [g for g in tags if g is not None]
        pos = scope
        for g in marked:
            pos = pos & g
        if marked and not pos:
            # disjoint positions meet: a collective's arithmetic outside
            # its own function (its bytes are recorded as the collective's)
            self.joins += 1
            held = scope if S.current_scope() is not None else _QUIET
            for t in outs:
                self._alloc(t, held)
            return out
        for x in pending:
            self._settle(x, pos)
        fill = not ins and name in _FILLS
        self._alias_of(func)
        aliases, writes = self._aliasing[func]
        view = aliases and not writes
        for t in outs:
            if not fill:
                S.mark(t, pos)
            if not view:
                self._alloc(t, _PENDING if fill else pos)
        if view:
            return out
        nbytes = float(sum(_nbytes(t) for t in ins)
                       + sum(_nbytes(t) for t in outs))
        if writes:
            # an in-place write: its result is the operand it wrote
            nbytes -= float(sum(_nbytes(t) for t in outs))
        w = self.weight
        nbytes *= w
        self.exec["bytes"] += nbytes
        if fill:
            if not name.startswith(("empty", "new_empty")):
                for t in outs:
                    self._storages[self._key(t)][3] += w * _nbytes(t)
            else:
                self.exec["bytes"] -= nbytes
            return out
        self.bytes[self._index(pos)] += nbytes
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            f = w * float(fn(*args, **kwargs, out_val=out))
            which = "conv_flops" if "conv" in name else "flops"
            self.exec[which] += f
            getattr(self, which)[self._index(pos)] += f
        return out

    # -- results ------------------------------------------------------------

    def copy_positions(self, src, dst) -> None:
        """Set positions ``dst`` (flat indices) to the counts and peaks of
        ``src``, one for one: a batch group traced for all."""
        for arr in (self.flops, self.conv_flops, self.bytes, self.live,
                    self.peak):
            arr[list(dst)] = arr[list(src)]
        for rec in self.kernels.values():
            c = rec["per_position_calls"]
            c[list(dst)] = c[list(src)]

    def summary(self) -> dict:
        """Per-device (largest over positions) and executed totals."""
        return {
            "per_device_flops": float(self.flops.max()),
            "per_device_conv_flops": float(self.conv_flops.max()),
            "per_device_bytes": float(self.bytes.max()),
            "peak_bytes": float(self.peak.max()),
            "executed": dict(self.exec, peak_bytes=self.exec_peak),
            "kernels": {k: {"calls": v["calls"], "flops": v["flops"],
                            "bytes": v["bytes"],
                            "per_device_calls": float(
                                v["per_position_calls"].max())}
                        for k, v in self.kernels.items()},
            "ops": self.ops, "cache_hits": self.hits, "joins": self.joins,
        }


def active_mode() -> Optional[CostMode]:
    """The innermost ``CostMode`` on the dispatch stack, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, CostMode):
            return m
    return None
