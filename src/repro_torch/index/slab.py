"""Serving-layout slabs and their sharding over a ``ShardMesh``.

A *slab* is the dense materialisation of an index's serving data, the
thing a query's scan streams:

  * ``FlatSlab``  - the (n, d) corpus rows + squared norms (+ int8 scales);
  * ``IVFSlab``   - the grouped (nlist, max_list, d) inverted-list layout +
    the coarse centroids (``build_grouped`` materialises it);
  * ``PQSlab``    - the (n, M) residual-PQ codes + coarse ids, with the LUT
    terms (codebooks, coarse centers, cross terms) replicated.

Each slab's ``shard(mesh, rules)`` splits it into one block per mesh
position along the axes its ``AxisRules`` entry names ("corpus" for flat
and PQ rows, "ivf_lists" for whole inverted lists). Every block lives in
its own tensors on its position's device (``shard_devices``), with the
payload the serving step reads beside it: each row's global corpus id,
the re-rank originals (``payload``: normalized vectors and filters) in the
block's order, and optionally the RAW attribute rows (``attrs``) predicate
search evaluates in the shard.

The layout is the reference's (``repro.index.slab``), so checkpoints,
routing tables and coverage agree with it: flat rows in ``perm`` order
(corpus order, or filter-centric ``placement="cluster"``), n_local =
ceil(n / ns), and a row's shard its slab position // n_local; IVF lists
placed whole by ``balanced_list_layout``, ``affinity`` or contiguous
blocks, each at the reference's ``slot_of_list`` (shard * (lists_per_shard
+ 1) + slot); PQ rows contiguous. The port's kernels take any n, so a
block stores only live rows (no pad rows, no sentinel list): the last
blocks may be shorter, or empty, and an empty block never launches.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Grouped-layout materialisation (the IVF serving layout)
# ---------------------------------------------------------------------------

def build_grouped(vectors: Tensor, sq_norms: Tensor, lists: Tensor):
    """Materialise the (nlist, max_list, d) serving slabs from id lists.

    ``lists`` is (nlist, max_list) int32 corpus ids with -1 padding. Returns
    (grouped, grouped_sq, valid) with ``valid`` float 0/1 (1 = real row);
    ``grouped`` keeps the stored rows' dtype (fp32, bf16 or int8 codes).
    Pad slots hold corpus row 0, masked by ``valid``, as in the
    reference."""
    safe = torch.clamp(lists, min=0).long()
    return (vectors[safe], sq_norms[safe], (lists >= 0).to(torch.float32))


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

def resolve_axes(mesh, rules, name: str) -> Tuple[str, ...]:
    """Mesh axes a logical axis name shards over, per the AxisRules entry."""
    v = rules.rules.get(name)
    if v is None:
        return ()
    axes = v if isinstance(v, tuple) else (v,)
    return tuple(a for a in axes if a in mesh.axis_names)


def axes_size(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def shard_devices(mesh, axes: Sequence[str]) -> List[torch.device]:
    """The device of each shard, in linear shard order over ``axes`` (the
    last axis fastest): the position with the shard's coordinates along
    ``axes`` and 0 along the mesh's other axes."""
    from repro_torch.index.distributed import shard_coords

    sizes = [mesh.shape[a] for a in axes]
    return [mesh.device_at(shard_coords(s, axes, sizes))
            for s in range(axes_size(mesh, axes))]


def pad_dim0(x: Tensor, to: int, value) -> Tensor:
    pad = to - x.shape[0]
    if pad <= 0:
        return x
    filler = torch.full((pad, *x.shape[1:]), value, dtype=x.dtype,
                        device=x.device)
    return torch.cat([x, filler], dim=0)


def _take(x: Optional[Tensor], idx: Tensor, dev: torch.device):
    """Rows ``idx`` of ``x`` as a new tensor on ``dev`` (None stays)."""
    if x is None:
        return None
    return x[idx.to(x.device)].contiguous().to(dev)


# ---------------------------------------------------------------------------
# Flat slab
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatShard:
    """One shard's block of flat rows: the stored rows, their squared norms
    and int8 scales, each row's global corpus id (int32), the re-rank
    originals ``pv`` / ``pf`` and the RAW attributes (or None), all on
    ``device`` and in the block's order. The delta tier's blocks are
    FlatShards too (ids local to the delta)."""

    device: torch.device
    vectors: Tensor
    sq_norms: Tensor
    row_ids: Tensor
    pv: Tensor
    pf: Tensor
    scales: Optional[Tensor] = None
    attrs: Optional[Tensor] = None

    @property
    def size(self) -> int:
        return self.vectors.shape[0]

    @property
    def index(self):
        """The block's rows as a ``flat.FlatIndex`` (local ids)."""
        from repro_torch.index.flat import FlatIndex
        return FlatIndex(self.vectors, self.sq_norms, self.scales)


def flat_shard(vectors, sq_norms, scales, idx: Tensor, payload, dev,
               attrs=None) -> FlatShard:
    """The block of rows ``idx`` (int64 ids, which it keeps as its
    ``row_ids``) on ``dev``."""
    pv, pf = payload
    return FlatShard(device=dev, vectors=_take(vectors, idx, dev),
                     sq_norms=_take(sq_norms, idx, dev),
                     row_ids=idx.to(device=dev, dtype=torch.int32),
                     pv=_take(pv, idx, dev), pf=_take(pf, idx, dev),
                     scales=_take(scales, idx, dev),
                     attrs=_take(attrs, idx, dev))


@dataclasses.dataclass(frozen=True)
class FlatSlab:
    """The flat serving layout: corpus rows + precomputed squared norms."""

    vectors: Tensor   # (n, d) fp32 / bf16 / int8 codes
    sq_norms: Tensor  # (n,)
    scales: Optional[Tensor] = None  # (n,) fp32 per-row dequant (int8)

    @property
    def size(self) -> int:
        return self.vectors.shape[0]

    def shard(self, mesh, rules, *, placement: str = "contiguous",
              centers: Optional[Tensor] = None, rng=None, payload=None,
              attrs=None) -> "ShardedFlatSlab":
        """Row-shard this slab over the mesh axes of the "corpus" rule.

        ``placement="contiguous"`` keeps corpus order; ``"cluster"``
        permutes the rows so psi-clusters land on single shards (filter-
        centric placement: the transformed corpus clusters by filter value,
        so filtered traffic concentrates per shard). ``centers`` fixes the
        psi-cluster geometry ((ncl, d) fp32, e.g. restored from a
        checkpoint, so a restored engine routes from the same clusters);
        otherwise a k-means over the stored rows (the port's generator,
        seeded with ``rng``, 0 when None; 5 Lloyd steps) picks
        ``min(4 * n_shards, n)`` centers.

        Cluster placement also derives the routing tables of routed serving
        from the ACTUAL placement: ``router_centers`` (ncl, d),
        ``router_radii`` (ncl,), the largest distance of a cluster's rows to
        its center (the ball bound), and ``cluster_to_shard`` (ncl, ns), 1
        where a shard holds a row of the cluster (the rebalance may split
        a cluster). ``payload`` is the re-rank originals (vectors_n,
        filters_n) in corpus order; ``attrs`` the (n, m) RAW attribute
        table, carried into each block."""
        from repro_torch.index.distributed import cluster_sharded_layout
        from repro_torch.core.clustering import assign, kmeans

        axes = resolve_axes(mesh, rules, "corpus")
        ns = axes_size(mesh, axes)
        n = self.size
        home = self.vectors.device
        router_centers = router_radii = cluster_to_shard = None
        if placement == "cluster" and ns > 1:
            v32 = self.vectors.to(torch.float32)
            if centers is None:
                centers, _ = kmeans(v32, min(4 * ns, n), iters=5,
                                    generator=0 if rng is None else rng)
            centers = torch.as_tensor(centers, dtype=torch.float32,
                                      device=home).contiguous()
            labels = assign(v32, centers)                   # corpus order
            perm, _ = cluster_sharded_layout(v32, centers, ns, labels=labels)
            # the packer balances to exactly n // ns rows a shard; fold the
            # rows it leaves over back in, in corpus order
            if perm.shape[0] < n:
                rest = np.setdiff1d(np.arange(n), perm)
                perm = np.concatenate([perm, rest])
            # routing tables from the ACTUAL placement: a row's shard is its
            # slab position // n_local, remainder rows included
            ncl = centers.shape[0]
            dist = torch.linalg.vector_norm(v32 - centers[labels], dim=-1)
            router_radii = torch.zeros((ncl,), device=home).scatter_reduce(
                0, labels, dist, "amax")
            n_local = -(-n // ns)
            lab = labels.cpu().numpy()
            inc = np.zeros((ncl, ns), np.float32)
            inc[lab[perm], np.arange(n) // n_local] = 1.0
            router_centers = centers
            cluster_to_shard = torch.tensor(inc, device=home)
        elif placement == "contiguous" or ns <= 1:
            perm = np.arange(n, dtype=np.int64)
        else:
            raise ValueError(f"unknown placement {placement!r}")
        n_local = -(-n // ns)
        devs = shard_devices(mesh, axes)
        perm_t = torch.as_tensor(perm, dtype=torch.int64, device=home)
        if attrs is not None:
            attrs = torch.as_tensor(np.asarray(attrs, np.float32),
                                    device=home)
        shards = tuple(
            flat_shard(self.vectors, self.sq_norms, self.scales,
                       perm_t[s * n_local:(s + 1) * n_local], payload,
                       devs[s], attrs)
            for s in range(ns))
        return ShardedFlatSlab(
            shards=shards, perm=perm, mesh=mesh, axes=axes, n_real=n,
            n_local=n_local, placement=placement,
            router_centers=router_centers, router_radii=router_radii,
            cluster_to_shard=cluster_to_shard)


@dataclasses.dataclass(frozen=True)
class ShardedFlatSlab:
    """Row-sharded flat slab (a host-side container of per-shard blocks).

    ``perm`` (n,) is the slab order (slab position -> corpus id); shard s
    holds positions [s * n_local, (s + 1) * n_local). The routing tables
    (``router_*``, ``cluster_to_shard``, on the home device) are only
    populated for ``placement="cluster"`` on a mesh of more than one
    shard."""

    shards: Tuple[FlatShard, ...]
    perm: np.ndarray
    mesh: object
    axes: Tuple[str, ...]
    n_real: int
    n_local: int
    placement: str
    router_centers: Optional[Tensor] = None   # (ncl, d) psi-cluster centers
    router_radii: Optional[Tensor] = None     # (ncl,) max member distance
    cluster_to_shard: Optional[Tensor] = None  # (ncl, ns) 0/1 incidence

    @property
    def n_shards(self) -> int:
        return len(self.shards)


# ---------------------------------------------------------------------------
# IVF slab
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IVFShard:
    """One shard's inverted lists, in slot order: ``list_ids`` (c,) global
    list ids, the grouped rows (c, max_list, d) with their squared norms,
    ``valid``, global corpus ids ``lists`` (-1 pad) and int8 scales; the
    re-rank originals ``pv`` / ``pf`` and the RAW attributes (NaN on pad
    slots) in the same grouped layout. All on ``device``."""

    device: torch.device
    list_ids: np.ndarray
    grouped: Tensor
    grouped_sq: Tensor
    valid: Tensor
    lists: Tensor
    pv: Tensor
    pf: Tensor
    grouped_scales: Optional[Tensor] = None
    attrs: Optional[Tensor] = None

    @property
    def count(self) -> int:
        return int(self.list_ids.shape[0])


@dataclasses.dataclass(frozen=True)
class IVFSlab:
    """The IVF serving layout: coarse centroids + grouped inverted lists."""

    centroids: Tensor   # (nlist, d)
    lists: Tensor       # (nlist, max_list) int32 corpus ids, -1 pad
    grouped: Tensor     # (nlist, max_list, d) fp32 / bf16 / int8 codes
    grouped_sq: Tensor  # (nlist, max_list)
    valid: Tensor       # (nlist, max_list) float 0/1
    grouped_scales: Optional[Tensor] = None  # (nlist, max_list) int8 dequant

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def max_list(self) -> int:
        return self.lists.shape[1]

    def shard(self, mesh, rules, *, placement: str = "balanced",
              list_sizes=None, payload=None, attrs=None,
              seeds=None) -> "ShardedIVFSlab":
        """List-shard the grouped layout over the "ivf_lists" rule axes.

        Whole inverted lists (= psi-clusters of the transformed corpus) are
        placed on shards: ``"balanced"`` packs the largest lists first onto
        the least-loaded shard (``balanced_list_layout``), ``"affinity"``
        lists with NEARBY centroids onto the same shard under balance caps
        (``distributed.affinity_group_layout``, ``seeds`` as there: the
        placement routed serving wants), ``"contiguous"`` blocks of list
        ids. A shard holds at most lists_per_shard = ceil(nlist / ns) lists;
        ``slot_of_list`` numbers them as the reference does (shard *
        (lists_per_shard + 1) + slot), and a probed list's owner is
        ``list_to_shard``, the exact routing table of routed IVF serving.
        ``payload`` (vectors_n, filters_n) and ``attrs`` (n, m) in corpus
        order are regrouped into each shard's layout."""
        from repro_torch.index import ivf as ivf_mod
        from repro_torch.index.distributed import affinity_group_layout

        axes = resolve_axes(mesh, rules, "ivf_lists")
        ns = axes_size(mesh, axes)
        nlist, max_list = self.lists.shape
        lp = -(-nlist // ns)              # list slots a shard
        if list_sizes is None:
            list_sizes = torch.sum(self.valid > 0.5, dim=-1)
        sizes = np.asarray(torch.as_tensor(list_sizes).cpu(), np.int64)
        if placement == "balanced" and ns > 1:
            shard_of, slot_in = balanced_list_layout(sizes, ns, lp)
        elif placement == "affinity" and ns > 1:
            shard_of = affinity_group_layout(self.centroids.cpu().numpy(),
                                             sizes, ns, slot_capacity=lp,
                                             seeds=seeds)
            slot_in = np.zeros((nlist,), np.int32)
            counts = np.zeros((ns,), np.int32)
            for g in range(nlist):
                slot_in[g] = counts[shard_of[g]]
                counts[shard_of[g]] += 1
        elif placement in ("contiguous", "balanced", "affinity"):
            shard_of = np.arange(nlist) // lp
            slot_in = np.arange(nlist) % lp
        else:
            raise ValueError(f"unknown placement {placement!r}")
        shard_of = np.asarray(shard_of, np.int32)
        slot_in = np.asarray(slot_in, np.int32)
        home = self.lists.device
        devs = shard_devices(mesh, axes)
        pv, pf = payload
        if attrs is not None:
            attrs = torch.as_tensor(np.asarray(attrs, np.float32),
                                    device=home)
        shards = []
        for s in range(ns):
            mine = np.nonzero(shard_of == s)[0]
            ids = mine[np.argsort(slot_in[mine], kind="stable")]
            g = torch.as_tensor(ids, dtype=torch.int64, device=home)
            lists = self.lists[g]
            ga = None
            if attrs is not None:
                ga = torch.where((lists >= 0)[..., None],
                                 attrs[torch.clamp(lists, min=0).long()],
                                 float("nan"))
            dev = devs[s]
            shards.append(IVFShard(
                device=dev, list_ids=ids, grouped=_take(self.grouped, g, dev),
                grouped_sq=_take(self.grouped_sq, g, dev),
                valid=_take(self.valid, g, dev), lists=lists.to(dev),
                pv=ivf_mod.build_grouped_payload(pv, lists).to(dev),
                pf=ivf_mod.build_grouped_payload(pf, lists).to(dev),
                grouped_scales=_take(self.grouped_scales, g, dev),
                attrs=None if ga is None else ga.contiguous().to(dev)))
        return ShardedIVFSlab(
            centroids=self.centroids,
            c_sq=torch.sum(self.centroids * self.centroids, dim=-1),
            slot_in_shard=slot_in,
            slot_of_list=(shard_of * (lp + 1) + slot_in).astype(np.int32),
            shards=tuple(shards), mesh=mesh, axes=axes, nlist=nlist,
            max_list=max_list, lists_per_shard=lp, placement=placement)


@dataclasses.dataclass(frozen=True)
class ShardedIVFSlab:
    """List-sharded IVF slab (a host-side container of per-shard blocks);
    the coarse quantizer (``centroids``, ``c_sq``) stays on the home
    device."""

    centroids: Tensor        # (nlist, d)
    c_sq: Tensor             # (nlist,) the coarse scan's norms
    slot_in_shard: np.ndarray   # (nlist,) int32
    slot_of_list: np.ndarray    # (nlist,) int32, the reference's numbering
    shards: Tuple[IVFShard, ...]
    mesh: object
    axes: Tuple[str, ...]
    nlist: int
    max_list: int
    lists_per_shard: int
    placement: str

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def list_to_shard(self) -> np.ndarray:
        """(nlist,) int32 shard owning each inverted list: every list is
        wholly owned by one shard, so this routing table is exact."""
        return self.slot_of_list // (self.lists_per_shard + 1)


# ---------------------------------------------------------------------------
# PQ slab
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PQShard:
    """One shard's contiguous block of PQ rows [offset, offset + size): the
    combined codes (size, M) int32 (the plain scan reads them), the
    block's coarse-grouped layout (``pq.grouped_layout``; the fused scan
    reads it) and the re-rank originals, on ``device``."""

    device: torch.device
    offset: int
    ccodes: Tensor
    grouped: tuple
    pv: Tensor
    pf: Tensor

    @property
    def size(self) -> int:
        return self.ccodes.shape[0]


@dataclasses.dataclass(frozen=True)
class PQSlab:
    """The residual-PQ serving layout: row-shardable codes + replicated LUT
    terms. The ADC scan reads only ``codes``/``coarse_ids`` per row; the
    rest is LUT state a few KB large, kept whole on the home device."""

    codebooks: Tensor       # (M, ksub, dsub)
    codes: Tensor           # (n, M) uint8 / int32
    coarse_centers: Tensor  # (ncoarse, d)
    coarse_ids: Tensor      # (n,) int32
    cb_sq: Tensor           # (M, ksub)
    coarse_dot: Tensor      # (ncoarse, M, ksub)

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    def shard(self, mesh, rules, *, placement: str = "contiguous",
              payload=None) -> "ShardedPQSlab":
        """Row-shard the codes over the "corpus" rule axes, contiguous
        only (PQ has no per-row geometry to cluster by: the coarse quantizer
        already is the cluster structure, and it stays whole)."""
        from repro_torch.index import pq as pq_mod

        if placement != "contiguous":
            raise ValueError(
                f"PQ slab only supports contiguous placement, got "
                f"{placement!r}")
        axes = resolve_axes(mesh, rules, "corpus")
        ns = axes_size(mesh, axes)
        n = self.size
        n_local = -(-n // ns)
        ksub, ncoarse = self.codebooks.shape[1], self.coarse_centers.shape[0]
        devs = shard_devices(mesh, axes)
        pv, pf = payload
        shards = []
        for s in range(ns):
            lo, hi = min(n, s * n_local), min(n, (s + 1) * n_local)
            dev = devs[s]
            codes = self.codes[lo:hi].to(dev, copy=True)
            cids = self.coarse_ids[lo:hi].to(dev, copy=True)
            shards.append(PQShard(
                device=dev, offset=lo,
                ccodes=(cids[:, None] * ksub
                        + codes.to(torch.int32)).contiguous(),
                grouped=pq_mod.grouped_layout(codes, cids, ncoarse),
                pv=pv[lo:hi].to(dev, copy=True),
                pf=pf[lo:hi].to(dev, copy=True)))
        return ShardedPQSlab(
            codebooks=self.codebooks, coarse_centers=self.coarse_centers,
            cb_sq=self.cb_sq, coarse_dot=self.coarse_dot,
            shards=tuple(shards), mesh=mesh, axes=axes, n_real=n,
            n_local=n_local, placement=placement)


@dataclasses.dataclass(frozen=True)
class ShardedPQSlab:
    """Row-sharded PQ slab: rows stay in corpus order, so a row's id is its
    block's offset plus its position in the block."""

    codebooks: Tensor
    coarse_centers: Tensor
    cb_sq: Tensor
    coarse_dot: Tensor
    shards: Tuple[PQShard, ...]
    mesh: object
    axes: Tuple[str, ...]
    n_real: int
    n_local: int
    placement: str

    @property
    def n_shards(self) -> int:
        return len(self.shards)


def balanced_list_layout(list_sizes: np.ndarray, n_shards: int,
                         capacity: int):
    """Greedy balanced packing of inverted lists onto shards.

    Largest lists first onto the least-loaded shard that still has a free
    slot (each shard holds at most ``capacity`` lists): lists are whole
    psi-clusters, so a probe touches exactly one shard. Returns
    (shard_of_list, slot_in_shard) int32 arrays; the reference's bit for
    bit."""
    sizes = np.asarray(list_sizes, np.int64)
    nlist = sizes.shape[0]
    if n_shards * capacity < nlist:
        raise ValueError(
            f"{n_shards} shards x {capacity} slots < {nlist} lists")
    order = np.argsort(-sizes, kind="stable")
    load = np.zeros(n_shards, np.int64)
    used = np.zeros(n_shards, np.int64)
    shard_of = np.zeros(nlist, np.int32)
    slot_in = np.zeros(nlist, np.int32)
    for g in order:
        free = np.nonzero(used < capacity)[0]
        s = free[np.argmin(load[free])]
        shard_of[g] = s
        slot_in[g] = used[s]
        used[s] += 1
        load[s] += sizes[g]
    return shard_of, slot_in
