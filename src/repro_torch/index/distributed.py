"""Shard layouts and the cross-shard top-k merges, in PyTorch.

The corpus is split into shards over one or more mesh axes (row blocks, or
whole inverted lists); every shard scores its own block and the per-shard
top-k candidate sets are merged, one stage per mesh axis, so only (k x
shards) candidates ever meet, never raw score matrices. The reference runs
a shard per device inside one ``shard_map`` with all-gathers; here the
shards run back to back from one process (a host loop over shards) and a
merge stage pools the candidate sets of the shards that share every other
mesh coordinate.

Every merge orders by first occurrence over the shard-major pool: the
first-occurrence top-k of the concatenated sets, as ``flat.merge_topk``
(the reference's merge) does. A merge of merges keeps that order, so the
tree result equals the global first-occurrence top-k of every shard's
candidates; with row-contiguous shards whose sets rank equal scores by
ascending id, that is (score desc, global id asc), the meshless scan's
order.

Filter-centric placement: psi() arranges the corpus into filter clusters,
so whole clusters (or inverted lists) can be placed on shards with their
neighbours (``affinity_group_layout``, ``cluster_sharded_layout``) and a
query touches few shards; ``routed_search_fn`` skips shards no query
probes. Mirrors ``repro.index.distributed``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.clustering import assign, kmeans
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_first

Tensor = torch.Tensor


def linear_shard_index(axes: Sequence[str], sizes: Sequence[int],
                       coords: Dict[str, int]) -> int:
    """The linear shard index of mesh coordinates ``coords`` over the
    row-major product of ``axes`` (extents ``sizes``): the last axis is the
    fastest, as a dim-0 block layout over those axes lays out its blocks,
    so ``row // n_local`` is the shard of a row-contiguous block."""
    lin, stride = 0, 1
    for ax, n_ax in zip(reversed(tuple(axes)), reversed(tuple(sizes))):
        lin += int(coords[ax]) * stride
        stride *= int(n_ax)
    return lin


def shard_coords(s: int, axes: Sequence[str],
                 sizes: Sequence[int]) -> Dict[str, int]:
    """The inverse of ``linear_shard_index``."""
    idx = np.unravel_index(int(s), tuple(int(n) for n in sizes))
    return {ax: int(i) for ax, i in zip(axes, idx)}


def _pool(vals: List[Tensor], idx: List[Tensor], rows: List[tuple], k: int):
    """First-occurrence top-k of the concatenated sets, each set's payload
    rows (b, kl, dim) selected with the same positions; pads past the pool
    read (-inf, id 0, zero rows)."""
    v = torch.cat(vals, dim=-1)
    i = torch.cat(idx, dim=-1)
    r = [torch.cat(parts, dim=-2) for parts in zip(*rows)] if rows else []
    total = v.shape[-1]
    if k > total:
        pad = k - total
        v = torch.cat([v, v.new_full((*v.shape[:-1], pad), float("-inf"))],
                      dim=-1)
        i = torch.cat([i, i.new_zeros((*i.shape[:-1], pad))], dim=-1)
        r = [torch.cat([x, x.new_zeros((*x.shape[:-2], pad, x.shape[-1]))],
                       dim=-2) for x in r]
    top, pos = topk_first(v, k)
    out_r = tuple(torch.gather(x, -2, pos[..., None].expand(
        *pos.shape, x.shape[-1])) for x in r)
    return top, torch.gather(i, -1, pos), out_r


def merge_over_axis(vals: Sequence[Optional[Tensor]],
                    idx: Sequence[Optional[Tensor]], k: int):
    """One merge stage: the candidate sets (q, kl_i) of the shards along
    one mesh axis, in axis order, reduced to their pooled first-occurrence
    top-k (``flat.merge_topk`` over the pooled columns): -inf / id 0 fill
    when k exceeds the pool. A shard that did not run is None and adds
    nothing; all None gives None."""
    live = [j for j, v in enumerate(vals) if v is not None]
    if not live:
        return None, None
    top, ids, _ = _pool([vals[j] for j in live], [idx[j] for j in live], [],
                        k)
    return top, ids


def merge_over_axis_rows(vals: Sequence[Optional[Tensor]],
                         idx: Sequence[Optional[Tensor]],
                         rows: Sequence[Optional[tuple]], k: int):
    """``merge_over_axis`` carrying each candidate's PAYLOAD ROWS: ``rows``
    holds a tuple of (q, kl_i, dim) arrays per shard, aligned with its
    candidates (e.g. the winners' re-rank vectors and filters); they come
    out selected with the same positions, zero rows on pad slots. The
    (vals, idx) are ``merge_over_axis``'s bit for bit."""
    live = [j for j, v in enumerate(vals) if v is not None]
    if not live:
        return None, None, None
    return _pool([vals[j] for j in live], [idx[j] for j in live],
                 [rows[j] for j in live], k)


def _gathered(vals, idx, rows):
    """A merge stage's sets as each member of its group holds them after
    the stage's all-gather. Where every set is marked with its positions
    (``sharding.mark``: a cost trace's sharded step), views of them marked
    with all the members' positions, and those positions: the stage's work
    inside their ``sharding.scope`` counts for each member, as SPMD runs
    it. Elsewhere the sets as they are, and None."""
    from repro_torch.distributed.sharding import mark, marked
    marks = [marked(v) for v in vals if v is not None]
    if not marks or any(m is None for m in marks):
        return vals, idx, rows, None
    pos = frozenset().union(*marks)

    def held(t):
        return None if t is None else mark(t.view(t.shape), pos)

    return ([held(v) for v in vals], [held(i) for i in idx],
            None if rows is None else
            [None if r is None else tuple(held(x) for x in r) for r in rows],
            pos)


def _tree(vals, idx, rows, sizes, k, inner: Optional[int] = None):
    """The merge stages, the last mesh axis first: a stage keeps min(k,
    pool) candidates, or ``inner`` before the last stage when given. In a
    cost trace each group's stage counts for its members (``_gathered``)."""
    from repro_torch.distributed.sharding import scope
    vals, idx = list(vals), list(idx)
    rows = list(rows) if rows is not None else None
    stages = list(reversed(tuple(int(s) for s in sizes)))
    for j, n_ax in enumerate(stages):
        nv, ni, nr = [], [], []
        for g in range(0, len(vals), n_ax):
            widths = [v.shape[-1] for v in vals[g:g + n_ax] if v is not None]
            keep = min(k, sum(widths)) if widths else k
            if inner and j < len(stages) - 1:
                keep = inner
            gv, gi, gr, pos = _gathered(
                vals[g:g + n_ax], idx[g:g + n_ax],
                None if rows is None else rows[g:g + n_ax])
            with scope(pos) if pos is not None else contextlib.nullcontext():
                if rows is None:
                    v, i = merge_over_axis(gv, gi, keep)
                    r = None
                else:
                    v, i, r = merge_over_axis_rows(gv, gi, gr, keep)
            nv.append(v), ni.append(i), nr.append(r)
        vals, idx = nv, ni
        rows = nr if rows is not None else None
    return vals[0], idx[0], (rows[0] if rows is not None else None)


def tree_merge_topk(vals: Sequence[Optional[Tensor]],
                    idx: Sequence[Optional[Tensor]], sizes: Sequence[int],
                    k: int, *, like: Optional[Tensor] = None):
    """Hierarchical cross-shard top-k merge: the per-shard sets (linear
    shard order over the mesh axes of extents ``sizes``) go through one
    exact merge stage per axis, the last axis first. Stages keep min(k,
    pool) candidates; the result (q, k) equals the global first-occurrence
    top-k over every shard's set, -inf / id 0 filling what the sets cannot.
    When no shard ran, ``like`` (a (q, ...) tensor) gives the batch and
    device of an all -inf result."""
    v, i, _ = _tree(vals, idx, None, sizes, k)
    if v is None:
        return _empty(like, k)
    if v.shape[-1] < k:
        v, i, _ = _pool([v], [i], [], k)
    return v, i


def tree_merge_topk_rows(vals: Sequence[Optional[Tensor]],
                         idx: Sequence[Optional[Tensor]],
                         rows: Sequence[Optional[tuple]],
                         sizes: Sequence[int], k: int, *,
                         like: Optional[Tensor] = None,
                         widths: Sequence[int] = ()):
    """``tree_merge_topk`` carrying payload rows through every stage
    (``merge_over_axis_rows``); bit-equal (vals, idx). ``widths`` gives the
    rows' last dims for the all-skipped result."""
    v, i, r = _tree(vals, idx, rows, sizes, k)
    if v is None:
        v, i = _empty(like, k)
        return v, i, tuple(v.new_zeros((*v.shape, w)) for w in widths)
    if v.shape[-1] < k:
        v, i, r = _pool([v], [i], [r], k)
    return v, i, r


def _empty(like: Tensor, k: int):
    b = like.shape[0]
    return (torch.full((b, k), float("-inf"), device=like.device),
            torch.zeros((b, k), dtype=torch.int32, device=like.device))


def _blocks(n: int, ns: int):
    nl = -(-n // ns)
    return nl, [(s * nl, min(n, (s + 1) * nl)) for s in range(ns)]


def holders_of(mesh, axes: Sequence[str]) -> List[list]:
    """The flat mesh indices of the positions holding each row block of a
    layout over ``axes`` (linear shard order): the block's coordinates
    along ``axes``, any along the mesh's other axes."""
    from repro_torch.distributed.sharding import positions
    sizes = tuple(mesh.shape[a] for a in axes)
    out: List[list] = [[] for _ in range(int(np.prod(sizes)))]
    for flat, (_, c) in enumerate(positions(mesh)):
        out[linear_shard_index(axes, sizes, c)].append(flat)
    return out


def merge_stats(stats, mesh, axes: Sequence[str], q: int, width: int,
                inner: int) -> None:
    """Record ``_tree``'s merge stages, the last axis first, as the
    reference's ``shard_map`` runs them: each the all-gather over its axis
    of every position's candidate set (q x its width values and ids, 8
    bytes a candidate), ``width`` the blocks' sets at the first stage and
    ``inner`` at the others."""
    for ax in reversed(tuple(axes)):
        stats.add("all-gather", ax, mesh.size * q * width * 8)
        width = inner


def sharded_search_fn(mesh, shard_axes: Sequence[str], k: int,
                      k_local: int = 0, stats=None):
    """An exact search over a corpus split into row-contiguous blocks over
    ``shard_axes``: fn(vectors (n, d), sq_norms (n,), queries (q, d)) ->
    (vals (q, k), ids (q, k) int32). Each block runs the fused scan
    (``ops.score_topk``) on its position's device for min(k_local, n_local)
    candidates with global ids, and the tree merge keeps k_local until its
    last stage. ``k_local`` > 0 truncates the per-shard sets
    (statistically safe when it well exceeds k / n_shards times the merge
    fan-in); 0 keeps k. ``vectors`` and ``sq_norms`` may be whole, or
    ``Placed`` in row blocks over ``shard_axes`` (the blocks are read as
    they are). Each block's scan runs under ``sharding.scope`` of the
    positions holding it; ``stats`` (a ``CollectiveStats``) records each
    merge stage as the all-gather of every position's candidate set
    (values and ids), as the reference's ``shard_map`` merges them."""
    from repro_torch.distributed.sharding import Placed, scope
    from repro_torch.index.slab import axes_size, shard_devices

    axes = tuple(shard_axes)
    sizes = tuple(mesh.shape[a] for a in axes)
    ns = axes_size(mesh, axes)
    devs = shard_devices(mesh, axes)
    kl = k_local if k_local and k_local < k else k
    holders = holders_of(mesh, axes)

    def fn(vectors, sq_norms, queries: Tensor):
        placed = isinstance(vectors, Placed)
        nl, blocks = _blocks(vectors.shape[0], ns)
        vals, ids = [], []
        for s, (lo, hi) in enumerate(blocks):
            if hi <= lo:
                vals.append(None), ids.append(None)
                continue
            dev = devs[s]
            with scope(holders[s]):
                if placed:
                    c = shard_coords(s, axes, sizes)
                    rows, norms = vectors.block(c), sq_norms.block(c)
                else:
                    rows, norms = vectors[lo:hi], sq_norms[lo:hi]
                v, i = ops.score_topk(rows.to(dev), norms.to(dev),
                                      queries.to(dev), min(kl, hi - lo))
                vals.append(v.to(queries.device))
                ids.append(i.to(queries.device) + lo)
        if stats is not None:
            merge_stats(stats, mesh, axes, queries.shape[0],
                        max(v.shape[-1] for v in vals if v is not None), kl)
        v, i, _ = _tree(vals, ids, None, sizes, k, inner=kl)
        if v is None:
            return _empty(queries, k)
        return v, i

    return fn


def routed_search_fn(mesh, shard_axes: Sequence[str], k: int,
                     degraded: bool = False):
    """``sharded_search_fn`` with a per-query shard mask: fn(vectors,
    sq_norms, queries, probe_mask (q, n_shards) bool[, alive (n_shards,)
    bool]). A query's candidates come only from the shards its mask row
    selects (the others' scores read -inf for it), and a shard no query
    selects launches nothing. ``degraded=True`` takes an ``alive`` mask: a
    dead shard launches nothing for any query (dead == never routed). The
    mask's columns are read on the host once a call."""
    from repro_torch.index.slab import axes_size, shard_devices

    axes = tuple(shard_axes)
    sizes = tuple(mesh.shape[a] for a in axes)
    ns = axes_size(mesh, axes)
    devs = shard_devices(mesh, axes)

    def fn(vectors: Tensor, sq_norms: Tensor, queries: Tensor,
           probe_mask: Tensor, alive: Optional[Tensor] = None):
        if degraded:
            probe_mask = probe_mask & torch.as_tensor(
                alive, dtype=torch.bool, device=probe_mask.device)[None, :]
        run = probe_mask.any(dim=0).cpu().numpy()
        nl, blocks = _blocks(vectors.shape[0], ns)
        vals, ids = [], []
        for s, (lo, hi) in enumerate(blocks):
            if hi <= lo or not run[s]:
                vals.append(None), ids.append(None)
                continue
            dev = devs[s]
            v, i = ops.score_topk(vectors[lo:hi].to(dev),
                                  sq_norms[lo:hi].to(dev),
                                  queries.to(dev), min(k, hi - lo))
            mine = probe_mask[:, s].to(v.device)[:, None]
            vals.append(torch.where(mine, v, float("-inf")).to(
                queries.device))
            ids.append(i.to(queries.device) + lo)
        return tree_merge_topk(vals, ids, sizes, k, like=queries)

    return fn


def affinity_group_layout(centers, sizes, n_shards: int,
                          slot_capacity: Optional[int] = None,
                          row_slack: float = 1.3, seeds=None) -> np.ndarray:
    """Shard assignment for groups (psi-clusters / inverted lists) that
    packs NEARBY groups onto the SAME shard under balance caps.

    ``centers`` (ng, d) group centers, ``sizes`` (ng,) row counts. One
    region seed per shard (``seeds`` (n_shards, d), or a small k-means over
    the centers with the port's seed-0 generator when None: the reference
    draws it from its PRNG, so a comparison hands the seeds over); groups
    are placed largest-first onto the nearest seed with a free slot (at most
    ``slot_capacity`` groups a shard) and row headroom (``row_slack`` x the
    mean shard load), else onto the least-loaded shard with a free slot.
    Returns shard_of_group (ng,) int32. Host code, the reference's bit for
    bit given the same seeds."""
    centers = np.asarray(centers, np.float32)
    sizes = np.asarray(sizes, np.int64)
    ng = centers.shape[0]
    if n_shards <= 1:
        return np.zeros((ng,), np.int32)
    if ng <= n_shards:
        return np.arange(ng, dtype=np.int32) % n_shards
    if seeds is None:
        seeds, _ = kmeans(torch.as_tensor(centers), n_shards, iters=10,
                          generator=0)
    if isinstance(seeds, torch.Tensor):
        seeds = seeds.cpu().numpy()
    seeds = np.asarray(seeds, np.float32)
    d2 = np.sum((centers[:, None, :] - seeds[None]) ** 2, axis=-1)
    cap_rows = int(np.ceil(sizes.sum() / n_shards * row_slack))
    cap_slots = slot_capacity if slot_capacity is not None else ng
    load = np.zeros(n_shards, np.int64)
    used = np.zeros(n_shards, np.int64)
    shard_of = np.zeros(ng, np.int32)
    for g in np.argsort(-sizes, kind="stable"):
        placed = False
        for s in np.argsort(d2[g], kind="stable"):
            if used[s] < cap_slots and load[s] + sizes[g] <= cap_rows:
                shard_of[g] = s
                placed = True
                break
        if not placed:
            free = np.nonzero(used < cap_slots)[0]
            shard_of[g] = free[np.argmin(load[free])]
        used[shard_of[g]] += 1
        load[shard_of[g]] += sizes[g]
    return shard_of


def cluster_sharded_layout(vectors: Tensor, centroids: Tensor,
                           n_shards: int, seeds=None, labels=None):
    """Permutation placing whole clusters on shards (filter-centric
    placement). Returns (perm (n // n_shards * n_shards,) int64 numpy,
    shard_of_cluster (ncl,) int32): shard s holds perm[s * target:(s + 1) *
    target], target = n // n_shards; clusters are packed by center affinity
    (``affinity_group_layout``, ``seeds`` as there) under a row-load cap,
    then each shard gives up its rows past ``target`` (last first) and the
    short shards take them back (last given first), as the reference's
    round-robin rebalance does; the n % n_shards rows left over are not in
    ``perm`` (the slab folds them back in id order). ``labels`` (n,) are
    the rows' nearest centroids (``assign`` when None)."""
    if labels is None:
        labels = assign(vectors.to(torch.float32), centroids)
    labels = torch.as_tensor(labels).cpu().numpy().astype(np.int64)
    n = labels.shape[0]
    c_np = torch.as_tensor(centroids).cpu().numpy().astype(np.float32)
    ncl = c_np.shape[0]
    sizes = np.bincount(labels, minlength=ncl)
    shard_of_cluster = affinity_group_layout(c_np, sizes, n_shards,
                                             seeds=seeds)
    by_cluster = np.argsort(labels, kind="stable")    # ascending ids a cluster
    starts = np.concatenate([[0], np.cumsum(sizes)])
    members = [np.concatenate(
        [by_cluster[starts[c]:starts[c + 1]]
         for c in range(ncl) if shard_of_cluster[c] == s]
        + [np.zeros((0,), np.int64)]) for s in range(n_shards)]
    target = n // n_shards
    overflow = []
    for s in range(n_shards):       # pop past target, last first
        if len(members[s]) > target:
            overflow.append(members[s][target:][::-1])
            members[s] = members[s][:target]
    overflow = (np.concatenate(overflow) if overflow
                else np.zeros((0,), np.int64))
    for s in range(n_shards):       # pop from the overflow's end
        need = target - len(members[s])
        if need > 0 and len(overflow):
            take = overflow[max(0, len(overflow) - need):][::-1]
            overflow = overflow[:len(overflow) - len(take)]
            members[s] = np.concatenate([members[s], take])
    perm = np.concatenate(members).astype(np.int64)
    return perm, shard_of_cluster
