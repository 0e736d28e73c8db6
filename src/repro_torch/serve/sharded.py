"""Sharded serving: the engine's batch step over the shards of a mesh.

``ShardedServing`` is the mesh counterpart of the meshless engine step.
The index's serving slab (``repro_torch.index.slab``) is split into one
block per shard (flat slabs by ROW, IVF slabs by whole LIST, PQ by row),
each block in its own tensors on its shard's device with its rows' global
ids and re-rank originals, and a batch runs:

  1. the query transform (B1) once, as the reference replicates it;
  2. candidate generation per shard, back to back on the current stream:
     flat, the fused scan over the block for min(k', n_local) + REFINE_PAD
     candidates and the exact refine (B3 carrying the winners' rows, or B2
     and a gather from the block); IVF, the coarse quantizer (B2) once,
     then each shard's dedup scan of the probed lists it owns (B6, or B5
     and a gather); PQ, the scan LUT (``pq_scan_luts``) once, then the
     fused ADC scan + top-k over each block's coarse-grouped rows;
  3. the cross-shard merge (``index.distributed.tree_merge_topk_rows``),
     first occurrence over the shard-major pool, carrying the rows;
  4. the combined-score re-rank (B4, ``ops.rescore_topk``) once over the
     merged k' candidates;
  5. the delta tier: split over the live shards and merged the same way
     (all of it, from the home device, when k'_delta covers it, as the
     meshless step takes it).

A shard that is skipped (routed away, dead, or empty) launches nothing and
none of its tensors is read: the reference's ``lax.cond`` zero-work branch
becomes a host loop that leaves it out.

Parity: every row's score is computed by the same kernel on the same
operands as in the meshless step (flat: the refine's rows are the same
(b, k' + REFINE_PAD, d) shape when n_local >= k' + REFINE_PAD; IVF: each
list scan scores a row against its member queries only; PQ: a row's ADC sum
reads only its codes), a shard holds at most k' of the global top-k', and
the merge keeps the meshless order, so the results equal the meshless
engine's bit for bit.

Routed serving (``routing="routed"``): IVF routes each query to the shards
owning its probed lists, which is exact. Flat (``placement="cluster"``)
probes the ``router_nprobe`` nearest psi-clusters and activates the shards
holding their rows; the ball bound ||q - x|| >= ||q - mu_c|| - r_c over the
clusters with rows on inactive shards gives a per-query flag, and the
engine re-runs flagged queries through the dense step. The route mask goes
to the host once a batch; a shard no query routes to launches nothing.

Degraded serving (``alive=``): dead shards are skipped in every stage
(scan, delta, rows), and a per-query certificate says whether the dead
shards could have held a top-k' candidate: flat cluster by the ball
bound, IVF by probed-list ownership, contiguous flat and PQ conservatively
(every query while a shard is dead). A certificate may over-flag and never
under-flags. Mirrors ``repro.serve.sharded``.

Home-side state: the engine keeps its meshless index whole on the home
device beside the shards' blocks. ``save`` and ``heal`` checkpoint it,
``insert``/``compact`` rebuild from it and the fold plan scans it; the
engine's attribute table stays there too, and predicate search takes
each shard's eligible count from it through ``row_owner``. So one card
holds the corpus about twice, and on several cards the home card would
still hold all of it: sharding adds no capacity until that state moves
off the home device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import AxisRules
from repro_torch.index import flat as flat_mod
from repro_torch.index import slab as slab_mod
from repro_torch.index.distributed import tree_merge_topk_rows
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_first

Tensor = torch.Tensor

# safety margin on the routed clipping check and the coverage certificate:
# the ball bound is exact in real arithmetic, but center distances, radii
# and refined scores each carry ~1e-7-relative fp32 rounding; an absolute
# floor plus ~100x fp32 eps relative (a few spurious fallbacks, never a
# missed one)
ROUTER_EPS = 1e-3
ROUTER_RTOL = 1e-5


def _cluster_bounds(q_t: Tensor, centers: Tensor, radii: Tensor):
    """Per-(query, cluster) exact center distances and ball-bound scores:
    (d2 (b, ncl), ub (b, ncl)), ``ub`` the best score (negative squared
    L2) any row of the cluster could reach, from ||q - x|| >= ||q - mu_c||
    - r_c. The distances use the direct (q - mu)^2 form: the bound must
    never be underestimated through the expansion's cancellation."""
    d2 = torch.sum((q_t[:, None, :] - centers[None]) ** 2, dim=-1)
    ub = -torch.clamp(torch.sqrt(d2) - radii[None, :], min=0.0) ** 2
    return d2, ub


def _flat_router(q_t: Tensor, centers: Tensor, radii: Tensor,
                 incidence: Tensor, router_nprobe: int,
                 d2: Optional[Tensor] = None, ub: Optional[Tensor] = None):
    """Per-query shard mask + clipping bound for cluster-placed flat slabs.
    Probes the ``router_nprobe`` nearest psi-clusters (first occurrence on
    ties) and activates every shard holding rows of a probed cluster.
    Returns (route_mask (b, ns) bool, bound (b,)): ``bound`` is the best
    ball-bound score of a row on a NON-activated shard, which the step
    holds against the k'-th routed candidate."""
    ncl = centers.shape[0]
    r = min(router_nprobe, ncl)
    if d2 is None:
        d2, ub = _cluster_bounds(q_t, centers, radii)
    _, probe = topk_first(-d2, r)
    probed = torch.zeros_like(d2).scatter_(1, probe, 1.0)      # (b, ncl)
    route_mask = (probed @ incidence) > 0.0                      # (b, ns)
    # clusters with a row on a non-activated shard may be clipped; probed
    # clusters never qualify (they activate all their shards)
    inactive = 1.0 - route_mask.to(torch.float32)
    clipped = (inactive @ incidence.T) > 0.0                     # (b, ncl)
    has_rows = torch.sum(incidence, dim=-1) > 0.0
    bound = torch.max(torch.where(clipped & has_rows[None, :], ub,
                                  float("-inf")), dim=-1).values
    return route_mask, bound


@dataclasses.dataclass
class ShardedDelta:
    """The delta tier split over the live shards: ``shards[s]`` is shard
    s's block of pending rows (a ``slab.FlatShard`` whose ids are
    delta-local), None on a dead shard. ``nd`` is the pending row count;
    ``vn`` / ``fn`` are the pending rows' re-rank originals on the home
    device, which the step reads whole when k'_delta covers them."""

    shards: List[Optional[slab_mod.FlatShard]]
    nd: int
    vn: Tensor
    fn: Tensor


def _to(x: Tensor, dev: torch.device) -> Tensor:
    return x if x.device == dev else x.to(dev)


def _flat_block_topk(sh: slab_mod.FlatShard, q_t: Tensor, kl: int,
                     gather_free: bool, home: torch.device):
    """One block's flat candidates, ``flat.search_rows`` (B3 carrying the
    winners' re-rank rows) or ``flat.search`` (B2) and a gather from the
    block, for min(kl, n_s): (vals, global ids, (rows_v, rows_f)) on
    ``home``."""
    qd = _to(q_t, sh.device)
    if gather_free:
        vals, lpos, rv, rf = flat_mod.search_rows(sh.index, qd, kl, sh.pv,
                                                  sh.pf)
    else:
        vals, lpos = flat_mod.search(sh.index, qd, kl)
        rv, rf = sh.pv[lpos.long()], sh.pf[lpos.long()]
    ids = sh.row_ids[lpos.long()]
    return (_to(vals, home), _to(ids, home), (_to(rv, home), _to(rf, home)))


class ShardedServing:
    """Sharded slabs + the sharded batch steps for one (index, mesh) pair.

    Construction splits the serving state once (``slab.shard``, with the
    re-rank originals and, for predicate search, the RAW attribute table
    ``attrs``). ``routing="routed"`` enables the routed step; on the flat
    backend it needs ``placement="cluster"``, and ``router_centers`` pins
    the psi-cluster geometry (e.g. restored from a checkpoint). For IVF,
    ``placement="cluster"`` means ``"affinity"`` packing."""

    def __init__(self, index, mesh, rules=None, *,
                 placement: str = "contiguous", routing: str = "dense",
                 router_nprobe: int = 0,
                 router_centers: Optional[Tensor] = None,
                 attrs: Optional[np.ndarray] = None):
        if routing not in ("dense", "routed"):
            raise ValueError(
                f"routing must be 'dense' or 'routed', got {routing!r}")
        self.index = index
        self.mesh = mesh
        self.rules = rules if rules is not None else AxisRules(mesh)
        self.placement = placement
        self.routing = routing
        self.home = index.device
        cfg = index.config
        payload = (index.vectors_n, index.filters_n)
        if cfg.backend == "flat":
            if routing == "routed" and placement != "cluster":
                raise ValueError(
                    "routing='routed' on the flat backend requires "
                    "placement='cluster': the router needs the psi-cluster "
                    "ownership tables of filter-centric placement")
            self.slab = index.backend.slab().shard(
                mesh, self.rules, placement=placement, centers=router_centers,
                payload=payload, attrs=attrs)
        elif cfg.backend == "ivf":
            # "cluster" = filter-centric placement: affinity packing keeps a
            # query's co-probed lists on few shards
            ivf_placement = "affinity" if placement == "cluster" else placement
            self.slab = index.backend.slab().shard(
                mesh, self.rules, placement=ivf_placement,
                list_sizes=index.backend.list_sizes, payload=payload,
                attrs=attrs)
        elif cfg.backend == "pq":
            if routing == "routed":
                raise ValueError(
                    "routing='routed' is not supported for the PQ backend: "
                    "ADC codes carry no per-shard routing geometry "
                    "(contiguous row placement only)")
            self.slab = index.backend.slab().shard(mesh, self.rules,
                                                   placement=placement,
                                                   payload=payload)
        else:
            raise NotImplementedError(
                f"sharded serving supports the flat/ivf/pq backends, not "
                f"{cfg.backend!r}")
        self.axes = self.slab.axes
        self.sizes = tuple(mesh.shape[a] for a in self.axes)
        self.n_shards = self.slab.n_shards
        self.devices = slab_mod.shard_devices(mesh, self.axes)
        # the flat router probes ~two shards' worth of psi-clusters by
        # default: the bound usually certifies, and localized filtered
        # traffic still leaves most shards unprobed
        if self._has_flat_router():
            ncl = self.slab.router_centers.shape[0]
            self.router_nprobe = (router_nprobe if router_nprobe > 0
                                  else max(1, (2 * ncl) // max(self.n_shards,
                                                               1)))
        else:
            self.router_nprobe = max(router_nprobe, 1)
        if cfg.backend == "ivf":
            self._l2s = torch.as_tensor(self.slab.list_to_shard,
                                        dtype=torch.int64, device=self.home)
            self._slot = torch.as_tensor(self.slab.slot_in_shard,
                                         dtype=torch.int32, device=self.home)
        # corpus row 0's re-rank rows stand in for unfilled (-inf) slots, as
        # the meshless id-0 gather gives them; kept whole, so no step reads
        # a dead shard's block for them
        self.vn0 = index.vectors_n[0].clone()
        self.fn0 = index.filters_n[0].clone()
        self.row_owner = self._row_owner()
        self.last_active = 0     # shards the last step launched

    def _has_flat_router(self) -> bool:
        return (self.index.config.backend == "flat"
                and self.slab.router_centers is not None)

    # -- delta ------------------------------------------------------------
    def shard_delta(self, delta, alive: Optional[np.ndarray] = None
                    ) -> ShardedDelta:
        """Split the engine's delta buffer (``engine._DeltaBuffer``) into
        contiguous blocks over the live shards (all, with ``alive`` None).
        The pending rows are host-durable, so every one of them serves
        while shards are dead."""
        nd = delta.vn.shape[0]
        live = [s for s in range(self.n_shards)
                if alive is None or alive[s]]
        nl = -(-nd // len(live))
        shards: List[Optional[slab_mod.FlatShard]] = [None] * self.n_shards
        fl = delta.flat
        for j, s in enumerate(live):
            lo, hi = min(nd, j * nl), min(nd, (j + 1) * nl)
            idx = torch.arange(lo, hi, device=delta.vn.device)
            shards[s] = slab_mod.flat_shard(fl.vectors, fl.sq_norms,
                                            fl.scales, idx,
                                            (delta.vn, delta.fn),
                                            self.devices[s])
        return ShardedDelta(shards=shards, nd=nd, vn=delta.vn, fn=delta.fn)

    # -- dispatch-layer routing -------------------------------------------
    def route_masks(self, q_t: Tensor):
        """(route_mask (b, ns) bool, bound (b,) or None, probe (b, nprobe)
        or None): the routed step's router on transformed queries (flat:
        psi-clusters; IVF: the coarse quantizer's probes and their owners)."""
        b = q_t.shape[0]
        if self._has_flat_router():
            s = self.slab
            d2, ub = _cluster_bounds(q_t, s.router_centers, s.router_radii)
            mask, bound = _flat_router(q_t, s.router_centers, s.router_radii,
                                       s.cluster_to_shard, self.router_nprobe,
                                       d2, ub)
            return mask, bound, None
        if self.index.config.backend == "ivf":
            probe = self._probe(q_t)
            mask = torch.zeros((b, self.n_shards), dtype=torch.bool,
                               device=q_t.device)
            mask.scatter_(1, self._l2s[probe.long()], True)
            return mask, None, probe
        return (torch.ones((b, self.n_shards), dtype=torch.bool,
                           device=q_t.device), None, None)

    def route_signatures(self, q: np.ndarray, f: np.ndarray) -> np.ndarray:
        """Per-query active-shard bitmasks for dispatch-layer regrouping:
        (n, ceil(n_shards / 8)) uint8 packed bits, bit s set when the query
        routes to shard s, from the same router code as the routed step
        (so the grouping matches the step's route mask). Sorting a queue by
        signature puts co-routed queries in one padded batch, which is what
        lets a shard skip."""
        tfm = self.index.transform
        out = []
        chunk = 256   # bounds the flat (chunk, ncl, d) difference
        for s in range(0, q.shape[0], chunk):
            qn, fqn = tfm.normalize(
                torch.as_tensor(q[s:s + chunk], device=self.home),
                torch.as_tensor(f[s:s + chunk], device=self.home))
            mask = self.route_masks(tfm.apply_normalized(qn, fqn))[0]
            out.append(mask.cpu().numpy())
        return np.packbits(np.concatenate(out), axis=1)

    # -- the sharded batch step -------------------------------------------
    def step(self, delta: Optional[ShardedDelta], q: Tensor, f: Tensor, *,
             k: int, kp: int, kd: int, routed: bool = False,
             alive: Optional[np.ndarray] = None, gather_free: bool = False):
        """One padded batch; the meshless step's contract: (scores (b, k),
        ids (b, k), margin (b,)). With ``routed=True`` two outputs follow:
        the clipping flag (b,) bool (True = routing may have clipped the
        dense top-k'; re-run dense) and the route mask (b, n_shards) bool.
        ``alive`` ((n_shards,) bool numpy, None = all healthy) serves
        DEGRADED: dead shards launch nothing, and one more output,
        ``uncovered`` (b,) bool, follows (True = the dead shards could have
        held a top-k' candidate). ``gather_free`` picks B3/B6 carrying the
        winners' rows over B2/B5 and a gather from the block (PQ always
        gathers); the results are the same bits. ``self.last_active`` is
        the number of shards whose scan ran."""
        index = self.index
        cfg = index.config
        degraded = alive is not None
        run = np.array([self._block_size(s) > 0
                        for s in range(self.n_shards)])
        if degraded:
            run &= np.asarray(alive, bool)
        tfm = index.transform
        qn, fqn = tfm.normalize(q, f)
        q_t = tfm.apply_normalized(qn, fqn)
        b = q.shape[0]
        route_mask = bound = probe = None
        routed_flat = routed and self._has_flat_router()
        need_route = routed_flat or (cfg.backend == "ivf"
                                     and (routed or degraded))
        if need_route:
            route_mask, bound, probe = self.route_masks(q_t)
            if routed:
                run &= route_mask.any(dim=0).cpu().numpy()  # one sync
        if cfg.backend == "flat":
            vals, gids, rows = self._flat(q_t, kp, run, route_mask
                                          if routed_flat else None,
                                          gather_free)
        elif cfg.backend == "ivf":
            vals, gids, rows = self._ivf(q_t, kp, run, probe, gather_free)
        else:
            vals, gids, rows = self._pq(q_t, kp, run)
        self.last_active = int(run.sum())
        kth = vals[:, -1]
        # unfilled slots take the meshless id-0 convention: id 0 and corpus
        # row 0's re-rank rows
        dead = torch.isneginf(vals)
        gids = torch.where(dead, 0, torch.clamp(gids, min=0))
        rv = torch.where(dead[..., None], self.vn0, rows[0])
        rf = torch.where(dead[..., None], self.fn0, rows[1])
        scores, ids = ops.rescore_topk(rv, rf, qn, fqn, cfg.lam, gids, k)
        if delta is not None:
            scores, ids = self._delta(delta, q_t, qn, fqn, scores, ids, k=k,
                                      kd=kd, gather_free=gather_free)
        out = (scores, ids, scores[:, 0] - scores[:, -1])
        if routed:
            if routed_flat:
                # may routing have clipped the dense top-k'? A -inf k'-th
                # value (the routed pool could not fill k') flags always
                tol = ROUTER_EPS + ROUTER_RTOL * torch.abs(kth)
                flag = bound >= kth - tol
            else:
                # IVF routing (and a mesh with no router) is exact
                flag = torch.zeros((b,), dtype=torch.bool, device=q.device)
                if route_mask is None:
                    route_mask = torch.ones((b, self.n_shards),
                                            dtype=torch.bool,
                                            device=q.device)
            out = out + (flag, route_mask)
        if degraded:
            out = out + (self._uncovered(q_t, kth, alive, probe),)
        return out

    def _block_size(self, s: int) -> int:
        sh = self.slab.shards[s]
        return sh.count if isinstance(sh, slab_mod.IVFShard) else sh.size

    def _merge(self, vals, ids, rows, kp: int, like: Tensor):
        d = self.index.vectors_n.shape[-1]
        m = self.index.filters_n.shape[-1]
        return tree_merge_topk_rows(vals, ids, rows, self.sizes, kp,
                                    like=like, widths=(d, m))

    def _flat(self, q_t: Tensor, kp: int, run: np.ndarray,
              route_mask: Optional[Tensor], gather_free: bool):
        kl = min(kp, self.slab.n_local)
        vals, ids, rows = [], [], []
        for s, sh in enumerate(self.slab.shards):
            if not run[s]:
                vals.append(None), ids.append(None), rows.append(None)
                continue
            v, g, r = _flat_block_topk(sh, q_t, kl, gather_free, self.home)
            if route_mask is not None:
                # routing masks VALUES only: a query's candidates from a
                # shard it does not route to lose the merge as -inf slots
                v = torch.where(route_mask[:, s:s + 1], v, float("-inf"))
            vals.append(v), ids.append(g), rows.append(r)
        return self._merge(vals, ids, rows, kp, q_t)

    def _probe(self, q_t: Tensor) -> Tensor:
        """The coarse quantizer (B2 over the centroids), once a batch."""
        s = self.slab
        nprobe = min(self.index.config.nprobe, s.nlist)
        return ops.score_topk(s.centroids, s.c_sq, q_t, nprobe)[1]

    def _ivf(self, q_t: Tensor, kp: int, run: np.ndarray,
             probe: Optional[Tensor], gather_free: bool):
        s = self.slab
        nprobe = min(self.index.config.nprobe, s.nlist)
        kl = min(kp, nprobe * s.max_list)
        if probe is None:
            probe = self._probe(q_t)
        q2 = torch.sum(q_t * q_t, dim=-1, keepdim=True)
        owner = self._l2s[probe.long()]
        slot = self._slot[probe.long()]
        d, m = s.shards[0].pv.shape[-1], s.shards[0].pf.shape[-1]
        vals, ids, rows = [], [], []
        for i, sh in enumerate(s.shards):
            if not run[i]:
                vals.append(None), ids.append(None), rows.append(None)
                continue
            dev = sh.device
            # the probes this shard owns, at their local slots; the others
            # go to a sentinel slot whose member row is cleared (a source
            # with no member query is not read), as tail slots are
            local = _to(torch.where(owner == i, slot, sh.count), dev)
            uniq, member = ops.dedup_probes(local.to(torch.int32),
                                            sh.count + 1)
            sentinel = uniq == sh.count
            member = member * (~sentinel)[:, None]
            uniq = torch.where(sentinel, 0, uniq).contiguous()
            qd = _to(q_t, dev)
            if gather_free:
                v, fid, rv, rf = ops.ivf_score_topk_dedup_rows(
                    sh.grouped, sh.grouped_sq, sh.valid, uniq, member, qd,
                    sh.pv, sh.pf, kl, scales=sh.grouped_scales)
            else:
                v, fid = ops.ivf_score_topk_dedup(
                    sh.grouped, sh.grouped_sq, sh.valid, uniq, member, qd,
                    kl, scales=sh.grouped_scales)
                rv = sh.pv.reshape(-1, d)[fid.long()]
                rf = sh.pf.reshape(-1, m)[fid.long()]
            v = v - _to(q2, dev)
            g = sh.lists.reshape(-1)[fid.long()]
            vals.append(_to(v, self.home)), ids.append(_to(g, self.home))
            rows.append((_to(rv, self.home), _to(rf, self.home)))
        return self._merge(vals, ids, rows, kp, q_t)

    def _pq(self, q_t: Tensor, kp: int, run: np.ndarray):
        s = self.slab
        luts = ops.pq_scan_luts(q_t.contiguous(), s.codebooks,
                                s.coarse_centers, s.coarse_dot, s.cb_sq)
        kl = min(kp, s.n_local)
        vals, ids, rows = [], [], []
        for i, sh in enumerate(s.shards):
            if not run[i]:
                vals.append(None), ids.append(None), rows.append(None)
                continue
            v, lid = ops.pq_score_topk(sh.ccodes, _to(luts, sh.device),
                                       min(kl, sh.size), sh.grouped)
            li = lid.long()
            vals.append(_to(v, self.home))
            ids.append(_to(lid + sh.offset, self.home))
            rows.append((_to(sh.pv[li], self.home), _to(sh.pf[li],
                                                        self.home)))
        return self._merge(vals, ids, rows, kp, q_t)

    def _delta(self, delta: ShardedDelta, q_t: Tensor, qn: Tensor,
               fqn: Tensor, scores: Tensor, ids: Tensor, *, k: int, kd: int,
               gather_free: bool):
        """The delta tier: every pending row when kd covers them (the
        meshless step takes them all, in order), else each live block's
        scan + refine for min(kd, block) and the merge; then the re-rank
        and the merge with the main tier."""
        index = self.index
        b = q_t.shape[0]
        if kd >= delta.nd:
            dcand = torch.arange(delta.nd, dtype=torch.int32,
                                 device=self.home).expand(b, delta.nd)
            rows = dcand.long()
            drv, drf = delta.vn[rows], delta.fn[rows]
        else:
            vals, dids, drows = [], [], []
            for sh in delta.shards:
                if sh is None or sh.size == 0:
                    vals.append(None), dids.append(None), drows.append(None)
                    continue
                v, g, r = _flat_block_topk(sh, q_t, kd, gather_free,
                                           self.home)
                vals.append(v), dids.append(g), drows.append(r)
            _, dcand, (drv, drf) = self._merge(vals, dids, drows, kd, q_t)
        dvals, dsel = ops.rescore_topk(drv, drf, qn, fqn, index.config.lam,
                                       dcand, min(k, kd))
        dsel = index.size + dsel
        return flat_mod.merge_topk(scores, ids, dvals, dsel.to(ids.dtype), k)

    def _uncovered(self, q_t: Tensor, kth: Tensor, alive: np.ndarray,
                   probe: Optional[Tensor]) -> Tensor:
        """The coverage certificate against the HEALTHY corpus: could the
        dead shards have held a top-k' candidate of the query?"""
        b = q_t.shape[0]
        dead_np = ~np.asarray(alive, bool)
        backend = self.index.config.backend
        if self._has_flat_router():
            s = self.slab
            _, ub = _cluster_bounds(q_t, s.router_centers, s.router_radii)
            dead = torch.as_tensor(dead_np, dtype=torch.float32,
                                   device=q_t.device)
            inc = s.cluster_to_shard
            dead_cl = ((inc @ dead) > 0.0) & (torch.sum(inc, dim=-1) > 0.0)
            dead_bound = torch.max(torch.where(dead_cl[None, :], ub,
                                               float("-inf")), dim=-1).values
            # a -inf k'-th value flags, conservatively
            tol = ROUTER_EPS + ROUTER_RTOL * torch.abs(kth)
            return dead_bound >= kth - tol
        if backend == "ivf":
            # exact: the query is affected iff a probed list is dead
            dead = torch.as_tensor(dead_np, device=q_t.device)
            return torch.any(dead[self._l2s[probe.long()]], dim=1)
        # contiguous flat / PQ have no routing geometry: every query while
        # any shard is dead
        return torch.full((b,), bool(dead_np.any()), device=q_t.device)

    def _row_owner(self) -> Tensor:
        """(index.size,) int64 on the home device: the shard owning each
        corpus row under the slab placement (flat: its slab block; IVF: its
        list's shard; PQ: its row block). Built from the home tables, so
        reading it never touches a shard's block."""
        n = self.index.size
        backend = self.index.config.backend
        pos = torch.arange(n, device=self.home)
        if backend == "flat":
            perm = torch.as_tensor(self.slab.perm, dtype=torch.int64,
                                   device=self.home)
            owner = torch.empty((n,), dtype=torch.int64, device=self.home)
            owner[perm] = pos // self.slab.n_local
            return owner
        if backend == "ivf":
            lists = self.index.backend.lists.long()           # (nlist, L)
            live = lists >= 0
            owner = torch.empty((n,), dtype=torch.int64, device=self.home)
            owner[lists[live]] = self._l2s[:, None].expand_as(lists)[live]
            return owner
        return pos // self.slab.n_local

    def slab_row_owner(self) -> np.ndarray:
        """(index.size,) int32 numpy ``row_owner``: the failure domain of
        degraded serving, a dead shard removes exactly these rows from the
        candidate space."""
        return self.row_owner.cpu().numpy().astype(np.int32)

    # -- the sharded filtered (predicate) step ----------------------------
    def eligibility(self, arrays, elig: Tensor,
                    alive: Optional[np.ndarray] = None) -> tuple:
        """Each live shard's eligible rows under a compiled predicate
        (``arrays``: ``CompiledPredicate.as_arrays`` on the home device),
        evaluated over the block's RAW attributes (NaN pad slots never
        match), None on a dead shard; and every shard's eligible count
        (n_shards,) numpy, dead ones included, from the home eligibility
        ``elig`` (index.size,) and ``row_owner``: one host read, and no
        dead shard's block is read."""
        from repro_torch.core.filters import eval_mask

        eligs = []
        for s, sh in enumerate(self.slab.shards):
            if alive is not None and not alive[s]:
                eligs.append(None)
                continue
            a = sh.attrs
            if a is None:
                raise ValueError(
                    "filtered_step needs attribute columns on the slab: "
                    "construct ShardedServing(..., attrs=<raw (n, m) table>)")
            a = a.reshape(-1, a.shape[-1])
            eligs.append(eval_mask(a, *(_to(x, sh.device) for x in arrays)))
        counts = torch.bincount(self.row_owner[elig],
                                minlength=self.n_shards)
        return eligs, counts.cpu().numpy()

    def filtered_step(self, q_t: Tensor, eligs, counts: np.ndarray, *, k: int,
                      kp: int, routed: bool = False,
                      alive: Optional[np.ndarray] = None):
        """Exact predicate-filtered top-k over the shards (the mask and
        routed plans). ``q_t`` (b, d) fold-transformed queries; ``eligs``,
        ``counts`` from ``eligibility``. Flat blocks run the masked scan
        (B2's masked variants) for min(kp, n_s) candidates; IVF blocks run
        B5 ``mask=`` over every list they hold (mask) or only the lists
        holding an eligible row (routed); each block refines its candidates
        exactly (``flat.filtered_d2``, (d2, global id)) and the blocks'
        top-k merge by the same sort. ``routed`` skips shards with no
        eligible row; dead shards (``alive``) are skipped. Returns (d2
        (b, k), ids (b, k)) with dead slots (+inf, DEAD_ID)."""
        backend = self.index.config.backend
        run = counts > 0 if routed else np.ones(len(counts), bool)
        if alive is not None:
            run &= np.asarray(alive, bool)
        if backend == "ivf" and routed:
            # the lists holding an eligible row, for the shards that run:
            # one host read
            shards = self.slab.shards
            runs = [i for i in range(self.n_shards)
                    if run[i] and shards[i].count > 0]
            starts = dict(zip(runs, np.cumsum(
                [0] + [shards[i].count for i in runs])))
            if runs:
                has = torch.cat([
                    _to(eligs[i].reshape(shards[i].count, -1).any(dim=1),
                        self.home) for i in runs]).cpu().numpy()
        d2s, idss = [], []
        for i, sh in enumerate(self.slab.shards):
            if not run[i] or self._block_size(i) == 0:
                continue
            dev = sh.device
            qd = _to(q_t, dev)
            e = eligs[i]
            if backend == "flat":
                kk = min(kp, sh.size)
                v, cand = ops.score_topk(sh.vectors, sh.sq_norms, qd, kk,
                                         scales=sh.scales,
                                         mask=e.to(torch.float32))
                d2, ids = flat_mod.filtered_refine(
                    sh.vectors, sh.scales, qd, torch.clamp(cand, min=0),
                    ~torch.isneginf(v), e, k, row_ids=sh.row_ids)
            else:
                b = qd.shape[0]
                if routed:
                    live = np.nonzero(
                        has[starts[i]:starts[i] + sh.count])[0]
                    slots = 1 << max(0, (len(live) - 1).bit_length())
                    uniq_np = np.full((slots,), live[0], np.int32)
                    uniq_np[:len(live)] = live
                    uniq = torch.as_tensor(uniq_np, device=dev)
                    member = (torch.arange(slots, device=dev)
                              < len(live))[:, None].to(torch.float32).expand(
                                  slots, b).contiguous()
                else:
                    slots = sh.count
                    uniq = torch.arange(slots, dtype=torch.int32, device=dev)
                    member = torch.ones((slots, b), device=dev)
                L, dd = sh.grouped.shape[1], sh.grouped.shape[2]
                kk = min(kp, slots * L)
                v, fid = ops.ivf_score_topk_dedup(
                    sh.grouped, sh.grouped_sq, sh.valid, uniq, member, qd,
                    kk, scales=sh.grouped_scales,
                    mask=e.reshape(sh.count, L).to(torch.float32))
                sc = (None if sh.grouped_scales is None
                      else sh.grouped_scales.reshape(-1))
                d2, ids = flat_mod.filtered_refine(
                    sh.grouped.reshape(-1, dd), sc, qd, fid,
                    ~torch.isneginf(v), e, k, row_ids=sh.lists.reshape(-1))
            d2s.append(_to(d2, self.home)), idss.append(_to(ids, self.home))
        b = q_t.shape[0]
        if not d2s:
            return (torch.full((b, k), float("inf"), device=self.home),
                    torch.full((b, k), flat_mod.DEAD_ID, dtype=torch.int32,
                               device=self.home))
        return flat_mod.lexsort_topk(torch.cat(d2s, dim=-1),
                                     torch.cat(idss, dim=-1), k)
