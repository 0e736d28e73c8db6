"""Batched FCVI serving engine, meshless (paper section 4.3, production shape).

The serving-side optimizations around one ``FCVIIndex``:

  * request batching (queries grouped into padded batches of
    ``batch_size``);
  * a filter-aware LRU result cache over quantized (query, filter) keys;
  * adaptive k' with two-stage escalation: a batch runs with the Thm 5.4
    k', and only the queries whose top-k score margin is ambiguous re-run
    with a wider k' in a power-of-two sub-batch;
  * a delta buffer for inserts with compaction into the main index.

The per-batch step (``_batch_step``) is normalize -> psi fold (fused
transform kernel) -> candidates -> combined-cosine re-rank, the scores and
their top-k in one launch (rescore kernel) -> delta-tier search +
``merge_topk`` -> escalation margin. The
flat backend's candidates are a scan + top-(k'+REFINE_PAD) (fused scan
kernel) and an exact refine; the IVF backend's are the coarse quantizer
(fused scan kernel over the centroids) and the probe-major scan of the
batch's unique probed lists (IVF dedup kernel); the PQ backend's are the
LUTs (LUT cross-term kernel) and the ADC scan of every row's codes (ADC
kernel) with a first-occurrence top-k. With ``gather_free`` the flat and
IVF scan kernels carry the winners' re-rank rows out; PQ always gathers
them by id, as the reference does. Eager PyTorch runs it as
it stands; there is no trace to count. Cache, stats and the escalation
decision are host-side.

Predicate search (``search(q, filter=F.range(...) & F.isin(...))``) runs
the filter algebra's physical plans: the planner (``serve/planner.py``)
picks ``fold`` (psi fold against the predicate's representative filter
point, the unmasked scan, a per-query certificate with a fallback to the
mask plan), ``mask`` (the scan with the eligibility as its mask operand:
B2's masked variants for flat, B5's ``mask=`` over every list for IVF) or
``routed`` (IVF: B5's ``mask=`` over only the lists holding an eligible
row). Every plan finishes in the same exact refine (``flat.filtered_d2``,
``flat.lexsort_topk``), so forced plans return the same bits.

Range predicates (``search_predicate(q, BoxPredicate(...))``) run the
multi-probe query (``fcvi.multi_probe_query``): ``multi_probe_r`` probes
spanning the box, their candidates merged and deduped, and a re-rank
against the nearest probe.

``save`` checkpoints the index state, the pending delta rows and the
attribute table in the JAX package's format (``repro_torch.checkpoint``),
and ``FCVIEngine.restore`` rebuilds an engine from it with no re-training;
checkpoints cross between the two packages both ways.

Sharded serving: ``FCVIEngine(index, cfg, mesh=make_mesh((8, 1), ("data",
"model")), placement=..., routing=...)`` splits the serving state over the
shards of a ``launch.mesh.ShardMesh`` and runs the batch step of
``serve/sharded.py``: each shard scans its own block, the candidates merge
across shards, the re-rank runs once; results equal the meshless engine's
bit for bit. ``routing="routed"`` skips the shards a batch does not route
to (flat with ``placement="cluster"``: psi-cluster ownership and a ball
bound, flagged queries re-run dense; IVF: probed-list ownership, exact),
and the dispatch sorts each cache-miss queue by route signature so
co-routed queries share a batch.

Degraded serving: a sharded engine carries a ``ShardHealth`` layer. Dead
shards (``health.mark_dead``, heartbeat timeouts, evicted stragglers) are
skipped in every stage, results equal a search over the surviving rows
(``serve.faultinject.surviving_reference``), and ``stats.last_coverage``
flags the queries the dead shards could have changed. Around the step:
bounded retry on ``TransientShardError``, a deadline counter, queue
backpressure. ``heal()`` checkpoints, restores the whole corpus onto the
surviving shard positions, checks the candidate bit for bit against a
meshless restore and cuts over. Mirrors ``repro.serve.engine``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import fcvi, theory
from repro_torch.core.baselines import BoxPredicate
from repro_torch.core.fcvi import FCVIConfig, FCVIIndex
from repro_torch.core.filters import Predicate, compile_predicate, eval_mask
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index import flat as flat_mod
from repro_torch.index import ivf as ivf_mod
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ShardMesh
from repro_torch.serve.health import (BackpressureError, ShardHealth,
                                      TransientShardError)
from repro_torch.serve.planner import (CANDIDATE_PAD, PLAN_FOLD, PLAN_MASK,
                                       PLAN_ROUTED, PLANS, QueryPlanner,
                                       _pow2_at_least)

Tensor = torch.Tensor

# magnitudes beyond this overflow fp32 when squared in the scoring path; the
# input-hardening boundary rejects them as out of support
_SUPPORT_LIMIT = 1e18


@dataclasses.dataclass
class _DeltaBuffer:
    """Device-resident view of the un-compacted inserts."""

    vn: Tensor                 # (nd, d) normalized new vectors
    fn: Tensor                 # (nd, m) normalized new filters
    flat: flat_mod.FlatIndex   # transformed-space index over the delta rows,
                               # stored at the index's storage dtype


def _delta_candidates(delta: _DeltaBuffer, q_t: Tensor, kd: int,
                      gather_free: bool):
    """The delta tier's candidate ids (b, kd') and their re-rank rows: a
    scan of the delta when it holds more than kd rows, else all of it."""
    nd = delta.vn.shape[0]
    if kd < nd:
        if gather_free:
            _, dcand, drv, drf = flat_mod.search_rows(delta.flat, q_t, kd,
                                                      delta.vn, delta.fn)
            return dcand, drv, drf
        _, dcand = flat_mod.search(delta.flat, q_t, kd)
    else:
        dcand = torch.arange(nd, dtype=torch.int32,
                             device=q_t.device).expand(q_t.shape[0], nd)
    rows = dcand.long()
    return dcand, delta.vn[rows], delta.fn[rows]


def _batch_step(index: FCVIIndex, delta: Optional[_DeltaBuffer], q: Tensor,
                f: Tensor, *, k: int, kp: int, kd: int, gather_free: bool,
                grouped_payload=(None, None)):
    """The per-batch hot path: transform -> candidates -> combined-score
    re-rank -> delta search + merge_topk -> escalation margin. Returns
    (scores (b, k), ids (b, k) int32, margin (b,)).

    ``gather_free`` takes the re-rank rows from the scan kernel's epilogue
    (``_batch_step_rows`` in the JAX package) instead of gathering them by
    id from ``vectors_n``/``filters_n`` (its ``_batch_step``); the results
    are the same; PQ has no rows scan, and ``FCVIEngine._step`` passes
    False for it. ``grouped_payload`` is the IVF backend's (grouped_pv,
    grouped_pf), the re-rank originals in the grouped layout that the IVF
    rows scan reads (see ``FCVIEngine._rows_payload``)."""
    cfg = index.config
    qn, fqn = index.transform.normalize(q, f)
    q_t = index.transform.apply_normalized(qn, fqn)
    if gather_free and cfg.backend == "ivf":
        gpv, gpf = grouped_payload
        _, cand, rv, rf = index.backend.search_rows(
            q_t, kp, index.vectors_n, index.filters_n, grouped_pv=gpv,
            grouped_pf=gpf, nprobe=cfg.nprobe)
    elif gather_free:
        _, cand, rv, rf = index.backend.search_rows(
            q_t, kp, index.vectors_n, index.filters_n)
    else:
        _, cand = fcvi._backend_search(index, q_t, kp)
        rows = cand.long()
        rv, rf = index.vectors_n[rows], index.filters_n[rows]
    scores, ids = ops.rescore_topk(rv, rf, qn, fqn, cfg.lam, cand, k)

    if delta is not None:
        # same over-retrieval bound as the main path (Thm 5.4); q_t is
        # reused, so the fused transform runs once
        dcand, drv, drf = _delta_candidates(delta, q_t, kd, gather_free)
        dvals, dids = ops.rescore_topk(drv, drf, qn, fqn, cfg.lam, dcand,
                                       min(k, kd))
        dids = index.size + dids
        scores, ids = flat_mod.merge_topk(scores, ids, dvals,
                                          dids.to(ids.dtype), k)

    return scores, ids, scores[:, 0] - scores[:, -1]


# ---------------------------------------------------------------------------
# Predicate-filtered physical plans (the filter algebra, meshless).
#
# All three plans funnel into the SAME refine convention: canonical fp32
# d2 (``flat.filtered_d2``), the (d2 asc, id asc) sort, dead slots at
# (+inf, DEAD_ID). So any plan whose candidate set CONTAINS the true
# eligible top-k gives the same bits.
# ---------------------------------------------------------------------------

def _filtered_mask_step(backend, q_t: Tensor, elig: Tensor, *, k: int,
                        kp: int):
    """MASK plan: the eligibility-masked scan, then the filtered refine.
    Flat runs the masked top-kp scan (B2's masked variants on the card);
    IVF the masked EXHAUSTIVE all-lists dedup scan (B5 with ``mask=``), so
    the candidate set holds every eligible row within kp: exact when
    kp >= min(k, #eligible)."""
    mod = flat_mod if isinstance(backend, flat_mod.FlatIndex) else ivf_mod
    cand, valid = mod.masked_candidates(backend, q_t, kp, elig)
    return flat_mod.filtered_refine(backend.vectors, backend.scales, q_t,
                                    cand, valid, elig, k)


def _filtered_fold_step(backend: flat_mod.FlatIndex, q_t: Tensor,
                        elig: Tensor, n_elig: int, *, k: int, kp: int):
    """FOLD plan (flat fp32 only): the unmasked scan (B2) against the
    queries folded to the predicate's raw target, the filtered refine over
    the eligible candidates, and a per-query CERTIFICATE: exact when the kp
    candidates held >= k eligible rows, or every eligible row there is.
    Returns (d2, ids, certified (b,) bool)."""
    vals, cand = ops.score_topk(backend.vectors, backend.sq_norms, q_t, kp,
                                scales=backend.scales)
    valid = ~torch.isneginf(vals)
    cand = torch.clamp(cand, min=0)
    d2, ids = flat_mod.filtered_refine(backend.vectors, backend.scales, q_t,
                                       cand, valid, elig, k)
    elig_in = torch.sum(valid & elig[cand.long()], dim=-1)
    return d2, ids, (elig_in >= k) | (elig_in == n_elig)


def _filtered_routed_step(backend: ivf_mod.IVFIndex, q_t: Tensor,
                          elig: Tensor, uniq: Tensor, n_live: int, *,
                          k: int, kp: int):
    """ROUTED plan (IVF): scan only the lists holding eligible rows (B5
    with ``mask=`` over ``uniq``). Exact because every eligible row lives
    in a routed list and the scan is exhaustive over those lists."""
    cand, valid = ivf_mod.routed_candidates(backend, q_t, kp, elig, uniq,
                                            n_live)
    return flat_mod.filtered_refine(backend.vectors, backend.scales, q_t,
                                    cand, valid, elig, k)


def _filtered_delta_step(delta_flat: flat_mod.FlatIndex, q_t: Tensor,
                         delig: Tensor, *, k: int):
    """Exact filtered top-k over the delta tier, delta-LOCAL ids: the same
    canonical d2 over every pending row (dequantized), so the merge with
    the main tier stays bit-stable. The engine maps id j to
    ``index.size + j``."""
    rows = delta_flat.vectors.to(torch.float32)
    if delta_flat.scales is not None:
        rows = rows * delta_flat.scales[:, None]
    nd = rows.shape[0]
    d2 = flat_mod.filtered_d2(q_t, rows)
    d2 = torch.where(delig[None, :], d2, float("inf"))
    ids = torch.where(delig, torch.arange(nd, dtype=torch.int32,
                                          device=q_t.device),
                      flat_mod.DEAD_ID)
    return flat_mod.lexsort_topk(d2, ids[None, :].expand_as(d2), k)


@dataclasses.dataclass
class EngineConfig:
    """Serving-side knobs (host-side policy; none changes result values
    except ``k``). ``router_nprobe`` only matters for routed flat serving:
    the psi-clusters the shard router probes a query (0 = about two
    shards' worth; fewer skip more shards and re-run more queries
    dense)."""

    k: int = 10
    batch_size: int = 64
    cache_entries: int = 4096
    cache_round: float = 0.05      # filter-key quantization for cache hits
    escalate_margin: float = 0.02  # top-k score margin triggering stage 2
    kprime_escalation: int = 4     # stage-2 k' multiplier
    compact_threshold: int = 2048  # delta rows triggering compaction
    multi_probe_r: int = 4         # probes of search_predicate
    router_nprobe: int = 0         # routed flat serving: probed clusters
    # gather-free re-rank: the scan emits the winners' re-rank rows instead
    # of ids that a second gather from vectors_n/filters_n resolves; the
    # results are the same either way
    gather_free: bool = True
    # -- resilience envelope (off the hot path) ---------------------------
    deadline_s: float = 0.0        # per-batch deadline; 0 disables the check
    max_retries: int = 2           # bounded retry on TransientShardError
    retry_backoff_s: float = 0.05  # base backoff, doubled per retry
    queue_budget: int = 0          # max cache-miss queue; 0 = unlimited
    # straggler-eviction z-threshold of the shard health layer. The sample
    # sd z of ONE outlier in a fleet of n is at most (n - 1) / sqrt(n)
    # (~2.47 for n = 8): small fleets need a threshold below that bound
    straggler_z: float = 3.0


@dataclasses.dataclass
class EngineStats:
    """Host-side serving counters. The ``router_*`` / ``shard*`` fields move
    on routed sharded engines only: ``shard_steps`` counts (batch x shard)
    slots, ``shards_active`` the slots whose scan ran (the rest launched
    nothing), ``router_fallbacks`` the queries re-run dense because the
    routed clipping bound could not certify them."""

    queries: int = 0
    cache_hits: int = 0
    escalations: int = 0
    inserts: int = 0
    compactions: int = 0
    total_time_s: float = 0.0
    routed_batches: int = 0
    router_fallbacks: int = 0
    shards_active: int = 0
    shard_steps: int = 0
    # device-memory bytes the candidate scans stream, modeled per batch from
    # the slab sizes (see FCVIEngine._batch_scan_bytes)
    bytes_scanned: int = 0
    scan_batches: int = 0          # batches the bytes model accounted
    # -- degraded serving / resilience envelope ---------------------------
    degraded_batches: int = 0      # batches served with >= 1 dead shard
    uncovered_queries: int = 0     # queries whose coverage flag was raised
    retries: int = 0               # TransientShardError retries
    deadline_misses: int = 0       # batches exceeding cfg.deadline_s
    backpressure_drops: int = 0    # queries shed by BackpressureError
    straggler_evictions: int = 0   # shards evicted by the health layer
    heals: int = 0                 # validated heal() cutovers
    # -- predicate-filtered serving (filter algebra + planner) -------------
    filtered_queries: int = 0      # queries served through search(filter=)
    plan_fold: int = 0             # queries executed under each plan
    plan_mask: int = 0
    plan_routed: int = 0
    filtered_fallbacks: int = 0    # fold queries re-run under mask
    # per-query coverage flags of the LAST search call (True = certified
    # unaffected by dead shards; all True while healthy)
    last_coverage: Optional[np.ndarray] = None

    @property
    def qps(self) -> float:
        return self.queries / self.total_time_s if self.total_time_s else 0.0

    @property
    def bytes_per_query(self) -> float:
        """Modeled scan bytes per served query (cache hits included in the
        denominator: they stream nothing)."""
        return self.bytes_scanned / self.queries if self.queries else 0.0

    @property
    def effective_bandwidth_gbps(self) -> float:
        """Modeled scan bytes / serving wall time, in GB/s."""
        if not self.total_time_s:
            return 0.0
        return self.bytes_scanned / self.total_time_s / 1e9

    @property
    def shard_skip_rate(self) -> float:
        """Share of (batch x shard) slots routing skipped."""
        if not self.shard_steps:
            return 0.0
        return 1.0 - self.shards_active / self.shard_steps

    @property
    def coverage_rate(self) -> float:
        """Share of served queries certified unaffected by dead shards."""
        if not self.queries:
            return 1.0
        return 1.0 - self.uncovered_queries / self.queries


class FCVIEngine:
    """Batched serving engine over one ``FCVIIndex``.

    ``search(queries (n, d), filters (n, m))`` takes and returns HOST numpy
    arrays: (scores (n, k) fp32, ids (n, k) int64); ids >= ``index.size``
    are un-compacted delta rows. ``insert(vectors, filters)`` buffers rows
    in the delta tier until ``compact_threshold`` triggers compaction.

    ``search(queries, filter=pred)`` is predicate search (see ``search``).
    ``attributes`` (n, m) is the RAW attribute table predicates evaluate
    against (default: the de-normalized filter columns,
    ``fcvi.filters_raw``); ``attr_names`` names its columns (default
    ``f0..f{m-1}``).

    ``device`` (default ``"cuda"``) is where the engine serves; the index
    must live there. Asking for a card that is not there raises.

    ``mesh`` (a ``launch.mesh.ShardMesh``; None = meshless) shards the
    serving state over the mesh axes of ``rules`` (``AxisRules``; the
    "corpus" and "ivf_lists" entries); ``placement`` is "contiguous" or
    "cluster" (filter-centric: psi-clusters for flat, affinity-packed lists
    for IVF; IVF also takes "balanced" and "affinity"); ``routing`` is
    "dense" (every shard scans every batch) or "routed" (needs a mesh, and
    ``placement="cluster"`` for flat; PQ refuses it); ``router_centers``
    pins the flat router's psi-cluster centers. All are deployment knobs:
    the results are the meshless engine's on every combination."""

    def __init__(self, index: FCVIIndex, config: Optional[EngineConfig] = None,
                 *, device: DeviceLike = "cuda", mesh=None, rules=None,
                 placement: str = "contiguous", routing: str = "dense",
                 router_centers=None, attributes=None, attr_names=None):
        self.device = resolve_device(device)
        if index.device != self.device:
            raise ValueError(
                f"the index lives on {index.device}, the engine serves on "
                f"{self.device}; build or load the index on the same device")
        if routing not in ("dense", "routed"):
            raise ValueError(
                f"routing must be 'dense' or 'routed', got {routing!r}")
        if routing == "routed" and mesh is None:
            raise ValueError("routing='routed' requires a device mesh")
        if mesh is not None and not isinstance(mesh, ShardMesh):
            raise TypeError(
                f"mesh must be a repro_torch.launch.mesh.ShardMesh, got "
                f"{type(mesh).__name__}")
        if mesh is not None:
            kinds = sorted({d.type for d in mesh.devices.flat})
            if kinds != [self.device.type]:
                # a shard on another kind of device would move its scan
                # there without a word
                raise ValueError(
                    f"the mesh's devices are {kinds}, the engine serves on "
                    f"{self.device}; make the mesh on the engine's device")
        self.index = index
        # one default per engine: a shared EngineConfig() default instance
        # would leak mutations across engines
        self.cfg = config if config is not None else EngineConfig()
        self.stats = EngineStats()
        self._cache: "collections.OrderedDict" = collections.OrderedDict()
        self._delta_v: list = []
        self._delta_f: list = []
        self._delta: Optional[_DeltaBuffer] = None
        self._grouped_payload = None  # IVF gather-free payload slabs (lazy)
        self._mesh, self._rules, self._placement = mesh, rules, placement
        self._routing = routing
        self._router_centers = router_centers
        self._sharded = None
        self._sharded_delta = None
        # hook for a fault-injection harness: an object whose
        # ``before_batch()`` may raise TransientShardError and whose
        # ``shard_times(n, elapsed)`` feeds the health layer
        self.fault_injector = None
        # degraded serving: the health layer (sharded engines only), the
        # alive mask the cache was filled under, the heal cutover lock
        self.health: Optional[ShardHealth] = None
        self._alive_sig: Optional[bytes] = None
        self._heal_lock = threading.Lock()
        self._init_attrs(attributes, attr_names)
        if mesh is not None:
            self._build_sharded()
            self.health = ShardHealth(self._sharded.n_shards,
                                      straggler_z=self.cfg.straggler_z)

    # -- predicate-filtered serving state ----------------------------------
    def _init_attrs(self, attributes, attr_names):
        """The RAW attribute table (host copy for the planner and column
        means, device copy for evaluating predicates), its column names and
        the planner, whose histograms are built here, once."""
        mf = self.index.transform.filt_norm.mean.shape[-1]
        if attributes is None:
            attrs = fcvi.filters_raw(self.index).cpu().numpy()
        else:
            attrs = np.asarray(attributes, np.float32)
            if attrs.shape != (self.index.size, mf):
                # the fold plan's target feeds the filter side of psi, and
                # delta rows are checked against their insert filters
                raise ValueError(
                    f"attributes must be (index.size={self.index.size}, "
                    f"m={mf}); got shape {attrs.shape}")
        m = attrs.shape[1]
        if attr_names is None:
            attr_names = tuple(f"f{j}" for j in range(m))
        else:
            attr_names = tuple(attr_names)
            if len(attr_names) != m:
                raise ValueError(
                    f"attr_names has {len(attr_names)} entries for "
                    f"{m} attribute columns")
        self._attr_names = attr_names
        self._set_attrs(attrs)

    def _set_attrs(self, attrs: np.ndarray):
        self._attrs_np = attrs
        self._attrs = torch.tensor(attrs, device=self.device)
        self._col_means = attrs.mean(axis=0).astype(np.float32)
        self._rebuild_planner()

    def _rebuild_planner(self):
        cfg = self.index.config
        if cfg.backend in ("flat", "ivf"):
            self.planner = QueryPlanner.build(
                self._attrs_np, backend=cfg.backend,
                storage_fp32=cfg.resolved_storage_dtype() is None,
                sharded=self._mesh is not None)
        else:
            self.planner = None  # PQ: no filtered plans

    def _build_sharded(self):
        """(Re)shard the serving state onto the configured mesh."""
        from repro_torch.serve.sharded import ShardedServing

        attrs = (self._attrs_np
                 if self.index.config.backend in ("flat", "ivf") else None)
        centers = self._router_centers
        if centers is not None:
            centers = torch.as_tensor(centers, dtype=torch.float32).to(
                self.device)
        self._sharded = ShardedServing(
            self.index, self._mesh, rules=self._rules,
            placement=self._placement, routing=self._routing,
            router_nprobe=self.cfg.router_nprobe, router_centers=centers,
            attrs=attrs)
        self._sharded_delta = None

    @property
    def _routed(self) -> bool:
        return self._sharded is not None and self._routing == "routed"

    # -- cache ------------------------------------------------------------
    def _cache_keys(self, queries: np.ndarray,
                    filters: np.ndarray) -> List[bytes]:
        """Quantized keys for the whole batch: one vectorized round."""
        r = self.cfg.cache_round
        qq = np.round(queries / r).astype(np.int32)
        ff = np.round(filters / r).astype(np.int32)
        return [q.tobytes() + b"#" + f.tobytes() for q, f in zip(qq, ff)]

    def _cache_get(self, key: bytes):
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        return None

    def _cache_put(self, key: bytes, value):
        self._cache[key] = value
        self._cache.move_to_end(key)
        while len(self._cache) > self.cfg.cache_entries:
            self._cache.popitem(last=False)

    # -- storage-bandwidth accounting (host-side model) --------------------
    def _batch_scan_bytes(self, b: int) -> int:
        """Modeled device-memory bytes the candidate scans of one padded
        batch of ``b`` queries stream: the whole flat slab (vectors,
        squared norms and int8 scales), the probed share of the IVF grouped
        slabs and grouped scales (capped at every list once, as the dedup
        scan reads a shared list once) plus the centroids, or PQ's codes and
        coarse ids; a pending delta adds its flat slab. The reference's
        model, so the two engines' counters agree."""
        be = self.index.backend
        cfg = self.index.config

        def nbytes(*ts):
            return sum(t.nbytes for t in ts if t is not None)

        if cfg.backend == "pq":
            n = be.codes.nbytes + be.coarse_ids.nbytes
        elif cfg.backend == "ivf":
            slab = nbytes(be.grouped, be.grouped_sq, be.grouped_scales)
            probed = min(b * min(cfg.nprobe, be.nlist), be.nlist)
            n = slab * probed // be.nlist + be.centroids.nbytes
        else:
            n = nbytes(be.vectors, be.sq_norms, be.scales)
        if self._delta is not None:
            dl = self._delta.flat
            n += nbytes(dl.vectors, dl.sq_norms, dl.scales)
        return int(n)

    # -- input hardening ---------------------------------------------------
    def _validate_inputs(self, queries, filters):
        """Reject malformed or poisoned inputs at the serving boundary with
        a ValueError: NaN/Inf, dimension mismatches, empty batches,
        magnitudes that overflow fp32 when squared, and ``k`` beyond the
        corpus. Returns the inputs as fp32 numpy arrays."""
        q = np.asarray(queries, np.float32)
        f = np.asarray(filters, np.float32)
        if q.ndim != 2 or f.ndim != 2:
            raise ValueError(
                f"queries/filters must be 2-D (n, dim); got shapes "
                f"{np.shape(queries)} / {np.shape(filters)}")
        if q.shape[0] == 0:
            raise ValueError("empty query batch: queries.shape[0] == 0")
        if q.shape[0] != f.shape[0]:
            raise ValueError(
                f"queries and filters disagree on batch size: "
                f"{q.shape[0]} != {f.shape[0]}")
        d = self.index.transform.vec_norm.mean.shape[-1]
        m = self.index.transform.filt_norm.mean.shape[-1]
        if q.shape[1] != d:
            raise ValueError(
                f"query dimension mismatch: got {q.shape[1]}, index expects "
                f"{d}")
        if f.shape[1] != m:
            raise ValueError(
                f"filter dimension mismatch: got {f.shape[1]}, index "
                f"expects {m}")
        if not np.isfinite(q).all():
            raise ValueError("queries contain NaN/Inf values")
        if not np.isfinite(f).all():
            raise ValueError("filters contain NaN/Inf values")
        amax = max(float(np.abs(q).max()), float(np.abs(f).max()))
        if amax > _SUPPORT_LIMIT:
            raise ValueError(
                f"input magnitude {amax:.3g} out of support (> "
                f"{_SUPPORT_LIMIT:.0e}): values overflow fp32 when squared")
        total = self.index.size + self.delta_size()
        if self.cfg.k > total:
            raise ValueError(
                f"k={self.cfg.k} exceeds corpus size {total}")
        return q, f

    def _alive_for_search(self) -> Optional[np.ndarray]:
        """The health layer's snapshot for one search call: None while
        every shard is healthy (the fast path), else the (n_shards,) bool
        alive mask. The result cache and the sharded delta tier are dropped
        whenever the mask changes (cached results were computed over other
        rows; the delta blocks live on the live shards), and the cache is
        not used while degraded (a (scores, ids) entry cannot carry a
        coverage flag)."""
        if self.health is None:
            return None
        self.health.check_failures()
        alive = self.health.alive_mask()
        sig = alive.tobytes() if self.health.any_dead() else None
        if sig != self._alive_sig:
            self._cache.clear()
            self._sharded_delta = None
            self._alive_sig = sig
        return None if sig is None else alive

    # -- search -----------------------------------------------------------
    def search(self, queries: np.ndarray, filters: Optional[np.ndarray] = None,
               *, filter: Optional[Predicate] = None,
               plan: Optional[str] = None):
        """queries: (n, d) fp32. Two serving modes, selected by the kwargs:

        * SIMILARITY mode (``filters`` (n, m) fp32, raw): the paper's
          combined-score search. Returns (scores (n, k) fp32, ids (n, k)
          int64); ids >= ``index.size`` refer to un-compacted delta rows.
          A routed engine first sorts the cache-miss queue by route
          signature, so co-routed queries share a padded batch.
        * PREDICATE mode (``filter=F.range("f7", 0.0, 0.6) &
          F.eq("f0", 1.0)``): exact top-k by L2 over the rows satisfying
          the predicate (``repro_torch.core.filters``). The planner picks
          the physical plan per call (``plan`` forces "fold", "mask" or
          "routed"); scores are negative squared distances against the
          fold-transformed queries. Queries with no eligible row return
          (-inf, -1) rows. This path bypasses the result cache.

        Inputs are validated here (see ``_validate_inputs``). With dead
        shards the engine serves DEGRADED: results equal a search over the
        surviving shards' rows and ``stats.last_coverage`` flags the
        queries the dead shards could have changed. Raises
        ``BackpressureError`` when the cache-miss queue exceeds
        ``cfg.queue_budget`` (> 0)."""
        if filter is not None:
            if filters is not None:
                raise ValueError(
                    "pass either filters= (similarity mode) or filter= "
                    "(predicate mode), not both")
            return self._search_filtered(queries, filter, plan=plan)
        if filters is None:
            raise TypeError(
                "search() needs filters= (similarity mode) or filter= "
                "(predicate mode)")
        if plan is not None:
            raise ValueError("plan= only applies to predicate mode (filter=)")
        queries, filters = self._validate_inputs(queries, filters)
        t0 = time.perf_counter()
        n = queries.shape[0]
        k = self.cfg.k
        out_scores = np.zeros((n, k), np.float32)
        out_ids = np.zeros((n, k), np.int64)
        coverage = np.ones((n,), bool)
        alive = self._alive_for_search()
        use_cache = alive is None

        keys = self._cache_keys(queries, filters)
        todo = []
        for i, key in enumerate(keys):
            hit = self._cache_get(key) if use_cache else None
            if hit is not None:
                out_scores[i], out_ids[i] = hit
                self.stats.cache_hits += 1
            else:
                todo.append(i)

        if self.cfg.queue_budget and len(todo) > self.cfg.queue_budget:
            self.stats.backpressure_drops += len(todo)
            raise BackpressureError(
                f"dispatch queue {len(todo)} exceeds queue_budget="
                f"{self.cfg.queue_budget}; shed load and retry")

        if todo and self._routed:
            # bucket the queue by route signature so each padded batch
            # touches as few shards as it can
            sigs = self._sharded.route_signatures(queries[todo],
                                                  filters[todo])
            order = sorted(range(len(todo)), key=lambda j: sigs[j].tobytes())
            todo = [todo[j] for j in order]

        bs = self.cfg.batch_size
        for s in range(0, len(todo), bs):
            idxs = todo[s:s + bs]
            # pad rows fill the batch to its fixed size and only affect
            # their own (dropped) results: zeros, or on a routed engine the
            # last real query, so pad rows route where it routes
            q = np.zeros((bs, queries.shape[1]), np.float32)
            f = np.zeros((bs, filters.shape[1]), np.float32)
            if self._routed:
                q[:], f[:] = queries[idxs[-1]], filters[idxs[-1]]
            q[:len(idxs)], f[:len(idxs)] = queries[idxs], filters[idxs]
            scores, ids, covered = self._dispatch_batch(
                torch.tensor(q, device=self.device),
                torch.tensor(f, device=self.device), k, n_real=len(idxs),
                alive=alive)
            self.stats.bytes_scanned += self._batch_scan_bytes(bs)
            self.stats.scan_batches += 1
            scores = scores.cpu().numpy()
            ids = ids.cpu().numpy().astype(np.int64)
            for j, i in enumerate(idxs):
                out_scores[i], out_ids[i] = scores[j], ids[j]
                if covered is not None:
                    coverage[i] = covered[j]
                if use_cache:
                    self._cache_put(keys[i], (scores[j], ids[j]))

        self.stats.queries += n
        self.stats.uncovered_queries += int((~coverage).sum())
        self.stats.last_coverage = coverage
        self.stats.total_time_s += time.perf_counter() - t0
        return out_scores, out_ids

    # -- predicate-filtered search (filter algebra + planner) --------------
    def _search_filtered(self, queries, pred: Predicate,
                         plan: Optional[str] = None):
        """Exact predicate-filtered top-k (see ``search``).

        The predicate compiles once per call; eligibility is evaluated on
        the device over the RAW attribute table held there (``eval_mask``,
        the same comparisons as the reference's host-side ``eval_np``, so
        the same rows). All plans score against the SAME fold-transformed
        queries and funnel into the same refine, so forced plans agree bit
        for bit. Pending delta rows are checked against the filters they
        were inserted with.

        A sharded engine runs the mask and routed plans per shard
        (``ShardedServing.filtered_step``, eligibility evaluated in each
        shard); the fold plan stays meshless, as in the reference (its
        certificate needs the global scan). With dead shards the dead
        shards are skipped, a fold choice runs the mask plan instead, and
        every query is flagged uncovered when a dead shard holds an
        eligible row."""
        if self.planner is None:
            raise ValueError(
                "predicate-filtered search needs a flat or ivf backend "
                f"(index backend is {self.index.config.backend!r})")
        t0 = time.perf_counter()
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(
                f"queries must be a non-empty (n, d) batch; got shape "
                f"{np.shape(queries)}")
        d = self.index.transform.vec_norm.mean.shape[-1]
        if q.shape[1] != d:
            raise ValueError(
                f"query dimension mismatch: got {q.shape[1]}, index expects "
                f"{d}")
        if not np.isfinite(q).all():
            raise ValueError("queries contain NaN/Inf values")
        n, k = q.shape[0], self.cfg.k
        cp = compile_predicate(pred, self._attr_names)
        chosen = plan if plan is not None else self.planner.choose(cp)
        if plan is not None:
            if plan not in PLANS:
                raise ValueError(f"unknown plan {plan!r}; expected one of "
                                 f"{PLANS}")
            if plan == PLAN_FOLD and not self.planner.fold_capable(cp):
                raise ValueError(
                    "plan='fold' needs a flat fp32 backend and a single-"
                    "attribute predicate")
            if plan == PLAN_ROUTED and not self.planner.routed_capable():
                raise ValueError("plan='routed' needs an IVF backend")
        alive = self._alive_for_search()
        run = chosen
        if alive is not None and chosen == PLAN_FOLD:
            run = PLAN_MASK      # the fold plan's scan reads every shard
        kp = self.planner.kp_for(run, cp, k)
        if self.index.config.backend == "flat":
            kp = min(kp, self.index.size)  # the scan's width <= the corpus
        self.stats.queries += n
        self.stats.filtered_queries += n
        setattr(self.stats, f"plan_{chosen}",
                getattr(self.stats, f"plan_{chosen}") + n)
        self.stats.last_coverage = np.ones((n,), bool)

        lo, hi, isin_vals, isin_count = cp.as_arrays(self.device)
        # only the IN-list slots some column uses: the rest never match
        arrays = (lo, hi, isin_vals[:, :int(cp.isin_count.max())],
                  isin_count)
        elig = eval_mask(self._attrs, *arrays)
        delta = self._ensure_delta()
        delig = None
        if delta is not None:
            delig = eval_mask(self._pending()[1], *arrays)
        n_elig = int(elig.sum())
        nd_elig = 0 if delig is None else int(delig.sum())
        out_scores = np.full((n, k), -np.inf, np.float32)
        out_ids = np.full((n, k), -1, np.int64)
        if n_elig + nd_elig == 0:
            # zero-match predicate: certified-empty results, not padded
            # id-0 rows
            self.stats.total_time_s += time.perf_counter() - t0
            return out_scores, out_ids

        # every plan scores against the SAME folded queries, computed once
        fold_raw = cp.fold_target_raw(self._col_means)
        q_t_all = fcvi.fold_queries(self.index,
                                    torch.tensor(q, device=self.device),
                                    fold_raw)
        route = None
        if self._sharded is not None and run != PLAN_FOLD and n_elig > 0:
            eligs, counts = self._sharded.eligibility(arrays, elig, alive)
            route = (eligs, counts)
            if alive is not None and (counts[~alive] > 0).any():
                self.stats.last_coverage[:] = False
                self.stats.uncovered_queries += n
        elif chosen == PLAN_ROUTED and n_elig > 0:
            route = ivf_mod.eligible_lists(self.index.backend.lists, elig)

        bs = self.cfg.batch_size
        for s in range(0, n, bs):
            idxs = np.arange(s, min(s + bs, n))
            nb = min(bs, _pow2_at_least(len(idxs)))
            sel = np.full((nb,), idxs[-1], np.int64)
            sel[: len(idxs)] = idxs
            q_t = q_t_all[torch.as_tensor(sel, device=self.device)]
            d2, ids = self._filtered_main(run, q_t, elig, n_elig, route,
                                          k=k, kp=kp, alive=alive)
            if nd_elig > 0:
                dd2, dids = _filtered_delta_step(delta.flat, q_t, delig, k=k)
                dids = torch.where(dids == flat_mod.DEAD_ID,
                                   flat_mod.DEAD_ID, dids + self.index.size)
                d2, ids = flat_mod.lexsort_topk(torch.cat([d2, dd2], dim=-1),
                                                torch.cat([ids, dids], dim=-1),
                                                k)
            scores, ids = flat_mod.finalize_filtered(d2, ids)
            out_scores[idxs] = scores.cpu().numpy()[: len(idxs)]
            out_ids[idxs] = ids.cpu().numpy().astype(np.int64)[: len(idxs)]
            self.stats.scan_batches += 1

        self.stats.total_time_s += time.perf_counter() - t0
        return out_scores, out_ids

    def _filtered_main(self, plan: str, q_t: Tensor, elig: Tensor,
                       n_elig: int, route, *, k: int, kp: int, alive=None):
        """Main-tier (d2, ids) for one padded batch under ``plan``, dead
        slots at (+inf, DEAD_ID) so the delta tier merges in d2 space.
        Uncertified fold rows re-run under the mask plan in a power-of-two
        sub-batch. ``route``: the meshless routed plan's lists, or a
        sharded engine's per-shard (eligibility, counts)."""
        b = q_t.shape[0]
        if n_elig == 0:
            return (torch.full((b, k), float("inf"), device=q_t.device),
                    torch.full((b, k), flat_mod.DEAD_ID, dtype=torch.int32,
                               device=q_t.device))
        if self._sharded is not None and plan != PLAN_FOLD:
            eligs, counts = route
            return self._sharded.filtered_step(
                q_t, eligs, counts, k=k, kp=kp,
                routed=(plan == PLAN_ROUTED), alive=alive)
        backend = self.index.backend
        if plan == PLAN_ROUTED:
            uniq, n_live = route
            return _filtered_routed_step(backend, q_t, elig, uniq, n_live,
                                         k=k, kp=kp)
        if plan == PLAN_MASK:
            return _filtered_mask_step(backend, q_t, elig, k=k, kp=kp)
        d2, ids, cert = _filtered_fold_step(backend, q_t, elig, n_elig, k=k,
                                            kp=kp)
        need = (~cert).cpu().numpy()
        if need.any():
            fidx = np.nonzero(need)[0]
            self.stats.filtered_fallbacks += len(fidx)
            nb = b
            while nb // 2 >= max(len(fidx), 1):
                nb //= 2
            sel = np.zeros((nb,), np.int64)
            sel[: len(fidx)] = fidx
            kpf = min(k + CANDIDATE_PAD, self.index.size)
            d2f, idsf = _filtered_mask_step(
                backend, q_t[torch.as_tensor(sel, device=q_t.device)], elig,
                k=k, kp=kpf)
            take = torch.as_tensor(fidx, device=q_t.device)
            d2[take] = d2f[: len(fidx)]
            ids[take] = idsf[: len(fidx)]
        return d2, ids

    def _dispatch_batch(self, q: Tensor, f: Tensor, k: int, n_real: int,
                        alive: Optional[np.ndarray] = None):
        """One padded batch through the resilience envelope: bounded retry
        with exponential backoff on ``TransientShardError`` (a real dispatch
        failure or an attached fault injector), a per-batch deadline
        counter, and the heartbeat feed to the health layer. Returns
        (scores, ids, covered)."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                if self.fault_injector is not None:
                    self.fault_injector.before_batch()
                out = self._run_batch(q, f, k, n_real=n_real, alive=alive)
            except TransientShardError:
                attempt += 1
                self.stats.retries += 1
                if attempt > self.cfg.max_retries:
                    raise
                time.sleep(self.cfg.retry_backoff_s * (2 ** (attempt - 1)))
                continue
            elapsed = time.perf_counter() - t0
            if self.cfg.deadline_s and elapsed > self.cfg.deadline_s:
                self.stats.deadline_misses += 1
            if self.health is not None:
                if self.fault_injector is not None:
                    times = self.fault_injector.shard_times(
                        self.health.n_shards, elapsed)
                else:
                    # the shards of one process run back to back: per-shard
                    # time is not observable, feed the batch's wall time
                    times = [elapsed] * self.health.n_shards
                evicted = self.health.record_batch(times)
                self.stats.straggler_evictions += len(evicted)
            if alive is not None:
                self.stats.degraded_batches += 1
            return out

    def _run_batch(self, q: Tensor, f: Tensor, k: int, n_real: int,
                   alive: Optional[np.ndarray] = None):
        """One padded batch through the step, then stage-2 escalation for
        the real rows whose top-k margin is below ``escalate_margin``: they
        re-run with k' scaled by ``kprime_escalation`` in a power-of-two
        sub-batch and are scattered back. Pad rows never trigger (or count
        as) escalations.

        A routed engine runs the routed step first and re-runs the queries
        whose clipping flag is set through the DENSE step (same k'), so
        routed results equal dense results; the route mask feeds the
        router counters. ``alive`` (degraded) reaches every stage: the
        routed step, its dense fallback and the escalation sub-batch.
        Returns (scores (b, k), ids (b, k), covered (n_real,) bool or None
        while healthy)."""
        cfg = self.index.config
        degraded = alive is not None
        alpha = cfg.resolved_alpha()
        kp = theory.k_prime(k, cfg.lam, alpha, self.index.size, cfg.c)
        delta = self._ensure_delta()
        kd = 0
        if delta is not None:
            nd = delta.vn.shape[0]
            kd = min(nd, max(theory.k_prime(k, cfg.lam, alpha, nd, cfg.c),
                             4 * k))
        unc = None
        if self._routed:
            out = self._sharded.step(
                self._sharded_delta_view(delta, alive), q, f, k=k, kp=kp,
                kd=kd, routed=True, alive=alive,
                gather_free=self.cfg.gather_free)
            scores, ids, margin, flag = out[:4]
            self.stats.routed_batches += 1
            self.stats.shard_steps += self._sharded.n_shards
            self.stats.shards_active += self._sharded.last_active
            if degraded:
                unc = out[5].cpu().numpy()
            need = flag[:n_real].cpu().numpy()
            if need.any():
                idxs = np.nonzero(need)[0]
                self.stats.router_fallbacks += len(idxs)
                sub = self._dense_subbatch(delta, q, f, idxs, k=k, kp=kp,
                                           kd=kd, alive=alive)
                take = torch.as_tensor(idxs, device=q.device)
                scores[take], ids[take], margin[take] = sub[:3]
                if degraded:
                    # the dense re-run's certificate (vs the dense k'-th
                    # candidate) supersedes the routed one for these rows
                    unc[idxs] = sub[3].cpu().numpy()
        else:
            out = self._step(delta, q, f, k=k, kp=kp, kd=kd, alive=alive)
            scores, ids, margin = out[:3]
            if degraded:
                unc = out[3].cpu().numpy()
        need = (margin < self.cfg.escalate_margin)[:n_real].cpu().numpy()
        if need.any():
            idxs = np.nonzero(need)[0]
            self.stats.escalations += len(idxs)
            kp2 = theory.k_prime(k, cfg.lam, alpha, self.index.size,
                                 cfg.c * self.cfg.kprime_escalation)
            sub = self._dense_subbatch(delta, q, f, idxs, k=k, kp=kp2,
                                       kd=kd, alive=alive)
            take = torch.as_tensor(idxs, device=q.device)
            scores[take] = sub[0]
            ids[take] = sub[1]
            if degraded:
                unc[idxs] = sub[3].cpu().numpy()
        covered = None if unc is None else ~unc[:n_real]
        return scores, ids, covered

    def _dense_subbatch(self, delta, q: Tensor, f: Tensor, idxs, *, k: int,
                        kp: int, kd: int, alive=None):
        """Re-run rows ``idxs`` of the padded batch through the dense step
        in the smallest power-of-two sub-batch that holds them (halving the
        batch size); pad slots recompute query 0. Returns the step's
        outputs for ``idxs`` (with the coverage flags when degraded)."""
        nb = q.shape[0]
        while nb // 2 >= max(len(idxs), 1):
            nb //= 2
        sel = np.zeros((nb,), np.int64)
        sel[: len(idxs)] = idxs
        sel_t = torch.as_tensor(sel, device=q.device)
        out = self._step(delta, q[sel_t], f[sel_t], k=k, kp=kp, kd=kd,
                         alive=alive)
        return tuple(o[: len(idxs)] for o in out)

    def _sharded_delta_view(self, delta, alive=None):
        """The delta tier split over the live shards (lazy; dropped on
        inserts, compaction and alive-mask changes)."""
        if delta is None:
            return None
        if self._sharded_delta is None:
            self._sharded_delta = self._sharded.shard_delta(delta, alive)
        return self._sharded_delta

    def _rows_payload(self):
        """The IVF gather-free payload slabs (lazy): ``vectors_n`` and
        ``filters_n`` regrouped into the (nlist, max_list, dim) list layout,
        which the IVF rows scan reads beside the corpus slabs. (None, None)
        for flat, whose corpus order is its payload order. Dropped on
        ``compact()``, the one event that changes the corpus."""
        if self.index.config.backend != "ivf" or not self.cfg.gather_free:
            return None, None
        if self._grouped_payload is None:
            lists = self.index.backend.lists
            self._grouped_payload = (
                ivf_mod.build_grouped_payload(self.index.vectors_n, lists),
                ivf_mod.build_grouped_payload(self.index.filters_n, lists))
        return self._grouped_payload

    def _step(self, delta, q: Tensor, f: Tensor, *, k: int, kp: int,
              kd: int, alive=None):
        """One padded batch through ``_batch_step`` or, on a mesh, the
        sharded DENSE step (the routed step is ``_run_batch``'s); PQ takes
        the id-gather variant whatever ``gather_free`` says (its re-rank
        rows are the originals, which no PQ scan reads), so its delta tier
        scans ids only, as in the reference."""
        gather_free = (self.cfg.gather_free
                       and self.index.config.backend != "pq")
        if self._sharded is not None:
            return self._sharded.step(
                self._sharded_delta_view(delta, alive), q, f, k=k, kp=kp,
                kd=kd, alive=alive, gather_free=gather_free)
        return _batch_step(self.index, delta, q, f, k=k, kp=kp, kd=kd,
                           gather_free=gather_free,
                           grouped_payload=self._rows_payload())

    # -- updates ----------------------------------------------------------
    def insert(self, vectors: np.ndarray, filters: np.ndarray):
        """Buffer raw rows (n, d) / (n, m) in the delta tier; compacts into
        the main index once ``compact_threshold`` rows are pending."""
        self._delta_v.append(np.asarray(vectors, np.float32))
        self._delta_f.append(np.asarray(filters, np.float32))
        self.stats.inserts += len(vectors)
        self._cache.clear()  # results may change
        self._delta = None   # rebuilt lazily on the next search
        self._sharded_delta = None
        if self.delta_size() >= self.cfg.compact_threshold:
            self.compact()

    def delta_size(self) -> int:
        return sum(len(v) for v in self._delta_v)

    def _pending(self):
        """The pending inserts as (vectors, filters) tensors on the device."""
        return (torch.tensor(np.concatenate(self._delta_v), device=self.device),
                torch.tensor(np.concatenate(self._delta_f), device=self.device))

    def _ensure_delta(self) -> Optional[_DeltaBuffer]:
        """Materialise the delta tier on first use after an insert, with the
        index's frozen normalizers and storage dtype (lazy, so back-to-back
        inserts cost nothing until a query)."""
        if self._delta is None and self._delta_v:
            tfm = self.index.transform
            vn, fn = tfm.normalize(*self._pending())
            self._delta = _DeltaBuffer(vn=vn, fn=fn, flat=flat_mod.build(
                tfm.apply_normalized(vn, fn),
                storage_dtype=self.index.config.resolved_storage_dtype()))
        return self._delta

    def compact(self):
        """Fold the pending inserts into the main index (``fcvi.extend``
        re-transforms the whole corpus; an IVF or PQ backend re-trains its
        k-means). A sharded engine re-shards the grown index (a flat
        cluster placement re-derives its router from the new corpus)."""
        if not self._delta_v:
            return
        v, f = self._pending()
        self.index = fcvi.extend(self.index, v, f)
        # the compacted rows' attribute values are the filters they were
        # inserted with; refresh the planner's histograms
        self._set_attrs(np.concatenate([self._attrs_np,
                                        np.concatenate(self._delta_f)]))
        self._delta_v, self._delta_f = [], []
        self._delta = None
        self._sharded_delta = None
        self._grouped_payload = None  # corpus changed: payload slabs stale
        self._router_centers = None   # corpus changed: re-derive the router
        if self._sharded is not None:
            self._build_sharded()
        self.stats.compactions += 1

    # -- range predicates (multi-probe) ------------------------------------
    def search_predicate(self, queries, pred: BoxPredicate):
        """Range or disjunctive predicate -> multi-probe (section 4.3):
        ``pred.probes(cfg.multi_probe_r)`` broadcast over the batch through
        ``fcvi.multi_probe_query``. queries (n, d) raw. Returns (scores (n,
        k) fp32, ids (n, k) int32) as tensors on the engine's device, as the
        reference returns device arrays; like it, this bypasses the cache,
        the batching and the delta tier."""
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        probes = pred.probes(self.cfg.multi_probe_r).to(self.device)
        fp = probes[None].expand(q.shape[0], *probes.shape)
        return fcvi.multi_probe_query(self.index, q, fp, self.cfg.k)

    # -- self-healing ------------------------------------------------------
    def heal(self, ckpt_dir: str, probe_queries=None, probe_filters=None, *,
             step: int = 0, background: bool = False):
        """Recover full coverage after shard loss by re-placing the corpus.

        Checkpoint -> restore the WHOLE corpus onto a mesh of the surviving
        shard positions (placement and routing kept; a cluster placement
        routes from the saved router centers) -> hold the candidate engine
        bit for bit against a meshless restore of the same checkpoint on
        ``probe_queries`` / ``probe_filters`` -> cut over under the heal
        lock (index, mesh, shards, delta tier, a fresh health layer, the
        cache cleared). Afterwards every row serves again and coverage is
        back to 100%.

        The reference asks for one device per shard and re-meshes onto the
        surviving devices. Here a shard is a mesh position, and several
        positions may share a card (all of them, on one card): the new mesh
        is the surviving shard positions, each on the device it had.

        Returns True on a checked cutover, False when the check failed (the
        degraded engine serves on, untouched). ``background=True`` runs the
        same flow on a daemon thread and returns the thread (join it, then
        read ``stats.heals``). Needs a sharded engine whose shards are its
        mesh positions, with at least one alive."""
        if background:
            t = threading.Thread(
                target=self.heal, args=(ckpt_dir, probe_queries,
                                        probe_filters),
                kwargs={"step": step}, daemon=True)
            t.start()
            return t
        if self._sharded is None or self.health is None:
            raise RuntimeError("heal() requires a sharded engine")
        if self._sharded.n_shards != self._mesh.size:
            raise NotImplementedError(
                "heal() assumes one shard per mesh position")
        alive_idx = np.nonzero(self.health.alive_mask())[0]
        if alive_idx.size == 0:
            raise RuntimeError("heal() needs at least one surviving shard")
        self.save(ckpt_dir, step=step)
        from repro_torch.launch.mesh import ShardMesh

        names = self._mesh.axis_names
        devices = np.empty((alive_idx.size,), dtype=object)
        for j, s in enumerate(alive_idx):
            devices[j] = self._sharded.devices[s]
        new_mesh = ShardMesh(
            devices=devices.reshape((alive_idx.size,)
                                    + (1,) * (len(names) - 1)),
            axis_names=names)
        cand = FCVIEngine.restore(ckpt_dir, step=step, config=self.cfg,
                                  device=self.device, mesh=new_mesh,
                                  rules=self._rules,
                                  placement=self._placement,
                                  routing=self._routing)
        if probe_queries is not None:
            ref = FCVIEngine.restore(ckpt_dir, step=step, config=self.cfg,
                                     device=self.device)
            s_new, i_new = cand.search(probe_queries, probe_filters)
            s_ref, i_ref = ref.search(probe_queries, probe_filters)
            if not (np.array_equal(s_new, s_ref)
                    and np.array_equal(i_new, i_ref)):
                return False
        with self._heal_lock:
            self.index = cand.index
            self._mesh = new_mesh
            self._attrs_np, self._attrs = cand._attrs_np, cand._attrs
            self._attr_names = cand._attr_names
            self._col_means = cand._col_means
            self.planner = cand.planner
            self._router_centers = cand._router_centers
            self._sharded = cand._sharded
            self._sharded_delta = cand._sharded_delta
            self._delta_v, self._delta_f = cand._delta_v, cand._delta_f
            self._delta = cand._delta
            self._grouped_payload = None
            self.health = ShardHealth(self._sharded.n_shards,
                                      straggler_z=self.cfg.straggler_z)
            self._alive_sig = None
            self._cache.clear()
            self.stats.heals += 1
        return True

    # -- checkpoint lifecycle ---------------------------------------------
    def save(self, ckpt_dir: str, step: int = 0, keep: int = 3) -> str:
        """Checkpoint the serving state in the JAX package's format: the
        index (``fcvi.index_state``: the transform, the backend's source
        arrays, the re-rank originals; derived slabs and shards are rebuilt
        on restore), the PENDING delta rows and the raw attribute table,
        with the configs and the serving knobs (placement, routing, the
        attribute names) in the manifest's metadata. A cluster-placed flat
        engine also saves its router's psi-cluster centers
        (``router|centers``, (ncl, d) fp32), so a restore onto any mesh, in
        either package, routes from the same clusters instead of running
        k-means again. Returns the step directory."""
        d = self.index.transform.vec_norm.mean.shape[-1]
        m = self.index.transform.filt_norm.mean.shape[-1]
        dv = (np.concatenate(self._delta_v) if self._delta_v
              else np.zeros((0, d), np.float32))
        df = (np.concatenate(self._delta_f) if self._delta_f
              else np.zeros((0, m), np.float32))
        tree = {"index": fcvi.index_state(self.index),
                "delta_v": dv, "delta_f": df, "attrs": self._attrs_np}
        if (self._sharded is not None
                and getattr(self._sharded.slab, "router_centers", None)
                is not None):
            tree["router"] = {"centers": self._sharded.slab.router_centers}
        metadata = {
            "fcvi_config": dataclasses.asdict(self.index.config),
            "engine_config": dataclasses.asdict(self.cfg),
            "serving": {"placement": self._placement,
                        "routing": self._routing,
                        "attr_names": list(self._attr_names)},
        }
        return ckpt_mod.save(ckpt_dir, step, tree, metadata=metadata,
                             keep=keep)

    @classmethod
    def restore(cls, ckpt_dir: str, *, step: Optional[int] = None,
                config: Optional[EngineConfig] = None,
                device: DeviceLike = "cuda", mesh=None, rules=None,
                routing: Optional[str] = None,
                placement: Optional[str] = None) -> "FCVIEngine":
        """An engine from a checkpoint of either package, on ``device``,
        meshless or onto ANY mesh (the elastic restart: build on 8 shards,
        restore and serve on 2).

        The index comes back through ``fcvi.index_from_state`` with no
        re-training; the attribute table and its names (and so the planner),
        the pending delta rows and ``stats.inserts`` are put back.
        ``config`` overrides the saved ``EngineConfig``; ``placement`` and
        ``routing`` default to the saved ones, and a saved
        ``router|centers`` pins the flat router. Meshless, routing is
        forced dense (routing needs shards to skip), as in the
        reference."""
        dev = resolve_device(device)
        tree, _, metadata = ckpt_mod.load(ckpt_dir, step=step)
        fcfg = _config_from(FCVIConfig, metadata["fcvi_config"],
                            ignore=_JAX_ONLY_FCVI_KEYS)
        index = fcvi.index_from_state(fcfg, tree["index"], device=dev)
        ecfg = (config if config is not None
                else _config_from(EngineConfig, metadata["engine_config"]))
        serving = metadata.get("serving", {})
        if placement is None:
            placement = serving.get("placement", "contiguous")
        if routing is None:
            routing = serving.get("routing", "dense")
        if mesh is None:
            routing = "dense"
        centers = None
        if "router" in tree and mesh is not None:
            centers = tree["router"]["centers"].to(torch.float32)
        eng = cls(index, ecfg, device=dev, mesh=mesh, rules=rules,
                  placement=placement, routing=routing,
                  router_centers=centers,
                  attributes=tree["attrs"].numpy(),
                  attr_names=serving.get("attr_names"))
        if tree["delta_v"].shape[0]:
            eng._delta_v = [tree["delta_v"].numpy().astype(np.float32)]
            eng._delta_f = [tree["delta_f"].numpy().astype(np.float32)]
            eng.stats.inserts = int(tree["delta_v"].shape[0])
        return eng


# the JAX package's FCVIConfig field with no counterpart here: it picks
# Pallas or jnp, which the port decides by the device of the inputs
_JAX_ONLY_FCVI_KEYS = ("use_pallas",)


def _config_from(cls, saved: dict, ignore=()):
    """``cls(**saved)`` without the ``ignore`` keys; any other key that
    ``cls`` lacks raises ValueError."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(saved) - names - set(ignore))
    if unknown:
        raise ValueError(f"checkpoint {cls.__name__} has unknown fields "
                         f"{unknown}")
    return cls(**{k: v for k, v in saved.items() if k in names})

