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
transform kernel) -> candidates -> combined-cosine rescore (rescore kernel)
-> top-k -> delta-tier search + ``merge_topk`` -> escalation margin. The
flat backend's candidates are a scan + top-(k'+REFINE_PAD) (fused scan
kernel) and an exact refine; the IVF backend's are the coarse quantizer
(fused scan kernel over the centroids) and the probe-major scan of the
batch's unique probed lists (IVF dedup kernel). With ``gather_free`` the
scan kernels carry the winners' re-rank rows out. Eager PyTorch runs it as
it stands; there is no trace to count. Cache, stats and the escalation
decision are host-side.

Mirrors the meshless similarity-mode path of ``repro.serve.engine``.
Predicate search (``filter=``/``plan=``) is ROADMAP A7, meshes and routing
A12, checkpoints A10 and ``search_predicate`` A11; they raise here.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import fcvi, theory
from repro_torch.core.fcvi import FCVIIndex
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index import flat as flat_mod
from repro_torch.index import ivf as ivf_mod
from repro_torch.kernels.ref import topk_first
from repro_torch.serve.health import BackpressureError, TransientShardError

Tensor = torch.Tensor

# magnitudes beyond this overflow fp32 when squared in the scoring path; the
# input-hardening boundary rejects them as out of support
_SUPPORT_LIMIT = 1e18


@dataclasses.dataclass
class _DeltaBuffer:
    """Device-resident view of the un-compacted inserts."""

    vn: Tensor                 # (nd, d) normalized new vectors
    fn: Tensor                 # (nd, m) normalized new filters
    flat: flat_mod.FlatIndex   # transformed-space index over the delta rows


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
    are the same. ``grouped_payload`` is the IVF backend's (grouped_pv,
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
    score = fcvi.combined_score(rv, rf, qn, fqn, cfg.lam)
    scores, pos = topk_first(score, k)
    ids = torch.gather(cand, -1, pos)

    if delta is not None:
        # same over-retrieval bound as the main path (Thm 5.4); q_t is
        # reused, so the fused transform runs once
        dcand, drv, drf = _delta_candidates(delta, q_t, kd, gather_free)
        s = fcvi.combined_score(drv, drf, qn, fqn, cfg.lam)
        dvals, dpos = topk_first(s, min(k, kd))
        dids = index.size + torch.gather(dcand, -1, dpos)
        scores, ids = flat_mod.merge_topk(scores, ids, dvals,
                                          dids.to(ids.dtype), k)

    return scores, ids, scores[:, 0] - scores[:, -1]


@dataclasses.dataclass
class EngineConfig:
    """Serving-side knobs (host-side policy; none changes result values
    except ``k``)."""

    k: int = 10
    batch_size: int = 64
    cache_entries: int = 4096
    cache_round: float = 0.05      # filter-key quantization for cache hits
    escalate_margin: float = 0.02  # top-k score margin triggering stage 2
    kprime_escalation: int = 4     # stage-2 k' multiplier
    compact_threshold: int = 2048  # delta rows triggering compaction
    # gather-free re-rank: the scan emits the winners' re-rank rows instead
    # of ids that a second gather from vectors_n/filters_n resolves; the
    # results are the same either way
    gather_free: bool = True
    # -- resilience envelope (off the hot path) ---------------------------
    deadline_s: float = 0.0        # per-batch deadline; 0 disables the check
    max_retries: int = 2           # bounded retry on TransientShardError
    retry_backoff_s: float = 0.05  # base backoff, doubled per retry
    queue_budget: int = 0          # max cache-miss queue; 0 = unlimited


@dataclasses.dataclass
class EngineStats:
    """Host-side serving counters."""

    queries: int = 0
    cache_hits: int = 0
    escalations: int = 0
    inserts: int = 0
    compactions: int = 0
    total_time_s: float = 0.0
    # device-memory bytes the candidate scans stream, modeled per batch from
    # the slab sizes (see FCVIEngine._batch_scan_bytes)
    bytes_scanned: int = 0
    scan_batches: int = 0          # batches the bytes model accounted
    retries: int = 0               # TransientShardError retries
    deadline_misses: int = 0       # batches exceeding cfg.deadline_s
    backpressure_drops: int = 0    # queries shed by BackpressureError

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


class FCVIEngine:
    """Batched serving engine over one ``FCVIIndex`` on one device.

    ``search(queries (n, d), filters (n, m))`` takes and returns HOST numpy
    arrays: (scores (n, k) fp32, ids (n, k) int64); ids >= ``index.size``
    are un-compacted delta rows. ``insert(vectors, filters)`` buffers rows
    in the delta tier until ``compact_threshold`` triggers compaction.

    ``device`` (default ``"cuda"``) is where the engine serves; the index
    must live there. Asking for a card that is not there raises."""

    def __init__(self, index: FCVIIndex, config: Optional[EngineConfig] = None,
                 *, device: DeviceLike = "cuda", mesh=None,
                 routing: str = "dense"):
        if mesh is not None or routing != "dense":
            raise NotImplementedError(
                "mesh-sharded and routed serving are ROADMAP A12; the "
                "port serves meshless")
        self.device = resolve_device(device)
        if index.device != self.device:
            raise ValueError(
                f"the index lives on {index.device}, the engine serves on "
                f"{self.device}; build or load the index on the same device")
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
        # hook for a fault-injection harness: an object whose
        # ``before_batch()`` may raise TransientShardError
        self.fault_injector = None

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
        batch of ``b`` queries stream: the whole flat slab (vectors +
        squared norms), or the probed share of the IVF grouped slabs (capped
        at every list once, as the dedup scan reads a shared list once) plus
        the centroids; a pending delta adds its flat slab. The reference's
        model, so the two engines' counters agree."""
        be = self.index.backend
        cfg = self.index.config
        if cfg.backend == "ivf":
            slab = be.grouped.nbytes + be.grouped_sq.nbytes
            probed = min(b * min(cfg.nprobe, be.nlist), be.nlist)
            n = slab * probed // be.nlist + be.centroids.nbytes
        else:
            n = be.vectors.nbytes + be.sq_norms.nbytes
        if self._delta is not None:
            n += self._delta.flat.vectors.nbytes + self._delta.flat.sq_norms.nbytes
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

    # -- search -----------------------------------------------------------
    def search(self, queries: np.ndarray, filters: Optional[np.ndarray] = None,
               *, filter=None, plan: Optional[str] = None):
        """Similarity search: queries (n, d) and filters (n, m), raw fp32.
        Returns (scores (n, k) fp32, ids (n, k) int64).

        Inputs are validated here (see ``_validate_inputs``). Raises
        ``BackpressureError`` when the cache-miss queue exceeds
        ``cfg.queue_budget`` (> 0). Predicate search (``filter=``,
        ``plan=``) is ROADMAP A7."""
        if filter is not None or plan is not None:
            raise NotImplementedError(
                "predicate search (filter=, plan=) is ROADMAP A7")
        if filters is None:
            raise TypeError("search() needs filters= (similarity mode)")
        queries, filters = self._validate_inputs(queries, filters)
        t0 = time.perf_counter()
        n = queries.shape[0]
        k = self.cfg.k
        out_scores = np.zeros((n, k), np.float32)
        out_ids = np.zeros((n, k), np.int64)

        keys = self._cache_keys(queries, filters)
        todo = []
        for i, key in enumerate(keys):
            hit = self._cache_get(key)
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

        bs = self.cfg.batch_size
        for s in range(0, len(todo), bs):
            idxs = todo[s:s + bs]
            # zero rows pad the batch to its fixed size; they only affect
            # the padded rows' own results, which are dropped
            q = np.zeros((bs, queries.shape[1]), np.float32)
            f = np.zeros((bs, filters.shape[1]), np.float32)
            q[:len(idxs)], f[:len(idxs)] = queries[idxs], filters[idxs]
            scores, ids = self._dispatch_batch(
                torch.tensor(q, device=self.device),
                torch.tensor(f, device=self.device), k, n_real=len(idxs))
            self.stats.bytes_scanned += self._batch_scan_bytes(bs)
            self.stats.scan_batches += 1
            scores = scores.cpu().numpy()
            ids = ids.cpu().numpy().astype(np.int64)
            for j, i in enumerate(idxs):
                out_scores[i], out_ids[i] = scores[j], ids[j]
                self._cache_put(keys[i], (scores[j], ids[j]))

        self.stats.queries += n
        self.stats.total_time_s += time.perf_counter() - t0
        return out_scores, out_ids

    def _dispatch_batch(self, q: Tensor, f: Tensor, k: int, n_real: int):
        """One padded batch through the resilience envelope: bounded retry
        with exponential backoff on ``TransientShardError`` and a per-batch
        deadline counter."""
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                if self.fault_injector is not None:
                    self.fault_injector.before_batch()
                out = self._run_batch(q, f, k, n_real=n_real)
            except TransientShardError:
                attempt += 1
                self.stats.retries += 1
                if attempt > self.cfg.max_retries:
                    raise
                time.sleep(self.cfg.retry_backoff_s * (2 ** (attempt - 1)))
                continue
            if self.cfg.deadline_s and (time.perf_counter() - t0
                                        > self.cfg.deadline_s):
                self.stats.deadline_misses += 1
            return out

    def _run_batch(self, q: Tensor, f: Tensor, k: int, n_real: int):
        """One padded batch through the step, then stage-2 escalation for
        the real rows whose top-k margin is below ``escalate_margin``: they
        re-run with k' scaled by ``kprime_escalation`` in a power-of-two
        sub-batch and are scattered back. Pad rows never trigger (or count
        as) escalations. Returns (scores (b, k), ids (b, k))."""
        cfg = self.index.config
        alpha = cfg.resolved_alpha()
        kp = theory.k_prime(k, cfg.lam, alpha, self.index.size, cfg.c)
        delta = self._ensure_delta()
        kd = 0
        if delta is not None:
            nd = delta.vn.shape[0]
            kd = min(nd, max(theory.k_prime(k, cfg.lam, alpha, nd, cfg.c),
                             4 * k))
        scores, ids, margin = self._step(delta, q, f, k=k, kp=kp, kd=kd)
        need = (margin < self.cfg.escalate_margin)[:n_real].cpu().numpy()
        if need.any():
            idxs = np.nonzero(need)[0]
            self.stats.escalations += len(idxs)
            kp2 = theory.k_prime(k, cfg.lam, alpha, self.index.size,
                                 cfg.c * self.cfg.kprime_escalation)
            s2, i2, _ = self._dense_subbatch(delta, q, f, idxs, k=k, kp=kp2,
                                             kd=kd)
            take = torch.as_tensor(idxs, device=q.device)
            scores[take] = s2
            ids[take] = i2
        return scores, ids

    def _dense_subbatch(self, delta, q: Tensor, f: Tensor, idxs, *, k: int,
                        kp: int, kd: int):
        """Re-run rows ``idxs`` of the padded batch through the step in the
        smallest power-of-two sub-batch that holds them (halving the batch
        size); pad slots recompute query 0. Returns the rows for ``idxs``."""
        nb = q.shape[0]
        while nb // 2 >= max(len(idxs), 1):
            nb //= 2
        sel = np.zeros((nb,), np.int64)
        sel[: len(idxs)] = idxs
        sel_t = torch.as_tensor(sel, device=q.device)
        out = self._step(delta, q[sel_t], f[sel_t], k=k, kp=kp, kd=kd)
        return tuple(o[: len(idxs)] for o in out)

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
              kd: int):
        return _batch_step(self.index, delta, q, f, k=k, kp=kp, kd=kd,
                           gather_free=self.cfg.gather_free,
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
        index's frozen normalizers (lazy, so back-to-back inserts cost
        nothing until a query)."""
        if self._delta is None and self._delta_v:
            tfm = self.index.transform
            vn, fn = tfm.normalize(*self._pending())
            self._delta = _DeltaBuffer(
                vn=vn, fn=fn, flat=flat_mod.build(tfm.apply_normalized(vn, fn)))
        return self._delta

    def compact(self):
        """Fold the pending inserts into the main index (``fcvi.extend``
        re-transforms the whole corpus; an IVF backend re-trains its
        k-means)."""
        if not self._delta_v:
            return
        self.index = fcvi.extend(self.index, *self._pending())
        self._delta_v, self._delta_f = [], []
        self._delta = None
        self._grouped_payload = None  # corpus changed: payload slabs stale
        self.stats.compactions += 1

    # -- later slices -------------------------------------------------------
    def search_predicate(self, queries, pred):
        raise NotImplementedError(
            "multi-probe predicate search is ROADMAP A11")

    def heal(self, *args, **kwargs):
        raise NotImplementedError("shard health and heal() are ROADMAP A12")

    def save(self, *args, **kwargs):
        raise NotImplementedError("engine checkpoints are ROADMAP A10")

    @classmethod
    def restore(cls, *args, **kwargs):
        raise NotImplementedError("engine checkpoints are ROADMAP A10")
