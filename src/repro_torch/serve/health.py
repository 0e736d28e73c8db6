"""Shard health for sharded serving, and the resilience envelope's
exception types.

``ShardHealth`` tracks the liveness of the shards of one ``ShardedServing``
mesh with ``distributed.fault.HeartbeatTracker`` at shard granularity: one
"host" per shard, one "step" per dispatched engine batch. The engine feeds
it each batch's per-shard times (the fault injector's synthetic ones, or
the batch's wall time for every shard: the shards of one process run back
to back, so per-shard timing is only observable through injection) and
reads ``alive_mask()`` before every search:

  * a shard marked dead (``mark_dead``, a heartbeat timeout found by
    ``check_failures``, or a straggler evicted inside ``record_batch``) is
    skipped by the sharded step: it launches nothing and none of its
    tensors is read;
  * the engine then serves DEGRADED: results equal a search over the
    surviving shards' rows, and queries the dead shards could have changed
    carry a coverage flag (``EngineStats.last_coverage``);
  * ``FCVIEngine.heal`` checkpoints, restores the whole corpus onto the
    surviving shard positions, checks the new engine bit for bit and cuts
    over with a fresh health layer.

The straggler test is a sample-sd z-score, and the z of ONE outlier in a
fleet of n is at most (n - 1) / sqrt(n) (about 2.47 for n = 8): a small
fleet needs ``straggler_z`` below that bound to ever evict a single slow
shard. ``TransientShardError`` is what the engine's bounded retry catches;
``BackpressureError`` is raised when the cache-miss queue exceeds
``EngineConfig.queue_budget``. Mirrors ``repro.serve.health``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.distributed import fault


class TransientShardError(RuntimeError):
    """A per-batch dispatch failure worth retrying (with backoff)."""


class BackpressureError(RuntimeError):
    """The dispatch queue exceeded the engine's queue budget; shed load."""


class ShardHealth:
    """Liveness and straggler tracking for the shards of one serving mesh."""

    def __init__(self, n_shards: int, *, alpha: float = 0.2,
                 straggler_z: float = 3.0, straggler_patience: int = 3,
                 timeout_steps: int = 2, evict_stragglers: bool = True):
        self.n_shards = n_shards
        self.tracker = fault.HeartbeatTracker(
            n_hosts=n_shards, alpha=alpha, straggler_z=straggler_z,
            straggler_patience=straggler_patience,
            timeout_steps=timeout_steps)
        self.evict_stragglers = evict_stragglers
        self._batch = 0          # monotone batch counter == heartbeat step

    # -- heartbeat feed ----------------------------------------------------
    def record_batch(self, shard_times: Sequence[float]) -> list:
        """Record one batch's per-shard times. Dead shards are skipped (they
        produced no heartbeat). Shards ``straggler_z`` sigma slower than the
        fleet for ``straggler_patience`` batches in a row are evicted (marked
        dead) when ``evict_stragglers`` is set; returns the evicted ids."""
        step = self._batch
        self._batch += 1
        for s, t in enumerate(shard_times):
            if s < self.n_shards and self.tracker.hosts[s].alive:
                self.tracker.record(s, step, float(t))
        if not self.evict_stragglers:
            return []
        evicted = [s for s in self.tracker.stragglers()
                   if self.tracker.hosts[s].alive]
        if evicted:
            self.tracker.mark_dead(evicted)
        return evicted

    def check_failures(self) -> list:
        """Mark (and return) shards silent past the heartbeat timeout."""
        dead = self.tracker.failures(self._batch)
        if dead:
            self.tracker.mark_dead(dead)
        return dead

    # -- liveness ----------------------------------------------------------
    def mark_dead(self, shards: Sequence[int]):
        self.tracker.mark_dead(list(shards))

    def mark_alive(self, shards: Sequence[int]):
        self.tracker.mark_alive(list(shards))

    def alive_mask(self) -> np.ndarray:
        """(n_shards,) bool: True for shards still serving."""
        mask = np.zeros((self.n_shards,), bool)
        mask[self.tracker.alive_hosts()] = True
        return mask

    def dead_shards(self) -> list:
        return [s for s in range(self.n_shards)
                if not self.tracker.hosts[s].alive]

    def any_dead(self) -> bool:
        return len(self.tracker.alive_hosts()) < self.n_shards

    def n_alive(self) -> int:
        return len(self.tracker.alive_hosts())
