"""Fault-tolerance coordinator logic: heartbeats, stragglers, elastic restart.

Pure, host-side policies over simulated cluster state, as in
``repro.distributed.fault`` (copied whole; it never imported JAX): the
serving health layer (``repro_torch.serve.health``) runs a
``HeartbeatTracker`` with one "host" per shard and one "step" per engine
batch, and ``plan_restart`` / ``reassign_microbatches`` are the elastic
restart plans.

* crash-only recovery: any host loss degrades to "load the newest complete
  checkpoint on the largest feasible mesh";
* straggler mitigation: an EWMA z-score on per-host step times; persistent
  stragglers are evicted exactly like failures (re-mesh without them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass
class HostStats:
    host_id: int
    ewma: float = 0.0
    var: float = 0.0
    n: int = 0
    last_step: int = -1
    alive: bool = True


class HeartbeatTracker:
    """Tracks per-host step completion times; flags stragglers/failures."""

    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 straggler_z: float = 3.0, straggler_patience: int = 3,
                 timeout_steps: int = 2):
        self.hosts = {h: HostStats(h) for h in range(n_hosts)}
        self.alpha = alpha
        self.straggler_z = straggler_z
        self.patience = straggler_patience
        self.timeout_steps = timeout_steps
        self._strag_count: dict = {h: 0 for h in range(n_hosts)}

    def record(self, host_id: int, step: int, step_time: float):
        st = self.hosts[host_id]
        if st.n == 0:
            st.ewma, st.var = step_time, 0.0
        else:
            d = step_time - st.ewma
            st.ewma += self.alpha * d
            st.var = (1 - self.alpha) * (st.var + self.alpha * d * d)
        st.n += 1
        st.last_step = step

    def _fleet_stats(self) -> tuple:
        ewmas = [s.ewma for s in self.hosts.values() if s.alive and s.n > 0]
        if not ewmas:
            return 0.0, 1.0
        mean = sum(ewmas) / len(ewmas)
        var = sum((e - mean) ** 2 for e in ewmas) / max(len(ewmas) - 1, 1)
        return mean, math.sqrt(max(var, 1e-12))

    def stragglers(self) -> list:
        """Hosts persistently z-sigma slower than the fleet."""
        mean, sd = self._fleet_stats()
        out = []
        for h, st in self.hosts.items():
            if not st.alive or st.n < self.patience:
                continue
            z = (st.ewma - mean) / max(sd, 1e-9)
            if z > self.straggler_z:
                self._strag_count[h] += 1
            else:
                self._strag_count[h] = 0
            if self._strag_count[h] >= self.patience:
                out.append(h)
        return out

    def failures(self, current_step: int) -> list:
        """Hosts silent for more than ``timeout_steps`` steps.

        A host that has NEVER recorded counts its silence from step 0 (not
        from the ``last_step = -1`` sentinel), so a fresh tracker at step 0
        reports no failures — nobody has had a chance to heartbeat yet.
        """
        return [h for h, st in self.hosts.items()
                if st.alive
                and current_step - max(st.last_step, 0) > self.timeout_steps]

    def mark_dead(self, host_ids: Sequence[int]):
        for h in host_ids:
            self.hosts[h].alive = False

    def mark_alive(self, host_ids: Sequence[int]):
        """Resurrect hosts (the self-healing cutover path): alive again with
        a clean straggler record, EWMA history retained."""
        for h in host_ids:
            self.hosts[h].alive = True
            self._strag_count[h] = 0

    def alive_hosts(self) -> list:
        return [h for h, st in self.hosts.items() if st.alive]


# ---------------------------------------------------------------------------
# Elastic restart planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RestartPlan:
    mesh_shape: tuple          # new (data, model) or (pod, data, model)
    n_devices: int
    dropped_hosts: tuple
    batch_scale: float         # new_global_batch / old_global_batch


def plan_restart(n_alive_devices: int, model_parallel: int,
                 old_mesh_shape: tuple, dropped_hosts: Sequence[int],
                 pods: int = 1) -> Optional[RestartPlan]:
    """Largest feasible (data, model) mesh keeping TP size fixed.

    TP ('model') must stay intact (param shardings depend on it); the data
    axis shrinks to the largest multiple that fits the survivors. Returns
    None when fewer than one TP group survives.
    """
    per_pod = n_alive_devices // max(pods, 1)
    data = per_pod // model_parallel
    if data < 1:
        return None
    old_data = old_mesh_shape[-2] if len(old_mesh_shape) >= 2 else 1
    shape = (pods, data, model_parallel) if pods > 1 else (data, model_parallel)
    return RestartPlan(
        mesh_shape=shape,
        n_devices=pods * data * model_parallel,
        dropped_hosts=tuple(sorted(dropped_hosts)),
        batch_scale=data / max(old_data, 1),
    )


def reassign_microbatches(n_micro: int, alive_hosts: Sequence[int]) -> dict:
    """Deterministic microbatch -> host map after an eviction (round-robin).

    Keeps every microbatch owned (no data loss) while the evicted host's
    share is spread evenly — the straggler-mitigation data plan.
    """
    alive = sorted(alive_hosts)
    return {mb: alive[mb % len(alive)] for mb in range(n_micro)}
