"""Deterministic fault injection for degraded-serving tests and runs.

Three families of faults, all reproducible (no randomness, no timing
races):

  * dispatch faults: ``FaultInjector`` attaches to ``FCVIEngine`` (as
    ``engine.fault_injector``) and (a) raises ``TransientShardError`` for
    the next N batches, driving the bounded retry and backoff, and (b)
    feeds SYNTHETIC per-shard times to the health layer's heartbeat (slow
    shards -> straggler eviction): the shards of one process run back to
    back, so per-shard time is not otherwise observable.
  * shard loss: not injected here (``engine.health.mark_dead``); this
    module gives the ground truth to hold degraded results to:
    ``surviving_reference(engine)``, a meshless engine over the same corpus
    with every dead shard's rows invalidated in place (flat: a +inf squared
    norm, so the scan scores them -inf; IVF: the dead lists emptied and the
    grouped slabs rebuilt). Invalidating instead of deleting keeps
    ``index.size``, and so k' and the escalation thresholds, the degraded
    engine's, so whole ``engine.search`` results must be bit-equal.
  * state corruption: ``corrupt_checkpoint`` tears, flips or erases part
    of an on-disk checkpoint step, for the checkpoint's integrity checks
    and its walk back to the newest intact step.

Mirrors ``repro.serve.faultinject``; PQ has no surviving reference there
either.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import numpy as np
import torch

from repro_torch.serve.health import TransientShardError


@dataclasses.dataclass
class FaultInjector:
    """Deterministic per-batch fault source for ``FCVIEngine``.

    ``transient_failures``: the next N dispatched batches raise
    ``TransientShardError`` from ``before_batch`` (the engine retries with
    backoff; N <= ``cfg.max_retries`` succeeds in the end, more
    propagates). ``slow_shards``: shard -> slowdown factor of its synthetic
    heartbeat times (a persistently slow shard is evicted).
    ``base_step_time``: the healthy synthetic per-shard time in seconds."""

    transient_failures: int = 0
    slow_shards: Dict[int, float] = dataclasses.field(default_factory=dict)
    base_step_time: float = 0.01
    injected: int = 0

    def before_batch(self):
        if self.transient_failures > 0:
            self.transient_failures -= 1
            self.injected += 1
            raise TransientShardError(
                f"injected transient dispatch failure "
                f"({self.transient_failures} left)")

    def shard_times(self, n_shards: int, elapsed: float) -> List[float]:
        return [self.base_step_time * self.slow_shards.get(s, 1.0)
                for s in range(n_shards)]


# ---------------------------------------------------------------------------
# Ground truth for shard loss: the surviving-rows reference engine
# ---------------------------------------------------------------------------

def surviving_row_mask(engine) -> np.ndarray:
    """(index.size,) bool: True for rows whose owning shard is alive.
    Ownership is the SLAB placement (``ShardedServing.slab_row_owner``): a
    shard's death removes exactly its block from candidate generation; the
    re-rank originals of the survivors' rows and the delta tier serve on."""
    owner = engine._sharded.slab_row_owner()
    return engine.health.alive_mask()[owner]


def surviving_reference(engine):
    """A meshless engine whose candidate space is exactly the survivors:
    the same transform, re-rank originals, ``index.size``, configs,
    attribute table and pending delta rows, on the engine's device.
    Degraded ``engine.search`` results must equal its results bit for
    bit."""
    from repro_torch.index import ivf as ivf_mod
    from repro_torch.serve.engine import FCVIEngine

    idx = engine.index
    mask = torch.as_tensor(surviving_row_mask(engine), device=idx.device)
    b = idx.backend
    if idx.config.backend == "flat":
        # a +inf squared norm makes the scan's score -inf: a dead row never
        # enters the candidates
        backend = dataclasses.replace(
            b, sq_norms=torch.where(mask, b.sq_norms, float("inf")))
    elif idx.config.backend == "ivf":
        # empty the dead shards' lists; the centroids stay, so the probes
        # are the degraded step's
        l2s = engine._sharded.slab.list_to_shard
        dead_list = torch.as_tensor(~engine.health.alive_mask()[l2s],
                                    device=idx.device)
        lists = torch.where(dead_list[:, None], -1, b.lists)
        sizes = torch.where(dead_list, 0, b.list_sizes)
        backend = ivf_mod.from_lists(b.vectors, b.centroids, lists, sizes,
                                     b.scales)
    else:
        raise NotImplementedError(
            f"surviving_reference: backend {idx.config.backend!r}")
    ref = FCVIEngine(dataclasses.replace(idx, backend=backend),
                     dataclasses.replace(engine.cfg), device=engine.device,
                     attributes=engine._attrs_np,
                     attr_names=engine._attr_names)
    ref._delta_v = [np.array(v, copy=True) for v in engine._delta_v]
    ref._delta_f = [np.array(f, copy=True) for f in engine._delta_f]
    return ref


# ---------------------------------------------------------------------------
# Checkpoint corruption
# ---------------------------------------------------------------------------

def corrupt_checkpoint(ckpt_dir: str, step: int, mode: str = "truncate"):
    """Deterministically damage one on-disk checkpoint step. ``mode``:
    'truncate' cuts arrays.npz in half (a torn write); 'flip' XORs one byte
    in the middle of arrays.npz (bit rot, caught by the manifest's
    checksums); 'erase_manifest' makes manifest.json unparseable."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    npz = os.path.join(d, "arrays.npz")
    if mode == "truncate":
        size = os.path.getsize(npz)
        with open(npz, "r+b") as f:
            f.truncate(size // 2)
    elif mode == "flip":
        size = os.path.getsize(npz)
        with open(npz, "r+b") as f:
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
    elif mode == "erase_manifest":
        with open(os.path.join(d, "manifest.json"), "w") as f:
            f.write("{ torn json")
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


# ---------------------------------------------------------------------------
# Poisoned inputs (for the input-hardening boundary tests)
# ---------------------------------------------------------------------------

def poisoned_inputs(d: int, m: int) -> list:
    """(name, queries, filters) triples that ``engine.search`` must reject
    with a ``ValueError`` instead of producing garbage top-k."""
    q = np.zeros((2, d), np.float32)
    f = np.zeros((2, m), np.float32)
    qn = q.copy()
    qn[0, 0] = np.nan
    qi = q.copy()
    qi[1, -1] = np.inf
    fn = f.copy()
    fn[0, 0] = np.nan
    fhuge = f.copy()
    fhuge[0, 0] = 1e30
    return [
        ("nan_query", qn, f),
        ("inf_query", qi, f),
        ("nan_filter", q, fn),
        ("out_of_support_filter", q, fhuge),
        ("dim_mismatch_query", np.zeros((2, d + 1), np.float32), f),
        ("dim_mismatch_filter", q, np.zeros((2, m + 1), np.float32)),
        ("batch_mismatch", q, np.zeros((3, m), np.float32)),
        ("empty_batch", np.zeros((0, d), np.float32),
         np.zeros((0, m), np.float32)),
        ("not_2d", np.zeros((d,), np.float32), f),
    ]
