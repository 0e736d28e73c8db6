"""Deterministic synthetic LM token pipeline.

A first-order Markov chain over the vocabulary gives the models real,
learnable structure (loss decreases measurably within a few hundred steps) —
unlike uniform-random tokens — while remaining fully offline and reproducible.
Per-host sharded loading: each data-parallel host draws only its slice of the
global batch from a host-indexed PRNG stream (emulated single-host here).

Numpy only, as ``repro.data.tokens`` (copied whole; it never imported JAX):
the same spec gives the same batches, bit for bit, in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenSpec:
    vocab_size: int
    batch: int                 # per-host batch
    seq_len: int
    seed: int = 0
    branching: int = 16        # successors per token (lower = easier)
    host_id: int = 0
    n_hosts: int = 1


class MarkovTokens:
    """Infinite iterator of {"tokens": (batch, seq_len) int32} batches."""

    def __init__(self, spec: TokenSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        v, b = spec.vocab_size, spec.branching
        self.succ = rng.integers(0, v, size=(v, b)).astype(np.int32)
        probs = rng.dirichlet(np.ones(b) * 0.5, size=v).astype(np.float32)
        self.cum = np.cumsum(probs, axis=1)
        self._step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        s = self.spec
        rng = np.random.default_rng(
            (s.seed, s.host_id, self._step))
        self._step += 1
        b, L, v = s.batch, s.seq_len, s.vocab_size
        out = np.empty((b, L), np.int32)
        out[:, 0] = rng.integers(0, v, b)
        u = rng.random((b, L))
        for t in range(1, L):
            prev = out[:, t - 1]
            choice = (u[:, t][:, None] > self.cum[prev]).sum(axis=1)
            out[:, t] = self.succ[prev, np.minimum(choice, s.branching - 1)]
        return {"tokens": out}


def global_batch_iterator(spec: TokenSpec, extras: Optional[dict] = None):
    """Adds stub frontend inputs (frames/patches) when extras request them."""
    stream = MarkovTokens(spec)
    rng = np.random.default_rng(spec.seed + 101)
    for batch in stream:
        if extras:
            for key, shape in extras.items():
                batch[key] = rng.normal(size=(spec.batch, *shape)).astype(np.float32)
        yield batch
