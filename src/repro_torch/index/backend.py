"""SearchBackend - the serving interface an FCVI index queries.

``search(queries, k) -> (scores, ids)``: queries (q, d) in the backend's
(transformed) space; scores (q, k) float32, descending, negative squared L2
for the exact backends (negative squared ADC distance for PQ); ids (q, k)
int32 corpus row ids. Rows that cannot be filled carry ``-inf`` scores
(and id 0). Kernel dispatch follows the
device of the backend's tensors (``repro_torch.kernels.ops``). Mirrors
``repro.index.backend``; the port has the flat (``index.flat.FlatIndex``),
IVF (``index.ivf.IVFIndex``, whose ``search`` also takes ``nprobe``) and
residual-PQ (``index.pq.PQIndex``) backends.
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import torch

Tensor = torch.Tensor


@runtime_checkable
class SearchBackend(Protocol):
    """Anything FCVI can serve from: sized and searchable."""

    @property
    def size(self) -> int:
        """Number of indexed corpus rows."""
        ...

    def search(self, queries: Tensor, k: int) -> Tuple[Tensor, Tensor]:
        """Top-k search; see the module docstring for the contract."""
        ...
