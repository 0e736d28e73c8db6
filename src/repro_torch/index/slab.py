"""The IVF serving layout: dense (nlist, max_list, ...) slabs grouped by
list. Mirrors ``build_grouped`` of ``repro.index.slab``; the sharded slab
classes are ROADMAP A12."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def build_grouped(vectors: Tensor, sq_norms: Tensor, lists: Tensor):
    """Materialise the (nlist, max_list, d) serving slabs from id lists.

    ``lists`` is (nlist, max_list) int32 corpus ids with -1 padding. Returns
    (grouped, grouped_sq, valid) with ``valid`` float 0/1 (1 = real row);
    pad slots hold corpus row 0, masked by ``valid``, as in the reference."""
    safe = torch.clamp(lists, min=0).long()
    return (vectors[safe], sq_norms[safe], (lists >= 0).to(torch.float32))
