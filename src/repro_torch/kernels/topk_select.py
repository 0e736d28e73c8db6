"""The selection path's select alone, over a score matrix already on the card.

The scans' selection path (``fused_score_topk``, ``ivf_score``, ``pq_lut``
past their candidate buffers) writes every score to a (b, n) scratch and
then runs the multi-block radix select of ``csrc/select_common.cuh``:
histogram passes over (query, chunk), a compaction of each query's
candidates into a buffer, and one block per query that selects among them
and sorts. ``select_topk`` runs those same kernels on a caller's (b, n)
fp32 scores (the flat scan's source: -inf and NaN do not compete, -0.0
counts as +0.0), so the select can be timed and checked on its own beside
``torch.topk`` on the same scores. Its launches count under
``_build.SELECT_NAME``, as the scans' selection paths count theirs. The
plain version is ``ref.ref_select_topk``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build


def select_topk(scores: torch.Tensor, k: int, *,
                _cap: Optional[int] = None,
                _stats: Optional[torch.Tensor] = None):
    """scores (b, n) float32 on one CUDA device, any k >= 1. Returns (vals
    (b, k) f32, ids (b, k) int32): each row's k best by (score desc, column
    asc), unfilled slots (-inf, 0). ``_cap`` sets the candidate buffer's
    words a query (at least min(k, n)): a small one forces the histogram
    passes over the full row, for the tests and ``scripts/profile_topk.py``;
    ``_stats`` (``_build.select_stats``) takes each launch's span."""
    if scores.dim() != 2:
        raise ValueError("scores must be 2-D")
    b, n = scores.shape
    dev = scores.device
    _build.require(scores, "scores", (b, n), dev)
    p = _build.select_plan(
        b, n, k, torch.cuda.get_device_properties(dev).multi_processor_count,
        cap=_cap)
    args, scratch = _build.select_args(p, b, k, dev, _stats)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.fcvi_select_topk(scores.data_ptr(), n, _build.addr(args),
                                    vals.data_ptr(), ids.data_ptr(),
                                    _build.stream(dev))
    _build.check(code, _build.SELECT_NAME)
    _build.count(_build.SELECT_NAME)
    return vals, ids
