"""Logical-axis sharding rules for serving.

``AxisRules`` maps a logical name to the mesh axes it shards over (or to
None, replicated). Serving reads three entries: ``"corpus"`` (flat and PQ
rows, the re-rank originals, the delta tier), ``"ivf_lists"`` (whole
inverted lists) and ``"none"``. As in ``repro.distributed.sharding``, axes
the mesh lacks are dropped (``"pod"`` on a single-pod mesh), and an entry
left with no axis replicates. The model's logical names (batch, heads,
...) are ROADMAP A13.
"""
from __future__ import annotations

from typing import Optional, Tuple

# logical name -> mesh axis (or tuple of axes, or None = replicate)
DEFAULT_RULES = {
    "corpus": ("pod", "data"),     # FCVI corpus rows (flat/PQ slabs, rows)
    "ivf_lists": ("pod", "data"),  # FCVI IVF inverted lists (grouped slabs)
    "none": None,
}


class AxisRules:
    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        if mesh is not None:
            # drop axes the mesh does not have (e.g. "pod" on single-pod)
            have = set(mesh.axis_names)

            def fix(v):
                if v is None:
                    return None
                if isinstance(v, tuple):
                    kept = tuple(a for a in v if a in have)
                    return kept if kept else None
                return v if v in have else None

            self.rules = {k: fix(v) for k, v in self.rules.items()}

    def spec(self, *names: Optional[str]) -> Tuple:
        """The mesh axes of each dimension's logical name (None =
        replicated): the counterpart of a ``PartitionSpec``."""
        return tuple(self.rules.get(n or "none") for n in names)
