"""FCVI core: transform (psi), theory, the index and its queries, and the
baselines the paper compares against. Exports the names of
``repro.core`` beside the state handoff (``index_state``,
``index_from_state``)."""
from repro_torch.core.transform import (
    Normalizer,
    Transform,
    fit_transform,
    psi_partition,
    psi_cluster,
    psi_embedding,
    tiled_filter,
)
from repro_torch.core.fcvi import (
    FCVIConfig,
    FCVIIndex,
    build,
    query,
    multi_probe_query,
    ground_truth_combined,
    recall_at_k,
    extend,
    cosine_sim,
    index_state,
    index_from_state,
)
from repro_torch.core.baselines import (
    BoxPredicate,
    post_filter_search,
    pre_filter_search,
    build_hybrid,
    hybrid_search,
    ground_truth_filtered,
)
from repro_torch.core import theory

__all__ = [
    "Normalizer", "Transform", "fit_transform", "psi_partition", "psi_cluster",
    "psi_embedding", "tiled_filter", "FCVIConfig", "FCVIIndex", "build",
    "query", "multi_probe_query", "ground_truth_combined", "recall_at_k",
    "extend", "cosine_sim", "BoxPredicate", "post_filter_search",
    "pre_filter_search", "build_hybrid", "hybrid_search",
    "ground_truth_filtered", "theory", "index_state", "index_from_state",
]
