"""Search backends over the transformed corpus (flat, IVF and residual
PQ), their serving slabs and shard layouts, and the cross-shard merges."""
