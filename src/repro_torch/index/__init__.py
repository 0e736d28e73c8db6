"""Search backends over the transformed corpus: flat, IVF and residual
PQ."""
