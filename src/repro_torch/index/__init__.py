"""Search backends over the transformed corpus: flat and IVF (PQ is
ROADMAP A9)."""
