"""Search backends over the transformed corpus (flat in this slice)."""
