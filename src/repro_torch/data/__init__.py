"""Synthetic corpora (numpy) and the synthetic LM token stream."""
