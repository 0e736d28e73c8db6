"""Decoder language models: layers, attention with KV caches, and the model
(forward, prefill, decode). Mirrors ``repro.models``."""
