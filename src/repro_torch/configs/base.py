"""Config registry: every architecture the reference names is a selectable
``--arch``. Mirrors ``repro.configs.base``.

``get_config(name)`` returns the full published config; ``reduced(cfg)``
returns a family-preserving miniature (same pattern, same block kinds, same
MoE-ness) for CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models.model import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list:
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving miniature for CPU tests."""
    period = cfg.period
    n_layers = max(period, 2 if period == 1 else period)
    changes = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 32) if cfg.window else cfg.window,
        n_enc_layers=2 if cfg.enc_dec else 0,
        n_prefix=8 if cfg.n_prefix else 0,
        d_rnn=64 if cfg.d_rnn else 0,
        lstm_chunk=16,
        q_chunk=32,
        kv_chunk=32,
        remat=False,
    )
    if cfg.is_moe:
        changes.update(moe_experts=4, moe_top_k=2, moe_d_ff=64)
    return dataclasses.replace(cfg, **changes)
