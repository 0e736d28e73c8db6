"""AdamW + schedules, plain PyTorch. Mirrors ``repro.train.optimizer``.

Mixed-precision recipe: the optimizer keeps an fp32 MASTER copy plus fp32
moments, and the params are the master's cast. The state's leaves are
dicts keyed by the model's parameter names (``dict(named_parameters())``);
``models.model.to_jax_tree`` maps each to the reference's tree. A sharded
step (``train.loop``) places mu, nu and master ZeRO-1-split and runs
``update`` on each position's shard with the global gradient norm
(``gnorm``).

The arithmetic is the reference's, op by op and in its order, on fp32
tensors: clip by ``min(1, clip / (gnorm + 1e-9))``, ``step + 1``, the
moments, bias corrections ``1 - b ** step`` in fp32, and ``master - lr *
(mhat / (sqrt(vhat) + eps) + wd * master)``, with weight decay on every
leaf (norms and embeddings too). ``torch.optim.AdamW`` rounds in another
order and adds eps elsewhere, so it is not used.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor      # 0-d int32
    mu: dict
    nu: dict
    master: dict      # fp32 master weights (authoritative; params are its cast)


def init(params: dict) -> AdamWState:
    """Zero moments and an fp32 master copy of ``params`` ({name: tensor}),
    on the params' device."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    master = {k: p.detach().float().clone() for k, p in params.items()}
    dev = next(iter(params.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu={k: z.clone() for k, z in zeros.items()},
                      master=master)


def schedule(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio; ``step`` an int
    tensor, the result fp32 on its device."""
    step = torch.as_tensor(step)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict) -> Tensor:
    """sqrt of the sum over leaves, in order, of each leaf's fp32 sum of
    squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict,
           gnorm=None):
    """Returns (new_params, new_state, metrics ``grad_norm``, ``lr``); new
    params are the new master cast to each param's dtype. ``gnorm``: the
    gradients' global norm where ``grads`` hold only a shard of them (a
    sharded step's position); by default theirs."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    grads = {k: g.float() * scale for k, g in grads.items()}

    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    mu = {k: b1 * state.mu[k] + (1 - b1) * g for k, g in grads.items()}
    nu = {k: b2 * state.nu[k] + (1 - b2) * g * g for k, g in grads.items()}
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(master, m, v):
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * master
        return master - lr * delta

    new_master = {k: upd(state.master[k], mu[k], nu[k]) for k in grads}
    new_params = {k: new_master[k].to(p.dtype) for k, p in params.items()}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step=step, mu=mu, nu=nu,
                                  master=new_master), metrics
