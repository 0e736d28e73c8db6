"""Closed-form quantities from the paper's theory (section 5): the
transformed distance identity (Thm 5.1), alpha* for complete cluster
separation (Thm 5.3), the optimal alpha and the over-retrieval width k'
(Thm 5.4, Alg. 1 line 7). Mirrors ``repro.core.theory``: ``optimal_alpha``
and ``k_prime`` are plain Python (they size static shapes), the rest take
floats or tensors and return float32 tensors."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def transformed_sq_distance(v_a, v_b, f_a, f_b, alpha: float):
    """Closed form of ||psi(v_a,f_a,a) - psi(v_b,f_b,a)||^2 (Thm 5.1 proof):
    ||va - vb||^2 + (d/m) a^2 ||fa - fb||^2 - 2 a sum_j <va^(j) - vb^(j),
    fa - fb>."""
    d, m = v_a.shape[-1], f_a.shape[-1]
    segs = d // m
    dv = (v_a - v_b).reshape(*v_a.shape[:-1], segs, m)
    df = f_a - f_b
    base = torch.sum((v_a - v_b) ** 2, dim=-1)
    quad = segs * alpha ** 2 * torch.sum(df * df, dim=-1)
    cross = 2.0 * alpha * torch.sum(dv * df[..., None, :], dim=(-1, -2))
    return base + quad - cross


def alpha_star(d_v, delta_f, d: int, m: int):
    """Thm 5.3: the least alpha that guarantees complete cluster
    separation, sqrt((2 D_v + D_v^2) / ((d/m) delta_f^2 - 2 D_v delta_f));
    +inf unless (d/m) delta_f > 2 D_v (feasibility)."""
    segs = d / m
    denom = segs * delta_f ** 2 - 2.0 * d_v * delta_f
    feasible = torch.as_tensor(segs * delta_f > 2.0 * d_v)
    val = torch.sqrt(torch.clamp(_f32(2.0 * d_v + d_v ** 2), min=0.0)
                     / torch.clamp(_f32(denom), min=1e-30))
    return torch.where(feasible & (_f32(denom) > 0), val, math.inf)


def optimal_alpha(lam: float) -> float:
    """Thm 5.4 optimality note: alpha = sqrt((1-lam)/lam), clipped to >= 1."""
    lam = min(max(float(lam), 1e-6), 1.0)
    return max(1.0, math.sqrt((1.0 - lam) / lam))


def k_prime(k: int, lam: float, alpha: float, n: int, c: float = 4.0) -> int:
    """Alg. 1 line 7: k' = min(c * k/lam * 1/alpha^2, N), at least k."""
    lam = max(float(lam), 1e-6)
    alpha = max(float(alpha), 1.0)
    kp = int(c * (k / lam) * (1.0 / alpha**2))
    return max(k, min(max(kp, k), n))


def separation_margin(d_v, delta_f, d: int, m: int, alpha):
    """Worst-case inter-cluster distance minus the intra-cluster diameter
    (Thm 5.3's proof: inter^2 >= (d/m) a^2 delta_f^2 - 2 a D_v delta_f,
    intra <= D_v); positive means complete separation."""
    segs = d / m
    inter_sq = torch.clamp(_f32(segs * alpha ** 2 * delta_f ** 2
                                - 2.0 * alpha * d_v * delta_f), min=0.0)
    return torch.sqrt(inter_sq) - d_v


def cluster_stats(filters: torch.Tensor, labels=None):
    """delta_f: the least distance between filters of different labels
    (every row its own label when ``labels`` is None). O(n^2): for small
    n."""
    f = filters
    sq = torch.sum(f * f, dim=-1)
    d2 = torch.clamp(sq[:, None] - 2.0 * (f @ f.T) + sq[None, :], min=0.0)
    if labels is None:
        labels = torch.arange(f.shape[0], device=f.device)
    diff = labels[:, None] != labels[None, :]
    return torch.sqrt(torch.min(torch.where(diff, d2, math.inf)))
