"""Closed-form quantities from the paper's theory (section 5) that serving
needs: the optimal alpha (Thm 5.4) and the over-retrieval width k'
(Alg. 1 line 7). Plain Python, as in ``repro.core.theory``."""
from __future__ import annotations

import math


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
