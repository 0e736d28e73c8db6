"""Plain PyTorch versions of every kernel of the port.

Each ``ref_*`` function is the semantic ground truth of the CUDA kernel of
the same name: ``repro_torch.kernels.ops`` runs it for tensors on the CPU,
and the card-only tests and ``chip_smoke.py`` hold each kernel against it on
the same CUDA tensors. They mirror ``repro/kernels/ref.py`` expression for
expression, so the CPU tests can hold them against the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def topk_first(x: Tensor, k: int):
    """Top-k along the last axis, descending, keeping the FIRST occurrence
    on equal values (``lax.top_k``'s order; ``torch.topk`` does not promise
    it). A stable descending sort keeps equal values in index order.
    Returns (values, int64 positions)."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def partition_matrix(d: int, m: int, dtype=torch.float32,
                     device=None) -> Tensor:
    """P in R^{m x d} with P[i, j] = 1 iff j % m == i, so that
    psi_partition(v, f, a) == v - a * (f @ P)."""
    cols = torch.arange(d, device=device) % m
    return (cols[None, :] == torch.arange(m, device=device)[:, None]).to(dtype)


def ref_fused_transform(v: Tensor, f: Tensor, proj: Tensor, alpha: float,
                        mean_v: Optional[Tensor] = None,
                        std_v: Optional[Tensor] = None,
                        mean_f: Optional[Tensor] = None,
                        std_f: Optional[Tensor] = None) -> Tensor:
    """((v - mu_v) / sd_v) - alpha * ((f - mu_f) / sd_f) @ proj; a missing
    normalizer pair is the identity."""
    vn = v if mean_v is None else (v - mean_v) / std_v
    fn = f if mean_f is None else (f - mean_f) / std_f
    return vn - alpha * (fn @ proj)


def ref_score_topk(corpus: Tensor, sq_norms: Tensor, queries: Tensor, k: int):
    """Exact negative-squared-L2 top-k (plain variant): (vals (q, k) f32,
    ids (q, k) int32), descending, first occurrence on ties."""
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    dot = queries @ corpus.T
    scores = -(q2 - 2.0 * dot + sq_norms[None, :])
    vals, ids = topk_first(scores, k)
    return vals, ids.to(torch.int32)


def ref_score_topk_rows(corpus: Tensor, sq_norms: Tensor, payload_v: Tensor,
                        payload_f: Tensor, queries: Tensor, k: int):
    """``ref_score_topk`` plus the winners' scan rows and payload rows,
    gathered by id (the semantic definition of what the kernel carries)."""
    vals, ids = ref_score_topk(corpus, sq_norms, queries, k)
    return vals, ids, corpus[ids], payload_v[ids], payload_f[ids]


def ref_rescore(cand_v: Tensor, cand_f: Tensor, qn: Tensor, fqn: Tensor,
                lam: float) -> Tensor:
    """Combined cosine score per candidate (Alg. 1 line 13).

    cand_v: (b, kp, d); cand_f: (b, kp, m); qn: (b, d); fqn: (b, m). The
    cosine is mul+sum, each row reduced on its own, as in the JAX package.
    """
    def cos(a, b):
        num = torch.sum(a * b, dim=-1)
        den = (torch.linalg.vector_norm(a, dim=-1)
               * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
        return num / den

    s_v = cos(cand_v, qn[:, None, :])
    s_f = cos(cand_f, fqn[:, None, :])
    return lam * s_v + (1.0 - lam) * s_f
