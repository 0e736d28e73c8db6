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


# ---------------------------------------------------------------------------
# IVF (B5, B6, B7): the kernels' score convention, 2 <x, q> - ||x||^2, with
# the ||q||^2 constant left to the caller; ids are flat slot ids
# list * max_list + slot into grouped.reshape(-1, d); dead slots read
# (-inf, id 0). ``valid`` and ``member`` are float 0/1, kept where > 0.5.
# ---------------------------------------------------------------------------

def _topk_padded(scores: Tensor, flat_ids: Tensor, k: int):
    """First-occurrence top-k of scores (b, c) over the candidate axis, with
    ids from flat_ids (b, c) or (c,); slots beyond c, and -inf slots, read
    (-inf, id 0), as the kernels' unfilled slots do."""
    vals, pos = topk_first(scores, k)
    ids = (flat_ids[pos] if flat_ids.dim() == 1
           else torch.gather(flat_ids, -1, pos))
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                              float("-inf"))], dim=-1)
        ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], dim=-1)
    ids = torch.where(torch.isneginf(vals), torch.zeros_like(ids), ids)
    return vals, ids.to(torch.int32)


def ref_ivf_score_topk_batch(grouped: Tensor, grouped_sq: Tensor,
                             valid: Tensor, probes: Tensor, queries: Tensor,
                             k: int):
    """Query-major probed scan: probes (b, nprobe) list ids, queries (b, d).
    Candidates are flattened in probe order, so ties go to the earlier probe
    position, then the earlier slot (a list probed twice competes twice).
    Returns (vals (b, k) f32, flat ids (b, k) int32)."""
    max_list = grouped.shape[1]
    pr = probes.long()
    slabs = grouped[pr]                                # (b, nprobe, L, d)
    s = 2.0 * torch.einsum("bpld,bd->bpl", slabs, queries) - grouped_sq[pr]
    s = torch.where(valid[pr] > 0.5, s, float("-inf"))
    flat = pr[:, :, None] * max_list + torch.arange(max_list,
                                                   device=pr.device)
    return _topk_padded(s.reshape(s.shape[0], -1),
                        flat.reshape(flat.shape[0], -1), k)


def _dedup_scores(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                  uniq: Tensor, member: Tensor, queries: Tensor):
    """The dedup scans' (b, s * max_list) masked scores and flat id map."""
    max_list = grouped.shape[1]
    u = uniq.long()
    s = (2.0 * torch.einsum("bd,sld->bsl", queries, grouped[u])
         - grouped_sq[u][None])
    keep = (valid[u] > 0.5)[None, :, :] & (member.T > 0.5)[:, :, None]
    s = torch.where(keep, s, float("-inf"))
    flat = (u[:, None] * max_list
            + torch.arange(max_list, device=u.device)).reshape(-1)
    return s.reshape(s.shape[0], -1), flat


def ref_ivf_score_topk_dedup(grouped: Tensor, grouped_sq: Tensor,
                             valid: Tensor, uniq: Tensor, member: Tensor,
                             queries: Tensor, k: int):
    """Probe-major scan of the unique probed lists: uniq (s,) list ids,
    member (s, b) float 0/1 (query b probed list uniq[s]). Candidates are
    flattened in uniq order, so with an ascending uniq ties go to the
    smaller flat id. Returns (vals (b, k) f32, flat ids (b, k) int32)."""
    s, flat = _dedup_scores(grouped, grouped_sq, valid, uniq, member,
                            queries)
    return _topk_padded(s, flat, k)


def ref_ivf_score_topk_dedup_rows(grouped: Tensor, grouped_sq: Tensor,
                                  valid: Tensor, uniq: Tensor,
                                  member: Tensor, queries: Tensor,
                                  payload_v: Tensor, payload_f: Tensor,
                                  k: int):
    """``ref_ivf_score_topk_dedup`` plus the winners' rows of the grouped
    payloads (nlist, max_list, dv) / (nlist, max_list, m), gathered by flat
    id; dead slots carry zero rows."""
    vals, ids = ref_ivf_score_topk_dedup(grouped, grouped_sq, valid, uniq,
                                         member, queries, k)
    dead = torch.isneginf(vals)[..., None]
    idx = ids.long()
    rows = [torch.where(dead, 0.0, p.reshape(-1, p.shape[-1])[idx])
            for p in (payload_v, payload_f)]
    return (vals, ids, *rows)


def dedup_probes(probes: Tensor, nlist: int):
    """Compact a (b, nprobe) probe matrix into (uniq, member) for the dedup
    scan: uniq (s,) int32 unique list ids in ascending order, s = min(nlist,
    b * nprobe), tail slots 0 with an all-zero member column; member (s, b)
    float 0/1, 1 iff query b probed list uniq[s]. Static shapes and no
    device-to-host sync, as ``repro.kernels.ivf_score.dedup_probes``; a
    plain torch op on every device (the reference has no kernel for it)."""
    b, nprobe = probes.shape
    slots = min(nlist, b * nprobe)
    flat, order = torch.sort(probes.reshape(-1).to(torch.int32))
    is_new = torch.ones_like(flat, dtype=torch.bool)
    is_new[1:] = flat[1:] != flat[:-1]
    pos = torch.cumsum(is_new, 0) - 1               # slot of each element
    uniq = torch.zeros((slots,), dtype=torch.int32, device=probes.device)
    uniq.scatter_(0, pos, flat)     # equal elements write the same value
    member = torch.zeros((slots, b), dtype=torch.float32,
                         device=probes.device)
    member[pos, order // nprobe] = 1.0              # slot x probing query
    return uniq, member
