"""The serving path's kernel dispatch, decided by the device of the inputs.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the plain PyTorch version in ``ref``. There is no switch and no
fallback: a CUDA call that cannot build or launch its kernel raises. The
plain versions stay importable from ``ref`` for comparing on the card.

The kernels take unpadded shapes and mask the ragged corpus and query edges
themselves, so there is no ``*_padded`` layer as in ``repro.kernels.ops``:
padding the corpus in eager PyTorch would copy it on every batch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import fcvi_transform as _transform
from repro_torch.kernels import fused_score_topk as _scan
from repro_torch.kernels import ivf_score as _ivf
from repro_torch.kernels import rescore as _rescore

Tensor = torch.Tensor


def fused_transform(v: Tensor, f: Tensor, proj: Tensor, alpha: float,
                    mean_v: Optional[Tensor] = None,
                    std_v: Optional[Tensor] = None,
                    mean_f: Optional[Tensor] = None,
                    std_f: Optional[Tensor] = None) -> Tensor:
    """((v - mu_v)/sd_v) - alpha * ((f - mu_f)/sd_f) @ proj over (n, d) /
    (n, m) rows; a normalizer pair left as None is the identity."""
    if v.is_cuda:
        return _transform.fused_transform(v, f, proj, alpha, mean_v, std_v,
                                          mean_f, std_f)
    return ref.ref_fused_transform(v, f, proj, alpha, mean_v, std_v,
                                   mean_f, std_f)


def score_topk(corpus: Tensor, sq_norms: Tensor, queries: Tensor, k: int):
    """Negative squared-L2 top-k: (vals (q, k) f32, ids (q, k) int32),
    descending, ties to the smaller id."""
    if corpus.is_cuda:
        return _scan.score_topk(corpus, sq_norms, queries, k)
    return ref.ref_score_topk(corpus, sq_norms, queries, k)


def score_topk_rows(corpus: Tensor, sq_norms: Tensor, payload_v: Tensor,
                    payload_f: Tensor, queries: Tensor, k: int):
    """``score_topk`` plus the winners' corpus rows (q, k, d) and payload
    rows (q, k, dv) / (q, k, m)."""
    if corpus.is_cuda:
        return _scan.score_topk_rows(corpus, sq_norms, payload_v, payload_f,
                                     queries, k)
    return ref.ref_score_topk_rows(corpus, sq_norms, payload_v, payload_f,
                                   queries, k)


def rescore(cand_v: Tensor, cand_f: Tensor, qn: Tensor, fqn: Tensor,
            lam: float) -> Tensor:
    """lam * cos(v, q) + (1 - lam) * cos(f, F_q) per candidate: (b, kp)."""
    if cand_v.is_cuda:
        return _rescore.rescore(cand_v, cand_f, qn, fqn, lam)
    return ref.ref_rescore(cand_v, cand_f, qn, fqn, lam)


# IVF scans over the grouped (nlist, max_list, d) slabs: scores 2<x,q> -
# ||x||^2 (the caller adds -||q||^2 back), flat slot ids, dead slots (-inf, 0)

def ivf_score_topk_batch(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                         probes: Tensor, queries: Tensor, k: int):
    """Query-major probed scan: probes (b, nprobe) int32, queries (b, d).
    Ties go to the earlier probe position, then the earlier slot."""
    if grouped.is_cuda:
        return _ivf.ivf_score_topk_batch(grouped, grouped_sq, valid, probes,
                                         queries, k)
    return ref.ref_ivf_score_topk_batch(grouped, grouped_sq, valid, probes,
                                        queries, k)


def ivf_score_topk(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                   probes: Tensor, query: Tensor, k: int):
    """One query: probes (nprobe,) int32, query (d,) -> (vals (k,), ids
    (k,)); ``ivf_score_topk_batch`` at batch 1."""
    vals, ids = ivf_score_topk_batch(grouped, grouped_sq, valid,
                                     probes[None, :], query[None, :], k)
    return vals[0], ids[0]


def ivf_score_topk_dedup(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                         uniq: Tensor, member: Tensor, queries: Tensor,
                         k: int):
    """Probe-major scan of the batch's unique probed lists: uniq (s,) int32,
    member (s, b) float 0/1 (see ``dedup_probes``). Ties go to the smaller
    flat id when uniq ascends."""
    if grouped.is_cuda:
        return _ivf.ivf_score_topk_dedup(grouped, grouped_sq, valid, uniq,
                                         member, queries, k)
    return ref.ref_ivf_score_topk_dedup(grouped, grouped_sq, valid, uniq,
                                        member, queries, k)


def ivf_score_topk_dedup_rows(grouped: Tensor, grouped_sq: Tensor,
                              valid: Tensor, uniq: Tensor, member: Tensor,
                              queries: Tensor, payload_v: Tensor,
                              payload_f: Tensor, k: int):
    """``ivf_score_topk_dedup`` plus the winners' grouped payload rows
    (b, k, dv) / (b, k, m); dead slots carry zero rows."""
    if grouped.is_cuda:
        return _ivf.ivf_score_topk_dedup_rows(grouped, grouped_sq, valid,
                                              uniq, member, queries,
                                              payload_v, payload_f, k)
    return ref.ref_ivf_score_topk_dedup_rows(grouped, grouped_sq, valid, uniq,
                                             member, queries, payload_v,
                                             payload_f, k)


def dedup_probes(probes: Tensor, nlist: int):
    """(uniq (s,) int32 ascending, member (s, b) float 0/1) from a (b,
    nprobe) probe matrix. A plain torch op on every device: the reference
    computes it in jnp outside its kernels."""
    return ref.dedup_probes(probes, nlist)
