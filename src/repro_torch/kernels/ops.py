"""The serving path's kernel dispatch, decided by the device of the inputs.

A tensor on a CUDA device goes to the hand-written kernel; a tensor on the
CPU goes to the plain PyTorch version in ``ref``. There is no switch and no
fallback: a CUDA call that cannot build or launch its kernel raises. The
plain versions stay importable from ``ref`` for comparing on the card.

The kernels take unpadded shapes and mask the ragged corpus and query edges
themselves, so there is no ``*_padded`` layer as in ``repro.kernels.ops``:
padding the corpus in eager PyTorch would copy it on every batch.

The scans take the corpus or grouped slab as stored (float32, bfloat16 or
int8 codes) and an optional ``scales=`` operand, the int8 rung's per-row
dequantization scale, which multiplies each dot product's output. A CUDA
tensor of another dtype raises in the kernel's wrapper; it is never cast.

On the meta device (a cost trace, ``launch.cost_analysis``) an entry
records its kernel's own work from the shapes and returns empty outputs:
the plain version would materialise what no kernel writes (``score_topk``'s
(q, n) score matrix). ``score_topk`` and ``ivf_score_topk_batch`` are the
ones the dry-run's cells reach; every other entry raises on meta. In a
cost trace on CPU tensors those two record the same work and run the
plain version uncounted (``sharding.quiet_ops``), so the trace counts what
the meta trace of the same step counts. On a CUDA tensor they call the
kernel and nothing else.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import fcvi_transform as _transform
from repro_torch.kernels import fused_score_topk as _scan
from repro_torch.kernels import ivf_score as _ivf
from repro_torch.kernels import pq_lut as _pq
from repro_torch.kernels import rescore as _rescore

Tensor = torch.Tensor


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _traced(name: str, x: Tensor, run, shapes, cost):
    """A kernel entry on a CPU or meta tensor: ``run()``, the plain
    version, outside a cost trace (on meta it raises there). Inside one it
    runs uncounted (on meta, empty outputs of ``shapes``, (shape, dtype)
    pairs, stand for it), ``cost()``, the kernel's own (flops, bytes),
    is recorded as one call of kernel ``name``, and the outputs are marked
    as the values of the current ``sharding.scope``."""
    from repro_torch.distributed.sharding import current_scope, mark, \
        quiet_ops
    from repro_torch.launch.cost_analysis import active_mode
    mode = active_mode()
    if mode is None:
        if x.is_meta:
            raise RuntimeError(f"kernel {name} reached on the meta device "
                               "outside a cost trace")
        return run()
    with quiet_ops():
        out = (tuple(torch.empty(sh, dtype=dt, device="meta")
                     for sh, dt in shapes) if x.is_meta else run())
    mode.record_kernel(name, *cost())
    held = current_scope()
    return out if held is None else tuple(mark(t, held) for t in out)


def _no_meta(name: str, x: Tensor) -> None:
    if x.is_meta:
        raise NotImplementedError(f"kernel {name} has no cost on the meta "
                                  "device: no dry-run cell reaches it")


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
    _no_meta("fused_transform", v)
    return ref.ref_fused_transform(v, f, proj, alpha, mean_v, std_v,
                                   mean_f, std_f)


def score_topk(corpus: Tensor, sq_norms: Tensor, queries: Tensor, k: int,
               *, scales: Optional[Tensor] = None,
               mask: Optional[Tensor] = None):
    """Negative squared-L2 top-k: (vals (q, k) f32, ids (q, k) int32),
    descending, ties to the smaller id. ``mask`` (n,) float 0/1 routes to
    the filtered variants: rows at <= 0.5 score -inf inside the scan, and
    slots no eligible row fills read (-inf, 0)."""
    if corpus.is_cuda:
        return _scan.score_topk(corpus, sq_norms, queries, k, scales, mask)
    nq = queries.shape[0]

    def cost():
        # B2's work: 2 q n d multiply-adds; the rows, norms, scales and
        # mask read once, the queries read, the (q, k) values and ids
        # written
        return (2.0 * nq * corpus.shape[0] * corpus.shape[1],
                _bytes(corpus, sq_norms, queries, scales, mask) + nq * k * 8)

    return _traced(_scan.NAME, corpus,
                   lambda: ref.ref_score_topk(corpus, sq_norms, queries, k,
                                              scales, mask),
                   (((nq, k), torch.float32), ((nq, k), torch.int32)), cost)


def score_topk_rows(corpus: Tensor, sq_norms: Tensor, payload_v: Tensor,
                    payload_f: Tensor, queries: Tensor, k: int, *,
                    scales: Optional[Tensor] = None):
    """``score_topk`` plus the winners' corpus rows dequantized to fp32
    (q, k, d) and payload rows (q, k, dv) / (q, k, m)."""
    if corpus.is_cuda:
        return _scan.score_topk_rows(corpus, sq_norms, payload_v, payload_f,
                                     queries, k, scales)
    _no_meta("score_topk_rows", corpus)
    return ref.ref_score_topk_rows(corpus, sq_norms, payload_v, payload_f,
                                   queries, k, scales)


def rescore(cand_v: Tensor, cand_f: Tensor, qn: Tensor, fqn: Tensor,
            lam: float) -> Tensor:
    """lam * cos(v, q) + (1 - lam) * cos(f, F_q) per candidate: (b, kp).
    bf16 candidate tiles are cast up to fp32 first, on either device."""
    if cand_v.is_cuda:
        return _rescore.rescore(cand_v, cand_f, qn, fqn, lam)
    _no_meta("rescore", cand_v)
    return ref.ref_rescore(cand_v, cand_f, qn, fqn, lam)


def rescore_topk(cand_v: Tensor, cand_f: Tensor, qn: Tensor, fqn: Tensor,
                 lam: float, cand_ids: Tensor, k: int):
    """The re-rank: ``rescore``'s scores, their first-occurrence top-k
    (``ref.topk_first``'s order) and ``cand_ids`` (b, kp) at those
    positions. Returns (scores (b, min(k, kp)) f32, ids in cand_ids'
    dtype); one launch on the card."""
    if cand_v.is_cuda:
        return _rescore.rescore_topk(cand_v, cand_f, qn, fqn, lam, cand_ids,
                                     k)
    _no_meta("rescore_topk", cand_v)
    return ref.ref_rescore_topk(cand_v, cand_f, qn, fqn, lam, cand_ids, k)


# IVF scans over the grouped (nlist, max_list, d) slabs: scores 2<x,q> -
# ||x||^2 (the caller adds -||q||^2 back), flat slot ids, dead slots (-inf, 0)

def ivf_score_topk_batch(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                         probes: Tensor, queries: Tensor, k: int, *,
                         scales: Optional[Tensor] = None):
    """Query-major probed scan: probes (b, nprobe) int32, queries (b, d).
    Ties go to the earlier probe position, then the earlier slot.

    B7's work in a cost trace: 2 b nprobe max_list d multiply-adds (every
    probed slot of every query); each list the batch's probes can reach
    (min(nlist, b nprobe) of them) read once with its norms, ``valid``
    and ``scales`` rows, the queries and probes read, the (b, k) values
    and ids written. The kernel reads a list once per probe of it where
    the cache does not keep it: the bound is the least it can move."""
    if grouped.is_cuda:
        return _ivf.ivf_score_topk_batch(grouped, grouped_sq, valid, probes,
                                         queries, k, scales)
    b, nprobe = probes.shape

    def cost():
        nlist, max_list, d = grouped.shape
        row = _bytes(grouped[0], grouped_sq[0], valid[0],
                     None if scales is None else scales[0])
        return (2.0 * b * nprobe * max_list * d,
                min(nlist, b * nprobe) * row + _bytes(probes, queries)
                + b * k * 8)

    return _traced(_ivf.NAME_BATCH, grouped,
                   lambda: ref.ref_ivf_score_topk_batch(
                       grouped, grouped_sq, valid, probes, queries, k,
                       scales),
                   (((b, k), torch.float32), ((b, k), torch.int32)), cost)


def ivf_score_topk(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                   probes: Tensor, query: Tensor, k: int, *,
                   scales: Optional[Tensor] = None):
    """One query: probes (nprobe,) int32, query (d,) -> (vals (k,), ids
    (k,)); ``ivf_score_topk_batch`` at batch 1."""
    vals, ids = ivf_score_topk_batch(grouped, grouped_sq, valid,
                                     probes[None, :], query[None, :], k,
                                     scales=scales)
    return vals[0], ids[0]


def ivf_score_topk_dedup(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                         uniq: Tensor, member: Tensor, queries: Tensor,
                         k: int, *, scales: Optional[Tensor] = None,
                         mask: Optional[Tensor] = None):
    """Probe-major scan of the batch's unique probed lists: uniq (s,) int32,
    member (s, b) float 0/1 (see ``dedup_probes``). Ties go to the smaller
    flat id when uniq ascends. ``mask`` (nlist, max_list) float 0/1 is the
    filter algebra's candidate mask, multiplied into ``valid``."""
    if grouped.is_cuda:
        return _ivf.ivf_score_topk_dedup(grouped, grouped_sq, valid, uniq,
                                         member, queries, k, scales, mask)
    _no_meta("ivf_score_topk_dedup", grouped)
    return ref.ref_ivf_score_topk_dedup(grouped, grouped_sq, valid, uniq,
                                        member, queries, k, scales, mask)


def ivf_score_topk_dedup_rows(grouped: Tensor, grouped_sq: Tensor,
                              valid: Tensor, uniq: Tensor, member: Tensor,
                              queries: Tensor, payload_v: Tensor,
                              payload_f: Tensor, k: int, *,
                              scales: Optional[Tensor] = None):
    """``ivf_score_topk_dedup`` plus the winners' grouped payload rows
    (b, k, dv) / (b, k, m); dead slots carry zero rows."""
    if grouped.is_cuda:
        return _ivf.ivf_score_topk_dedup_rows(grouped, grouped_sq, valid,
                                              uniq, member, queries,
                                              payload_v, payload_f, k, scales)
    _no_meta("ivf_score_topk_dedup_rows", grouped)
    return ref.ref_ivf_score_topk_dedup_rows(grouped, grouped_sq, valid, uniq,
                                             member, queries, payload_v,
                                             payload_f, k, scales)


def dedup_probes(probes: Tensor, nlist: int):
    """(uniq (s,) int32 ascending, member (s, b) float 0/1) from a (b,
    nprobe) probe matrix. A plain torch op on every device: the reference
    computes it in jnp outside its kernels."""
    return ref.dedup_probes(probes, nlist)


# PQ ADC (codes uint8 or int32 in [0, K); sums left to right over m)

def pq_lut_qdot(queries_sub: Tensor, codebooks: Tensor) -> Tensor:
    """The q . codebook cross term of PQ LUT construction: queries_sub
    (q, M, dsub) x codebooks (M, ksub, dsub) -> (q, M, ksub)."""
    if queries_sub.is_cuda:
        return _pq.pq_lut_qdot(queries_sub, codebooks)
    _no_meta("pq_lut_qdot", queries_sub)
    return ref.ref_pq_lut_qdot(queries_sub, codebooks)


def pq_scan_luts(queries: Tensor, codebooks: Tensor, coarse_centers: Tensor,
                 coarse_dot: Tensor, cb_sq: Tensor) -> Tensor:
    """The PQ scan LUT: queries (q, d) -> (q, M, ncoarse * ksub) squared
    subspace distances to every (coarse id, codeword), the coarse axis
    inside the subspace axis (``index.pq.scan_luts``); one launch on the
    card."""
    if queries.is_cuda:
        return _pq.pq_scan_luts(queries, codebooks, coarse_centers,
                                coarse_dot, cb_sq)
    _no_meta("pq_scan_luts", queries)
    return ref.ref_pq_scan_luts(queries, codebooks, coarse_centers,
                                coarse_dot, cb_sq)


def pq_score_batch(codes: Tensor, luts: Tensor) -> Tensor:
    """Multi-query ADC: codes (n, M), luts (q, M, K) -> squared distances
    (q, n)."""
    if codes.is_cuda:
        return _pq.pq_score_batch(codes, luts)
    _no_meta("pq_score_batch", codes)
    return ref.ref_pq_score_batch(codes, luts)


def pq_score_topk(codes: Tensor, luts: Tensor, k: int, grouped):
    """The PQ serving path's fused ADC scan + first-occurrence top-k of the
    negated distances: (vals (q, k) f32 = -d2, ids (q, k) int32 rows),
    ranked as ``lax.top_k`` ranks them. codes (n, M) are the combined codes
    in row order, which the plain version reads; ``grouped`` is the index's
    coarse-grouped layout (codes, row ids, offsets, offsets on the host;
    ``index.pq.PQIndex.grouped``), which the kernel reads."""
    if codes.is_cuda:
        return _pq.pq_score_topk(*grouped, luts, k)
    _no_meta("pq_score_topk", codes)
    return ref.ref_pq_score_topk(codes, luts, k)


def pq_score(codes: Tensor, lut: Tensor) -> Tensor:
    """Single-LUT ADC: codes (n, M), lut (M, K) -> squared distances (n,)."""
    if codes.is_cuda:
        return _pq.pq_score(codes, lut)
    _no_meta("pq_score", codes)
    return ref.ref_pq_score(codes, lut)
