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


def ref_select_topk(scores: Tensor, k: int):
    """The selection path's select alone (``topk_select.select_topk``): per
    row of scores (b, n), the k best by (score desc, column asc); -inf and
    NaN do not compete, slots past the competing entries read (-inf, 0),
    and -0.0 counts as +0.0 but keeps its bits. Returns (vals (b, k) f32,
    ids (b, k) int32)."""
    s = torch.where(torch.isnan(scores), float("-inf"), scores)
    vals, pos = topk_first(s, min(k, s.shape[-1]))
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                              float("-inf"))], dim=-1)
        pos = torch.cat([pos, pos.new_zeros((pos.shape[0], pad))], dim=-1)
    ids = torch.where(torch.isneginf(vals), 0, pos)
    return vals, ids.to(torch.int32)


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


DOT_ROWS = 1 << 18   # rows a chunk of ``dot_rounded``'s fp64 product


def dot_rounded(queries: Tensor, rows: Tensor) -> Tensor:
    """<q, x> for every query (b, d) and row (n, d) of any stored type,
    (b, n) fp32: the dot product taken in fp64 (products of fp32, bf16 and
    int8 values are exact there) and rounded once to fp32, so the value
    does not depend on a library's summation order. An fp32 sum of d
    products of the serving corpus's magnitudes is off by up to a slot's
    whole L2 tolerance (``scripts/scan_accuracy.py --corpus``)."""
    if rows.shape[0] == 0:
        return queries.new_zeros((queries.shape[0], 0))
    qd = queries.to(torch.float64)
    return torch.cat([(qd @ part.to(torch.float64).T).to(torch.float32)
                      for part in rows.split(DOT_ROWS)], dim=1)


def ref_score_topk(corpus: Tensor, sq_norms: Tensor, queries: Tensor, k: int,
                   scales: Optional[Tensor] = None,
                   mask: Optional[Tensor] = None):
    """Exact negative-squared-L2 top-k: (vals (q, k) f32, ids (q, k) int32),
    descending, first occurrence on ties. ``corpus`` is fp32, bf16 or int8
    codes with their per-row ``scales`` (n,); the score is the kernels'
    ``((2 dot) scale - ||x||^2) - ||q||^2`` with the dot product rounded
    once (``dot_rounded``) and each later step an fp32 op: the scale
    multiplies the dot product's output, never the rows. ``mask`` (n,)
    float 0/1 is the filter algebra's candidate mask: rows at <= 0.5 score
    -inf after the score is formed, and slots left -inf read id 0, as the
    kernel's unfilled slots do (the reference leaves those ids to its
    callers, which clamp them)."""
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    s = 2.0 * dot_rounded(queries, corpus)
    if scales is not None:
        s = s * scales
    s = (s - sq_norms[None, :]) - q2
    if mask is not None:
        s = torch.where(mask[None, :] > 0.5, s, float("-inf"))
    vals, ids = topk_first(s, k)
    if mask is not None:
        ids = torch.where(torch.isneginf(vals), 0, ids)
    return vals, ids.to(torch.int32)


def ref_score_topk_rows(corpus: Tensor, sq_norms: Tensor, payload_v: Tensor,
                        payload_f: Tensor, queries: Tensor, k: int,
                        scales: Optional[Tensor] = None):
    """``ref_score_topk`` plus the winners' scan rows, dequantized to fp32
    (``codes * scale`` for int8, the upcast for bf16), and payload rows,
    gathered by id (the semantic definition of what the kernel carries)."""
    vals, ids = ref_score_topk(corpus, sq_norms, queries, k, scales)
    idx = ids.long()
    rows = corpus[idx].to(torch.float32)
    if scales is not None:
        rows = rows * scales[idx][..., None]
    return vals, ids, rows, payload_v[idx], payload_f[idx]


# ---------------------------------------------------------------------------
# The flat scan's split products (csrc/fused_score_topk.cu), emulated for the
# tests only: the kernel runs its dot products on the tensor cores, fp32 rows
# as three TF32 products (3xTF32), bf16 and int8 rows (exact in bf16) against
# the query split into three bf16 terms. The products are summed exactly: the
# tensor cores' own accumulation is not emulated. No serving path calls
# these.
# ---------------------------------------------------------------------------

def tf32_round(x: Tensor) -> Tensor:
    """fp32 to the nearest tf32 (10 mantissa bits), ties away from zero: the
    kernel's ``tf32_rna``, (bits + 0x1000) & ~0x1fff, by masking the low 13
    mantissa bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16_round(x: Tensor) -> Tensor:
    """fp32 to the nearest-even bf16 (8 mantissa bits), back in fp32."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def split_terms(x: Tensor, kind: str) -> list:
    """The kernel's split of fp32 values: ``"tf32x2"`` (hi = tf32(x), lo =
    tf32(x - hi)), ``"bf16x3"`` (three bf16 terms, each of the remainder
    left by the ones before), ``"tf32"`` (one term: a single TF32 product,
    what the split exists to avoid) or ``"bf16"`` (one bf16 term)."""
    if kind in ("tf32", "bf16"):
        return [(tf32_round if kind == "tf32" else bf16_round)(x)]
    rnd, count = ((tf32_round, 2) if kind == "tf32x2" else (bf16_round, 3))
    terms, rest = [], x.to(torch.float32)
    for _ in range(count):
        terms.append(rnd(rest))
        rest = rest - terms[-1]
    return terms


def split_dot(rows: Tensor, queries: Tensor, kind: str) -> Tensor:
    """(b, n) dot products as the kernel's products form them, summed
    exactly (fp64): ``kind`` ``"3xtf32"`` for fp32 rows (x_lo q_hi + x_hi
    q_lo + x_hi q_hi; x_lo q_lo dropped), ``"tf32"`` for one TF32 product,
    ``"bf16x3"`` for rows exact in bf16 (bf16 values, int8 codes) against
    three bf16 query terms, ``"bf16"`` for one bf16 query term. Every
    product of two tf32 or two bf16 values is exact in fp64, so the result
    carries the split's error and not the sum's."""
    q = queries.to(torch.float32)
    x = rows.to(torch.float32)
    if kind == "3xtf32":
        xh, xl = split_terms(x, "tf32x2")
        qh, ql = split_terms(q, "tf32x2")
        pairs = [(ql, xh), (qh, xl), (qh, xh)]
    elif kind == "tf32":
        pairs = [(split_terms(q, "tf32")[0], split_terms(x, "tf32")[0])]
    else:
        pairs = [(t, x) for t in split_terms(q, "bf16x3" if kind == "bf16x3"
                                            else "bf16")]
    return sum(a.double() @ b.double().T for a, b in pairs)


def split_scores(rows: Tensor, sq_norms: Tensor, queries: Tensor, kind: str,
                 scales: Optional[Tensor] = None) -> Tensor:
    """(b, n) scores ``((2 dot) scale - ||x||^2) - ||q||^2`` in fp32 from the
    emulated split dot products (``split_dot``), in the kernel's order."""
    dot = split_dot(rows, queries, kind).to(torch.float32)
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    s = 2.0 * dot
    if scales is not None:
        s = s * scales
    return (s - sq_norms[None, :]) - q2


def ref_rescore(cand_v: Tensor, cand_f: Tensor, qn: Tensor, fqn: Tensor,
                lam: float) -> Tensor:
    """Combined cosine score per candidate (Alg. 1 line 13).

    cand_v: (b, kp, d); cand_f: (b, kp, m); qn: (b, d); fqn: (b, m). All
    inputs are cast up to fp32 first (bf16 candidate tiles included). The
    cosine is mul+sum, each row reduced on its own, as in the JAX package.
    """
    def cos(a, b):
        num = torch.sum(a * b, dim=-1)
        den = (torch.linalg.vector_norm(a, dim=-1)
               * torch.linalg.vector_norm(b, dim=-1) + 1e-8)
        return num / den

    cand_v, cand_f, qn, fqn = (t.to(torch.float32)
                               for t in (cand_v, cand_f, qn, fqn))
    s_v = cos(cand_v, qn[:, None, :])
    s_f = cos(cand_f, fqn[:, None, :])
    return lam * s_v + (1.0 - lam) * s_f


def ref_rescore_topk(cand_v: Tensor, cand_f: Tensor, qn: Tensor, fqn: Tensor,
                     lam: float, cand_ids: Tensor, k: int):
    """The re-rank around ``ref_rescore``: the first-occurrence top-k of the
    combined scores (``topk_first``: score descending, NaN first, -0.0
    equal to +0.0, ties to the smaller position) and ``cand_ids`` (b, kp)
    at those positions, as the reference's ``lax.top_k`` and
    ``take_along_axis`` after its rescore. Returns (scores (b, min(k, kp))
    f32, ids in cand_ids' dtype)."""
    vals, pos = topk_first(ref_rescore(cand_v, cand_f, qn, fqn, lam), k)
    return vals, torch.gather(cand_ids, -1, pos)


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


def list_scores(grouped: Tensor, uniq: Tensor, queries: Tensor,
                scales: Optional[Tensor] = None) -> Tensor:
    """``(2 <x, q>) scale`` of every query (b, d) against every slot of the
    lists ``uniq`` (s,): (b, s, max_list) fp32, the slabs cast up to fp32
    and multiplied as one fp32 matrix product. The list scans sum each
    dot product as an fmaf chain in column order, and on the card this
    product's scores have been theirs bit for bit (``chip_smoke.py`` phases
    3b and 3e), so the IVF plain versions keep fp32 products, B7's too;
    the flat scan's plain version rounds its dot products once instead
    (``dot_rounded``)."""
    u = uniq.long()
    s = 2.0 * torch.einsum("bd,sld->bsl", queries,
                           grouped[u].to(torch.float32))
    if scales is not None:
        s = s * scales[u][None]
    return s


def ref_ivf_score_topk_batch(grouped: Tensor, grouped_sq: Tensor,
                             valid: Tensor, probes: Tensor, queries: Tensor,
                             k: int, scales: Optional[Tensor] = None):
    """Query-major probed scan: probes (b, nprobe) list ids, queries (b, d).
    Candidates are flattened in probe order, so ties go to the earlier probe
    position, then the earlier slot (a list probed twice competes twice).
    ``grouped`` is fp32, bf16 or int8 codes with their per-row ``scales``
    (nlist, max_list): ``(2 <x, q>) scale - ||x||^2``, each score
    ``list_scores``' (the dedup scan's) value. Returns (vals (b, k) f32,
    flat ids (b, k) int32)."""
    max_list = grouped.shape[1]
    pr = probes.long()
    uniq, inv = torch.unique(pr, return_inverse=True)
    s = list_scores(grouped, uniq, queries, scales)       # (b, s, L)
    s = torch.gather(s, 1, inv[:, :, None].expand(-1, -1, max_list))
    s = torch.where(valid[pr] > 0.5, s - grouped_sq[pr], float("-inf"))
    flat = pr[:, :, None] * max_list + torch.arange(max_list,
                                                   device=pr.device)
    return _topk_padded(s.reshape(s.shape[0], -1),
                        flat.reshape(flat.shape[0], -1), k)


def _dedup_scores(grouped: Tensor, grouped_sq: Tensor, valid: Tensor,
                  uniq: Tensor, member: Tensor, queries: Tensor,
                  scales: Optional[Tensor] = None):
    """The dedup scans' (b, s * max_list) masked scores and flat id map."""
    max_list = grouped.shape[1]
    u = uniq.long()
    s = list_scores(grouped, uniq, queries, scales) - grouped_sq[u][None]
    keep = (valid[u] > 0.5)[None, :, :] & (member.T > 0.5)[:, :, None]
    s = torch.where(keep, s, float("-inf"))
    flat = (u[:, None] * max_list
            + torch.arange(max_list, device=u.device)).reshape(-1)
    return s.reshape(s.shape[0], -1), flat


def ref_ivf_score_topk_dedup(grouped: Tensor, grouped_sq: Tensor,
                             valid: Tensor, uniq: Tensor, member: Tensor,
                             queries: Tensor, k: int,
                             scales: Optional[Tensor] = None,
                             mask: Optional[Tensor] = None):
    """Probe-major scan of the unique probed lists: uniq (s,) list ids,
    member (s, b) float 0/1 (query b probed list uniq[s]). Candidates are
    flattened in uniq order, so with an ascending uniq ties go to the
    smaller flat id. ``scales`` as in ``ref_ivf_score_topk_batch``.
    ``mask`` (nlist, max_list) float 0/1 is the filter algebra's candidate
    mask; it multiplies into ``valid`` (exact: both are 0/1), as the
    reference's kernel path does. Returns (vals (b, k) f32, flat ids (b, k)
    int32)."""
    if mask is not None:
        valid = valid * mask
    s, flat = _dedup_scores(grouped, grouped_sq, valid, uniq, member,
                            queries, scales)
    return _topk_padded(s, flat, k)


def ref_ivf_score_topk_dedup_rows(grouped: Tensor, grouped_sq: Tensor,
                                  valid: Tensor, uniq: Tensor,
                                  member: Tensor, queries: Tensor,
                                  payload_v: Tensor, payload_f: Tensor,
                                  k: int, scales: Optional[Tensor] = None):
    """``ref_ivf_score_topk_dedup`` plus the winners' rows of the grouped
    payloads (nlist, max_list, dv) / (nlist, max_list, m), gathered by flat
    id; dead slots carry zero rows."""
    vals, ids = ref_ivf_score_topk_dedup(grouped, grouped_sq, valid, uniq,
                                         member, queries, k, scales)
    dead = torch.isneginf(vals)[..., None]
    idx = ids.long()
    rows = [torch.where(dead, 0.0, p.reshape(-1, p.shape[-1])[idx])
            for p in (payload_v, payload_f)]
    return (vals, ids, *rows)


def ref_ivf_masked_slots(valid: Tensor, mask: Tensor, uniq: Tensor,
                         member: Tensor):
    """B5 ``mask=``'s operands (``ivf_score.masked_slots``'s kernel): (the
    eligible slots' flat ids, ascending int32: valid * mask > 0.5 in a list
    with a member query; the lists' member bits (nlist, ceil(b / 64))
    int64, query j at bit j % 64 of word j // 64, OR-ed over the list's
    sources in ``uniq``)."""
    nlist, L = valid.shape
    s, b = member.shape
    words = -(-b // 64)
    hits = torch.zeros((nlist, words * 64), dtype=torch.int64,
                       device=valid.device)
    hits[:, :b].index_add_(0, uniq.long(), (member > 0.5).to(torch.int64))
    weight = torch.ones(64, dtype=torch.int64, device=valid.device) << \
        torch.arange(64, device=valid.device)
    # distinct powers of two: the sum is their OR (bit 63 is -2**63)
    lbits = ((hits > 0).to(torch.int64).view(nlist, words, 64)
             * weight).sum(dim=-1)
    keep = ((valid * mask) > 0.5) & (lbits != 0).any(dim=1)[:, None]
    return torch.nonzero(keep.reshape(-1)).flatten().to(torch.int32), lbits


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


# ---------------------------------------------------------------------------
# PQ (B8, B9, B10): the LUT cross term and the ADC gather-accumulate. Codes
# may be uint8 (a uint8 index tensor is a boolean mask in PyTorch), so every
# gather by codes widens them first. Sums run over m = 0..M-1 in order, as
# the Pallas kernel adds one LUT value per subspace (its one-hot matmuls), so
# they are a left-to-right fp32 sum.
# ---------------------------------------------------------------------------

def ref_pq_lut_qdot(queries_sub: Tensor, codebooks: Tensor) -> Tensor:
    """PQ LUT q.codebook cross term: (q, M, dsub) x (M, ksub, dsub) ->
    (q, M, ksub), out[i, m, j] = <queries_sub[i, m], codebooks[m, j]>."""
    return torch.einsum("qmd,mkd->qmk", queries_sub, codebooks)


def in_order_sum(x: Tensor) -> Tensor:
    """The fp32 sum over the last axis in column order: the first entry,
    then each next one added (the kernels' order, which no reduction
    promises)."""
    acc = x[..., 0]
    for t in range(1, x.shape[-1]):
        acc = acc + x[..., t]
    return acc


def ref_pq_scan_luts(queries: Tensor, codebooks: Tensor,
                     coarse_centers: Tensor, coarse_dot: Tensor,
                     cb_sq: Tensor) -> Tensor:
    """The PQ scan LUT (``index.pq.scan_luts``): queries (b, d),
    codebooks (M, ksub, dsub), coarse_centers (ncoarse, d), the build's
    coarse_dot (ncoarse, M, ksub) and cb_sq (M, ksub) -> (b, M, ncoarse *
    ksub) fp32, the reference's expansion with the coarse axis inside the
    subspace axis:

        lut[i, m, c * ksub + j] = (qres_sq[i, c, m]
                                   - 2 (q_dot[i, m, j] - coarse_dot[c, m, j]))
                                  + cb_sq[m, j]

    q_dot = <q_m, cb[m, j]> and qres_sq = ||(q - centre_c)_m||^2, each a sum
    over the dsub columns in column order of products rounded to fp32
    (``in_order_sum``); every step is one rounded fp32 op, in this order.
    The kernel follows it op for op, so it is this function's bits."""
    b, d = queries.shape
    m, ksub, dsub = codebooks.shape
    c = coarse_centers.shape[0]
    q_dot = in_order_sum(queries.reshape(b, m, 1, dsub) * codebooks[None])
    res = (queries.reshape(b, 1, m, dsub)
           - coarse_centers.reshape(1, c, m, dsub))
    qres_sq = in_order_sum(res * res)                     # (b, C, M)
    luts = ((qres_sq.transpose(1, 2)[..., None]
             - 2.0 * (q_dot[:, :, None, :]
                      - coarse_dot.transpose(0, 1)[None]))
            + cb_sq[None, :, None, :])                    # (b, M, C, ksub)
    return luts.reshape(b, m, c * ksub)


def ref_pq_score_batch(codes: Tensor, luts: Tensor) -> Tensor:
    """Multi-query ADC: codes (n, M) uint8 or int32, luts (q, M, K) ->
    squared distances (q, n), d2[i, r] = sum_m luts[i, m, codes[r, m]].

    One (q, n) gather per subspace, added in subspace order: a one-shot
    (q, n, M) gather would hold 2 GB at q=64, n=1M."""
    idx = codes.long()
    total = luts[:, 0, :][:, idx[:, 0]]
    for m in range(1, codes.shape[1]):
        total = total + luts[:, m, :][:, idx[:, m]]
    return total


def ref_pq_lut_query_major(luts: Tensor) -> Tensor:
    """The B9 kernel's LUT relayout: (b, M, K) -> (M, K, bp), queries
    innermost, with bp = b padded to the kernel's load width (min(4, the
    next power of two of b) floats) and the pad columns zero. At b = 1 it
    is the same memory order as the input."""
    b, m, k = luts.shape
    vec = min(4, 1 << (b - 1).bit_length())
    bp = -(-b // vec) * vec
    out = luts.new_zeros((m, k, bp))
    out[:, :, :b] = luts.permute(1, 2, 0)
    return out


def ref_pq_score(codes: Tensor, lut: Tensor) -> Tensor:
    """Single-LUT ADC: codes (n, M), lut (M, K) -> squared distances (n,);
    ``ref_pq_score_batch`` at one LUT."""
    return ref_pq_score_batch(codes, lut[None])[0]


def topk_first_packed(x: Tensor, k: int):
    """``topk_first`` along the last axis of a float32 (b, n) tensor with
    n < 2**32, by ``torch.topk`` on one int64 key per entry: the value's
    order-preserving bits above, ``2**32 - 1 - index`` below, so equal
    values go to the smaller index and the result is exact, with no sort of
    the whole row. The bits order -0.0 below +0.0, as ``lax.top_k`` does
    (``topk_first`` counts them equal). Returns (values, int64
    positions)."""
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    low = (1 << 32) - 1 - torch.arange(x.shape[-1], device=x.device)
    keys = (ordered << 32) | low
    top = torch.topk(keys, k, dim=-1).values
    pos = (1 << 32) - 1 - (top & 0xFFFFFFFF)
    return torch.gather(x, -1, pos), pos


def ref_pq_score_topk(codes: Tensor, luts: Tensor, k: int):
    """The PQ serving path's scan + selection: the first-occurrence top-k of
    the negated ADC distances, ``topk_first_packed(-ref_pq_score_batch(codes,
    luts), k)``, as ``lax.top_k(-pq_score_batch(...))`` in the reference:
    -0.0 ranks below +0.0, equal scores go to the smaller row. codes (n, M)
    combined codes in row order. Returns (vals (q, k) f32, ids (q, k)
    int32)."""
    vals, pos = topk_first_packed(-ref_pq_score_batch(codes, luts), k)
    return vals, pos.to(torch.int32)
