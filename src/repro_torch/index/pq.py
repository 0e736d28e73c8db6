"""Residual product quantization (IVF-ADC) index with ADC scoring, in PyTorch.

A coarse k-means quantizer captures the between-cluster structure of the
corpus, and PQ encodes only the residual (x - coarse center): each row is
one coarse id plus M codes, one per subspace of d/M columns. A query builds
an (ncoarse, M, ksub) table of subspace distances and scores each row by
gathering and summing its M entries, a sweep of M codes per row instead of
d floats.

Search mirrors the JAX package's kernel path (``use_pallas=True``): the
LUTs are ``ops.pq_scan_luts`` (B8's cross term with the residual norms and
the build's terms, one launch on the card), the per-row coarse indirection is
folded into a combined (coarse, code) index over the flattened (M, ncoarse *
ksub) LUT, and a first-occurrence top-k of the negative distances picks the
candidates. The reference runs that as ``lax.top_k(-pq_score_batch(...))``;
here it is one call, ``ops.pq_score_topk``: on the card a fused scan over
the rows grouped by coarse id, each group reading its own (M, ksub) slice
of the LUT, with no (q, n) distance matrix; on the CPU the plain
``pq_score_batch`` + packed-key top-k over the combined codes. Both layouts
are built once with the index: the combined codes, ``coarse_id * ksub +
code`` as (n, M) int32 (the reference rebuilds them on every search), and
the grouped layout (``PQIndex.grouped``). Mirrors ``repro.index.pq``;
``PQIndex.slab`` is the layout sharded serving splits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.clustering import Seed, kmeans, make_generator
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PQIndex:
    codebooks: Tensor       # (M, ksub, dsub) residual codebooks
    codes: Tensor           # (n, M) in [0, ksub): uint8 when ksub <= 256
    coarse_centers: Tensor  # (ncoarse, d)
    coarse_ids: Tensor      # (n,) int32 in [0, ncoarse)
    cb_sq: Tensor           # (M, ksub) ||codebook||^2
    coarse_dot: Tensor      # (ncoarse, M, ksub) center_m . codebook
    ccodes: Tensor          # (n, M) int32 combined coarse_id * ksub + code
    # the rows stably grouped by coarse id, as the fused scan reads them:
    # (codes (n, M) in that order, uint8 or int32; their row ids (n,) int32;
    # the group offsets (ncoarse + 1,) int32; the offsets on the host)
    grouped: tuple

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    @property
    def n_subspaces(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]

    @property
    def ncoarse(self) -> int:
        return self.coarse_centers.shape[0]

    def search(self, queries: Tensor, k: int):
        """SearchBackend entry point."""
        return search(self, queries, k)

    def slab(self):
        """The serving slab (``index.slab.PQSlab``) to shard."""
        from repro_torch.index.slab import PQSlab
        return PQSlab(self.codebooks, self.codes, self.coarse_centers,
                      self.coarse_ids, self.cb_sq, self.coarse_dot)


def from_arrays(codebooks: Tensor, codes: Tensor, coarse_centers: Tensor,
                coarse_ids: Tensor) -> PQIndex:
    """A PQIndex from its four source arrays (the ``index_state`` keys);
    the build-time LUT terms and the combined codes are derived here. The
    codes keep their dtype."""
    codebooks = codebooks.to(torch.float32).contiguous()
    coarse_centers = coarse_centers.to(torch.float32).contiguous()
    coarse_ids = coarse_ids.to(torch.int32).contiguous()
    codes = codes.contiguous()
    m, ksub, dsub = codebooks.shape
    centers_sub = coarse_centers.reshape(-1, m, dsub)
    ccodes = coarse_ids[:, None] * ksub + codes.to(torch.int32)
    return PQIndex(
        codebooks=codebooks, codes=codes, coarse_centers=coarse_centers,
        coarse_ids=coarse_ids,
        cb_sq=torch.sum(codebooks * codebooks, dim=-1),
        coarse_dot=torch.einsum("cmd,mkd->cmk", centers_sub,
                                codebooks).contiguous(),
        ccodes=ccodes.contiguous(),
        grouped=grouped_layout(codes, coarse_ids, coarse_centers.shape[0]))


def grouped_layout(codes: Tensor, coarse_ids: Tensor, ncoarse: int) -> tuple:
    """The rows in a stable order by coarse id: (codes (n, M) in that order,
    uint8 kept, any other dtype as int32; the original row ids (n,) int32;
    the group offsets (ncoarse + 1,) int32, group c holding rows
    offsets[c]:offsets[c + 1]; the offsets as a host tuple, so planning a
    scan needs no device sync)."""
    order = torch.argsort(coarse_ids, stable=True)
    gcodes = codes[order]
    if gcodes.dtype not in (torch.uint8, torch.int32):
        gcodes = gcodes.to(torch.int32)
    counts = torch.bincount(coarse_ids.long(), minlength=ncoarse)
    offsets = torch.zeros((ncoarse + 1,), dtype=torch.int32,
                          device=codes.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return (gcodes.contiguous(), order.to(torch.int32).contiguous(), offsets,
            tuple(offsets.cpu().tolist()))


def build(vectors: Tensor, m_subspaces: int = 8, ksub: int = 256,
          generator: Seed = None, iters: int = 15,
          ncoarse: int = 32) -> PQIndex:
    """Train the coarse quantizer, then one codebook per subspace on the
    residuals (k-means, ``iters`` Lloyd steps each), on the vectors'
    device. ``generator`` draws the coarse k-means first, then subspaces
    0..M-1 (the reference splits one PRNG key into the same M + 1 parts,
    so trained codebooks differ between the packages; parity runs on
    handed-over state). ksub is clamped to n and ncoarse to [1, n]."""
    vectors = vectors.to(torch.float32).contiguous()
    n, d = vectors.shape
    if d % m_subspaces:
        raise ValueError(f"d={d} must be divisible by M={m_subspaces}")
    dsub = d // m_subspaces
    ksub = min(ksub, n)
    ncoarse = max(1, min(ncoarse, n))
    gen = make_generator(generator, vectors.device)

    coarse_centers, coarse_ids = kmeans(vectors, ncoarse, iters=iters,
                                        generator=gen)
    sub = (vectors - coarse_centers[coarse_ids]).reshape(n, m_subspaces,
                                                          dsub)
    books, codes = [], []
    for j in range(m_subspaces):
        c, lbl = kmeans(sub[:, j, :].contiguous(), ksub, iters=iters,
                        generator=gen)
        books.append(c)
        codes.append(lbl)
    # ksub <= 256 fits uint8, a quarter of int32's bytes
    code_dtype = torch.uint8 if ksub <= 256 else torch.int32
    return from_arrays(torch.stack(books), torch.stack(codes, dim=1).to(
        code_dtype), coarse_centers, coarse_ids)


def scan_luts(index: PQIndex, queries: Tensor) -> Tensor:
    """(q, d) -> (q, M, ncoarse * ksub): ``compute_luts``'s tables with the
    coarse axis inside the subspace axis, contiguous, as the ADC scan reads
    them through the combined codes; ``ops.pq_scan_luts``, one launch on
    the card. Each entry is the reference's expression."""
    return ops.pq_scan_luts(queries.contiguous(), index.codebooks,
                            index.coarse_centers, index.coarse_dot,
                            index.cb_sq)


def compute_luts(index: PQIndex, queries: Tensor) -> Tensor:
    """(q, d) -> (q, ncoarse, M, ksub) squared-distance lookup tables.

    lut[i, c, m, j] = ||(q_i - coarse_c)_m - codebook[m, j]||^2, expanded as
    ||qres_m||^2 - 2 (q_m . cb_j - center_m . cb_j) + ||cb_j||^2: the q . cb
    cross term (B8's), the residual norms and the sums with the build's
    center . cb and ||cb||^2 terms are one op, ``ops.pq_scan_luts``."""
    luts = scan_luts(index, queries)
    return luts.reshape(*luts.shape[:2], index.ncoarse,
                        index.ksub).transpose(1, 2)


def search(index: PQIndex, queries: Tensor, k: int):
    """ADC scan of every row through its coarse LUT. queries (q, d).
    Returns (scores (q, k) f32 = -squared ADC distance, ids (q, k) int32),
    ties to the smaller row id, as ``lax.top_k`` orders them."""
    return ops.pq_score_topk(index.ccodes, scan_luts(index, queries),
                             min(k, index.size), index.grouped)


def reconstruct(index: PQIndex, ids: Tensor) -> Tensor:
    """Decode rows back to d-dim vectors: coarse center + the codewords of
    each subspace. ids of any shape; returns (..., d)."""
    ids = ids.long()
    codes = index.codes[ids].long()                      # (..., M)
    parts = [index.codebooks[j][codes[..., j]]
             for j in range(index.n_subspaces)]
    residual = torch.cat(parts, dim=-1)
    return index.coarse_centers[index.coarse_ids[ids].long()] + residual
