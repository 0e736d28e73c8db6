"""IVF index: k-means coarse quantizer + two list layouts, in PyTorch.

* ``lists`` (nlist, max_list) int32 corpus ids, -1 pad: the compact id
  layout ``add`` regrows and search maps slots back through.
* ``grouped`` (nlist, max_list, d) corpus rows grouped by list (with
  ``grouped_sq`` and ``valid``): the serving layout the IVF scans read, so
  probing a list reads one contiguous slab.

Search mirrors the JAX package's kernel path (``use_pallas=True``): the
coarse quantizer is ``ops.score_topk`` over the centroids, the probed lists
are deduplicated across the batch (``ops.dedup_probes``), and the unique
lists are scanned probe-major (``ops.ivf_score_topk_dedup``, or its rows
variant for the gather-free step). Each query scores nprobe/nlist of the
corpus. Mirrors ``repro.index.ivf`` for fp32 storage; the filter-algebra
helpers (``grouped_mask``, ``masked_candidates``, ``routed_candidates``,
``eligible_lists``) are ROADMAP A7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.clustering import Seed, assign, kmeans
from repro_torch.index.slab import build_grouped
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    vectors: Tensor     # (n, d) corpus (transformed space)
    sq_norms: Tensor    # (n,)
    centroids: Tensor   # (nlist, d)
    lists: Tensor       # (nlist, max_list) int32 corpus ids, -1 pad
    list_sizes: Tensor  # (nlist,) int32
    grouped: Tensor     # (nlist, max_list, d) corpus grouped by list
    grouped_sq: Tensor  # (nlist, max_list)
    valid: Tensor       # (nlist, max_list) float 0/1 (1 = real row)

    @property
    def size(self) -> int:
        return self.vectors.shape[0]

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def max_list(self) -> int:
        return self.lists.shape[1]

    def search(self, queries: Tensor, k: int, nprobe: int = 8):
        """SearchBackend entry point."""
        return search(self, queries, k, nprobe=nprobe)

    def search_rows(self, queries: Tensor, k: int, payload_v: Tensor,
                    payload_f: Tensor, *, grouped_pv: Optional[Tensor] = None,
                    grouped_pf: Optional[Tensor] = None, nprobe: int = 8):
        """Gather-free entry point (rows, not just ids)."""
        return search_rows(self, queries, k, payload_v, payload_f,
                           grouped_pv, grouped_pf, nprobe=nprobe)


def _pad_to(x: int, mult: int) -> int:
    return x + (-x) % mult


def lists_from_labels(labels: Tensor, nlist: int, pad_to_multiple: int = 8):
    """The id lists of a labelling: (lists (nlist, max_list) int32 with -1
    pad, sizes (nlist,) int32), max_list the largest list rounded up to
    ``pad_to_multiple``. A stable sort of the labels keeps each list's ids
    ascending, as the reference's per-list ``np.nonzero`` does."""
    labels = labels.long()
    sizes = torch.bincount(labels, minlength=nlist)
    max_list = _pad_to(max(1, int(sizes.max())), pad_to_multiple)
    order = torch.argsort(labels, stable=True)
    by_list = labels[order]
    starts = torch.cumsum(sizes, 0) - sizes
    slot = torch.arange(labels.shape[0], device=labels.device) - starts[by_list]
    lists = torch.full((nlist, max_list), -1, dtype=torch.int32,
                       device=labels.device)
    lists[by_list, slot] = order.to(torch.int32)
    return lists, sizes.to(torch.int32)


def from_lists(vectors: Tensor, centroids: Tensor, lists: Tensor,
               list_sizes: Tensor) -> IVFIndex:
    """An IVFIndex over fp32 ``vectors`` with the given quantizer and id
    lists; squared norms and the serving slabs are materialised here."""
    vectors = vectors.to(torch.float32).contiguous()
    sq_norms = torch.sum(vectors * vectors, dim=-1)
    grouped, grouped_sq, valid = build_grouped(vectors, sq_norms, lists)
    return IVFIndex(vectors=vectors, sq_norms=sq_norms,
                    centroids=centroids.to(torch.float32).contiguous(),
                    lists=lists.to(torch.int32).contiguous(),
                    list_sizes=list_sizes.to(torch.int32),
                    grouped=grouped, grouped_sq=grouped_sq, valid=valid)


def build(vectors: Tensor, nlist: int, generator: Seed = None,
          iters: int = 15, pad_to_multiple: int = 8,
          storage_dtype=None) -> IVFIndex:
    """Train the coarse quantizer (k-means with ``generator``) and
    materialise both list layouts on the vectors' device. Reduced storage
    (bfloat16, int8) is ROADMAP A6."""
    if storage_dtype is not None:
        raise NotImplementedError(
            f"storage_dtype={storage_dtype!r}: reduced-precision IVF storage "
            "is ROADMAP A6; the port stores IVF slabs in float32")
    vectors = vectors.to(torch.float32).contiguous()
    centroids, labels = kmeans(vectors, nlist, iters=iters,
                               generator=generator)
    lists, sizes = lists_from_labels(labels, nlist, pad_to_multiple)
    return from_lists(vectors, centroids, lists, sizes)


def _group_scales(scales: Tensor, lists: Tensor) -> Tensor:
    raise NotImplementedError(
        "int8 IVF storage (grouped per-row scales) is ROADMAP A6")


def _probe(index: IVFIndex, queries: Tensor, nprobe: int):
    """Coarse quantizer + dedup: (uniq, member) of the batch's probes."""
    c2 = torch.sum(index.centroids * index.centroids, dim=-1)
    _, probe = ops.score_topk(index.centroids, c2, queries,
                              min(nprobe, index.nlist))
    return ops.dedup_probes(probe, index.nlist)


def _corpus_ids(index: IVFIndex, vals: Tensor, flat_ids: Tensor,
                queries: Tensor):
    """Kernel output -> (negative squared L2 (b, k), corpus ids (b, k)):
    adds -||q||^2 back and maps flat slots through ``lists``; dead (-inf)
    slots carry id 0."""
    vals = vals - torch.sum(queries * queries, dim=-1, keepdim=True)
    cand = index.lists.reshape(-1)[flat_ids.long()]
    dead = torch.isneginf(vals)
    return vals, torch.where(dead, 0, torch.clamp(cand, min=0)), dead


def search(index: IVFIndex, queries: Tensor, k: int, nprobe: int = 8):
    """Probe the nprobe nearest lists per query; exact scores inside them.
    queries (q, d). Returns (scores (q, k) f32 negative squared L2, ids
    (q, k) int32 corpus rows)."""
    uniq, member = _probe(index, queries, nprobe)
    vals, flat_ids = ops.ivf_score_topk_dedup(
        index.grouped, index.grouped_sq, index.valid, uniq, member, queries,
        k)
    vals, ids, _ = _corpus_ids(index, vals, flat_ids, queries)
    return vals, ids


def search_rows(index: IVFIndex, queries: Tensor, k: int, payload_v: Tensor,
                payload_f: Tensor, grouped_pv: Optional[Tensor] = None,
                grouped_pf: Optional[Tensor] = None, nprobe: int = 8):
    """Gather-free probed search: ``search``'s (scores, ids) plus the
    winners' payload rows (q, k, dv) / (q, k, m).

    payload_v (n, dv) / payload_f (n, m) are row-aligned with the corpus;
    grouped_pv / grouped_pf are the same payloads in the grouped layout
    (``build_grouped_payload``; built here when not given), which the rows
    scan reads. Dead (-inf) slots carry id 0 and corpus row 0's payload,
    as a gather by id would give them."""
    if grouped_pv is None:
        grouped_pv = build_grouped_payload(payload_v, index.lists)
    if grouped_pf is None:
        grouped_pf = build_grouped_payload(payload_f, index.lists)
    uniq, member = _probe(index, queries, nprobe)
    vals, flat_ids, rows_v, rows_f = ops.ivf_score_topk_dedup_rows(
        index.grouped, index.grouped_sq, index.valid, uniq, member, queries,
        grouped_pv, grouped_pf, k)
    vals, ids, dead = _corpus_ids(index, vals, flat_ids, queries)
    rows_v = torch.where(dead[..., None], payload_v[0], rows_v)
    rows_f = torch.where(dead[..., None], payload_f[0], rows_f)
    return vals, ids, rows_v, rows_f


def build_grouped_payload(payload: Tensor, lists: Tensor) -> Tensor:
    """A corpus-row-aligned payload (n, x) in the grouped (nlist, max_list,
    x) layout, zeros on the -1 pad slots."""
    rows = payload[torch.clamp(lists, min=0).long()]
    return torch.where((lists >= 0)[..., None], rows, 0.0).contiguous()


def add(index: IVFIndex, new_vectors: Tensor) -> IVFIndex:
    """Incremental insert: centroids stay fixed; each new row joins its
    nearest list after the list's current rows, in input order, and the
    serving slabs are rebuilt. ``max_list`` grows to a multiple of 8 when a
    list outgrows it."""
    new_vectors = new_vectors.to(torch.float32)
    labels = assign(new_vectors, index.centroids)
    nlist, max_list = index.lists.shape
    old = index.list_sizes.long()
    counts = torch.bincount(labels, minlength=nlist)
    sizes = old + counts
    new_max = _pad_to(max(max_list, int(sizes.max())), 8)
    lists = torch.full((nlist, new_max), -1, dtype=torch.int32,
                       device=index.lists.device)
    lists[:, :max_list] = index.lists
    order = torch.argsort(labels, stable=True)
    by_list = labels[order]
    rank = (torch.arange(labels.shape[0], device=labels.device)
            - (torch.cumsum(counts, 0) - counts)[by_list])
    lists[by_list, old[by_list] + rank] = (index.size + order).to(torch.int32)
    vectors = torch.cat([index.vectors, new_vectors], dim=0)
    return from_lists(vectors, index.centroids, lists, sizes)
