"""FCVIIndex - the paper's Algorithm 1 in PyTorch (flat, IVF and PQ).

Offline: fit per-dim normalizers, fit psi, transform the corpus (the fused
transform kernel on the card), build the flat, IVF or residual-PQ backend
over the transformed vectors, keep the normalized originals for
re-scoring.

Online: transform the query with its filter, over-retrieve
k' = min(c * k/lambda * 1/alpha^2, N) (Thm 5.4), re-score the candidates with
lambda*cos(v,q) + (1-lambda)*cos(f,F_q) (the rescore kernel), return top-k.

``FCVIConfig.storage_dtype`` selects the flat and IVF corpus storage:
"float32", "bfloat16" (half the bytes) or "int8" (a quarter, with one fp32
scale per row, ``repro_torch.index.quant``). Norms and accumulation stay
fp32 and the exact refine and re-rank run on fp32 rows. PQ stores codes and
ignores it, as in the reference. Mirrors ``repro.core.fcvi``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.clustering import Seed, make_generator
from repro_torch.core.transform import Normalizer, Transform, fit_transform
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.index import flat as flat_mod
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import pq as pq_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_first

Tensor = torch.Tensor

BACKENDS = ("flat", "ivf", "pq")
STORAGE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class FCVIConfig:
    """Static configuration of an FCVI index.

    ``alpha`` is the filter fold strength, ``lam`` the combined-score
    weight, ``c`` the k' over-retrieval headroom, ``mode`` the psi variant
    (``n_clusters`` centers in cluster mode), ``nlist`` / ``nprobe`` the IVF
    lists and the lists each query probes, ``pq_m`` / ``pq_ksub`` /
    ``pq_coarse`` the PQ subspaces, codewords per subspace and coarse
    centers. ``storage_dtype`` ("float32", "bfloat16" or "int8") is the
    flat and IVF corpus storage (PQ ignores it)."""

    alpha: float = 1.0
    lam: float = 0.5            # lambda in [0,1]: 1 => pure vector similarity
    c: float = 4.0              # k' headroom constant (Alg. 1 line 7)
    mode: str = "partition"     # psi variant
    backend: str = "flat"
    auto_alpha: bool = False    # alpha = max(1, sqrt((1-lam)/lam)), Thm 5.4
    normalize: bool = True
    storage_dtype: str = "float32"
    n_clusters: int = 16        # cluster mode
    nlist: int = 64             # IVF
    nprobe: int = 8
    pq_m: int = 8               # PQ subspaces
    pq_ksub: int = 256
    pq_coarse: int = 32         # residual-PQ coarse centers

    def resolved_alpha(self) -> float:
        if self.auto_alpha:
            return float(theory.optimal_alpha(self.lam))
        return max(1.0, float(self.alpha))

    def resolved_storage_dtype(self) -> Optional[torch.dtype]:
        """The backends' build-time storage dtype: None keeps fp32, else
        ``torch.bfloat16`` or ``torch.int8``."""
        if self.storage_dtype not in STORAGE_DTYPES:
            raise ValueError(
                f"storage_dtype must be float32, bfloat16 or int8, got "
                f"{self.storage_dtype!r}")
        return STORAGE_DTYPES[self.storage_dtype]

    def check_supported(self) -> None:
        """Raise ValueError for an unknown backend or storage dtype."""
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        self.resolved_storage_dtype()


@dataclasses.dataclass(frozen=True)
class FCVIIndex:
    config: FCVIConfig
    transform: Transform
    backend: Union[flat_mod.FlatIndex, ivf_mod.IVFIndex,
                   pq_mod.PQIndex]      # transformed space
    vectors_n: Tensor            # (n, d) normalized originals (re-scoring)
    filters_n: Tensor            # (n, m) normalized filters

    @property
    def size(self) -> int:
        return self.vectors_n.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors_n.device


def _tensor(x, device: torch.device, dtype=torch.float32) -> Tensor:
    """A ``dtype`` tensor (``x``'s own dtype when None) on ``device`` from a
    tensor or array-like (arrays are copied, so the index never aliases the
    caller's memory). A numpy array of bfloat16 (``ml_dtypes.bfloat16``,
    what the JAX package's bf16 leaves become) is taken by its 16-bit
    pattern, which torch's bfloat16 shares."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
        return t if dtype is None else t.to(dtype)
    return torch.tensor(a, dtype=dtype, device=device)


def cosine_sim(a: Tensor, b: Tensor, eps: float = 1e-8) -> Tensor:
    num = torch.sum(a * b, dim=-1)
    den = (torch.linalg.vector_norm(a, dim=-1)
           * torch.linalg.vector_norm(b, dim=-1) + eps)
    return num / den


def build(vectors, filters, config: FCVIConfig, device: DeviceLike = "cuda",
          rng: Seed = None) -> FCVIIndex:
    """Offline indexing (Alg. 1 lines 1-5) on ``device``. vectors (n, d) and
    filters (n, m) are float32 arrays or tensors. ``rng`` (a seed or a
    ``torch.Generator`` on ``device``) draws the k-means of cluster mode and
    then of the IVF quantizer or of PQ's coarse quantizer and codebooks."""
    config.check_supported()
    dev = resolve_device(device)
    gen = make_generator(rng, dev)
    vectors, filters = _tensor(vectors, dev), _tensor(filters, dev)
    tfm = fit_transform(vectors, filters, config.resolved_alpha(),
                        config.mode, n_clusters=config.n_clusters,
                        generator=gen, normalize=config.normalize)
    vn, fn = tfm.normalize(vectors, filters)
    backend = build_backend(tfm.apply_normalized(vn, fn), config, gen)
    return FCVIIndex(config=config, transform=tfm, backend=backend,
                     vectors_n=vn, filters_n=fn)


def build_backend(transformed: Tensor, config: FCVIConfig,
                  generator: Seed = None):
    """The configured backend over the transformed corpus, flat and IVF
    stored at the configured storage dtype; IVF and PQ train their k-means
    with ``generator`` (seed 0 when None)."""
    st = config.resolved_storage_dtype()
    if config.backend == "ivf":
        return ivf_mod.build(transformed, config.nlist, generator,
                             storage_dtype=st)
    if config.backend == "pq":
        return pq_mod.build(transformed, m_subspaces=config.pq_m,
                            ksub=config.pq_ksub, generator=generator,
                            ncoarse=config.pq_coarse)
    return flat_mod.build(transformed, storage_dtype=st)


def _backend_search(index: FCVIIndex, q_t: Tensor, kp: int):
    """Top-kp candidates (scores, ids) of the transformed queries."""
    if index.config.backend == "ivf":
        return index.backend.search(q_t, kp, nprobe=index.config.nprobe)
    return index.backend.search(q_t, kp)


def combined_score(cand_v: Tensor, cand_f: Tensor, qn: Tensor, fqn: Tensor,
                   lam: float) -> Tensor:
    """lam*cos(v, q) + (1-lam)*cos(f, F_q) per candidate (the rescore
    kernel on the card). cand_v (b, kp, d); cand_f (b, kp, m); qn (b, d);
    fqn (b, m). Returns (b, kp)."""
    return ops.rescore(cand_v, cand_f, qn, fqn, lam)


def rescore(index: FCVIIndex, qn: Tensor, fqn: Tensor, cand_idx: Tensor,
            k: int):
    """Alg. 1 lines 10-16: combined-score re-ranking of candidates
    cand_idx (b, k'), one launch on the card (``ops.rescore_topk``).
    Returns (scores (b, k), ids (b, k))."""
    cand = cand_idx.long()
    return ops.rescore_topk(index.vectors_n[cand], index.filters_n[cand], qn,
                            fqn, index.config.lam, cand_idx, k)


def query(index: FCVIIndex, q: Tensor, f_q: Tensor, k: int,
          k_prime: Optional[int] = None):
    """Online query processing (Alg. 1 lines 6-16), batched. q (b, d) and
    f_q (b, m) on the index's device. Returns (scores (b, k), ids (b, k))."""
    cfg = index.config
    kp = k_prime if k_prime is not None else theory.k_prime(
        k, cfg.lam, cfg.resolved_alpha(), index.size, cfg.c)
    qn, fqn = index.transform.normalize(q, f_q)
    _, cand = _backend_search(index, index.transform.apply_normalized(qn, fqn),
                              kp)
    return rescore(index, qn, fqn, cand, k)


def multi_probe_query(index: FCVIIndex, q: Tensor, filter_probes: Tensor,
                      k: int, k_prime: Optional[int] = None):
    """Range and disjunctive filters (section 4.3): probe r representative
    filter vectors, merge and dedup the candidates, re-score them against
    the NEAREST probe, return the top-k. q (b, d); filter_probes (b, r, m)
    raw filter representatives. Returns (scores (b, k), ids (b, k)).

    The b * r probes go through the fused transform and the backend scan as
    one batch. The candidates are sorted by id (duplicates sit side by side
    and score -inf past their first copy). lam * cos(v, q) is the same for
    every probe, so the re-rank kernel runs once at lam = 1 over the (b,
    r * k', d) vectors, then once a probe at lam = 0 over the (b, r * k', m)
    filters, which stand in for both of its operands (the combine collapses
    to cos(f, probe)); the score is lam * s_v + (1 - lam) * max_r s_f, and
    the top-k takes the first occurrence of equal scores."""
    cfg = index.config
    b, r, m = filter_probes.shape
    kp = k_prime if k_prime is not None else theory.k_prime(
        k, cfg.lam, cfg.resolved_alpha(), index.size, cfg.c)
    tfm = index.transform
    qn = tfm.vec_norm.apply(q)
    fqn = tfm.filt_norm.apply(filter_probes)                  # (b, r, m)
    q_t = tfm.apply_normalized(qn[:, None, :].expand(b, r, qn.shape[-1]),
                               fqn)                           # (b, r, d)
    _, cand = _backend_search(index, q_t.reshape(b * r, -1), kp)
    cand = torch.sort(cand.reshape(b, -1), dim=-1, stable=True).values
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                 device=cand.device),
                     cand[:, 1:] == cand[:, :-1]], dim=-1)
    rows = cand.long()
    cv, cf = index.vectors_n[rows], index.filters_n[rows]
    probe = [fqn[:, j].contiguous() for j in range(r)]
    s_v = ops.rescore(cv, cf, qn, probe[0], 1.0)
    s_f = ops.rescore(cf, cf, probe[0], probe[0], 0.0)
    for j in range(1, r):
        s_f = torch.maximum(s_f, ops.rescore(cf, cf, probe[j], probe[j], 0.0))
    score = cfg.lam * s_v + (1.0 - cfg.lam) * s_f
    score = torch.where(dup, float("-inf"), score)
    vals, pos = topk_first(score, k)
    return vals, torch.gather(cand, -1, pos)


# ---------------------------------------------------------------------------
# Predicate (filtered) search support
# ---------------------------------------------------------------------------

def filters_raw(index: FCVIIndex) -> Tensor:
    """Raw-space attribute table (n, m) recovered from the stored normalized
    filters. Predicates evaluate over RAW attribute values; an engine built
    with an explicit ``attributes=`` table uses that, and this inverse is
    the default when only the normalized copy exists."""
    return index.transform.filt_norm.inverse(index.filters_n)


def fold_queries(index: FCVIIndex, q: Tensor, fold_raw) -> Tensor:
    """Transform raw queries (b, d) against a predicate's raw fold target
    (m,) (``CompiledPredicate.fold_target_raw``): every physical plan for
    the predicate scores in this one transformed frame."""
    fold = torch.as_tensor(fold_raw, dtype=torch.float32, device=q.device)
    return index.transform.fold_query(q, fold)


def ground_truth_combined(vectors_n: Tensor, filters_n: Tensor, qn: Tensor,
                          fqn: Tensor, k: int, lam: float):
    """Exact top-k under the paper's combined score (the recall reference).

    The cosines' dot products are one (b, n) matmul each instead of the
    JAX package's broadcast mul+sum, which would hold a (b, n, d) product
    in memory in eager PyTorch; equal up to fp32 rounding."""
    def cos(rows, qs):
        den = (torch.linalg.vector_norm(rows, dim=-1)[None, :]
               * torch.linalg.vector_norm(qs, dim=-1)[:, None] + 1e-8)
        return (qs @ rows.T) / den

    score = lam * cos(vectors_n, qn) + (1.0 - lam) * cos(filters_n, fqn)
    return topk_first(score, k)


def recall_at_k(pred_ids, true_ids) -> float:
    """|pred intersect true| / k, averaged over the query batch."""
    pred = torch.as_tensor(np.asarray(pred_ids, np.int64))
    true = torch.as_tensor(np.asarray(true_ids, np.int64))
    hits = (pred[:, :, None] == true[:, None, :]).any(-1)
    return float(hits.to(torch.float32).mean(dim=-1).mean())


# ---------------------------------------------------------------------------
# State handoff (the JAX package's ``fcvi.index_state`` format)
# ---------------------------------------------------------------------------

def index_state(index: FCVIIndex) -> dict:
    """The array state of an index as a nested dict, in the layout of
    ``repro.core.fcvi.index_state``: the fitted transform, the re-rank
    originals and the backend's source arrays (squared norms are derived and
    rematerialised by ``index_from_state``)."""
    tfm = index.transform
    t = {"alpha": torch.tensor(tfm.alpha, dtype=torch.float32),
         "vec_mean": tfm.vec_norm.mean, "vec_std": tfm.vec_norm.std,
         "filt_mean": tfm.filt_norm.mean, "filt_std": tfm.filt_norm.std}
    if tfm.centers is not None:
        t["centers"] = tfm.centers
    if tfm.proj is not None:
        t["proj"] = tfm.proj
    b = index.backend
    if index.config.backend == "pq":
        bstate = {"codebooks": b.codebooks, "codes": b.codes,
                  "coarse_centers": b.coarse_centers,
                  "coarse_ids": b.coarse_ids}
    elif index.config.backend == "ivf":
        bstate = {"vectors": b.vectors, "centroids": b.centroids,
                  "lists": b.lists, "list_sizes": b.list_sizes}
    else:
        bstate = {"vectors": b.vectors}
    if index.config.backend != "pq" and b.scales is not None:
        bstate["scales"] = b.scales
    return {"transform": t, "backend": bstate,
            "vectors_n": index.vectors_n, "filters_n": index.filters_n}


def index_from_state(config: FCVIConfig, state: dict,
                     device: DeviceLike = "cuda") -> FCVIIndex:
    """Rebuild an ``FCVIIndex`` on ``device`` from ``index_state`` output:
    this package's, or the JAX package's with its leaves converted to numpy.
    No re-fitting: the normalizers, centers, IVF centroids and id lists, and
    the PQ codebooks, codes (in their dtype) and coarse quantizer come from
    the state, as do the stored flat and IVF rows in their dtype (fp32,
    bf16, or int8 codes with their ``scales``); the squared norms, the IVF
    serving slabs and grouped scales, and PQ's build-time LUT terms and
    combined codes are rematerialised."""
    config.check_supported()
    dev = resolve_device(device)
    t, b = state["transform"], state["backend"]
    scales = _tensor(b["scales"], dev) if "scales" in b else None
    tfm = Transform(
        mode=config.mode,
        alpha=float(t["alpha"]),
        vec_norm=Normalizer(mean=_tensor(t["vec_mean"], dev),
                            std=_tensor(t["vec_std"], dev)),
        filt_norm=Normalizer(mean=_tensor(t["filt_mean"], dev),
                             std=_tensor(t["filt_std"], dev)),
        centers=_tensor(t["centers"], dev) if "centers" in t else None,
        proj=_tensor(t["proj"], dev) if "proj" in t else None)
    if config.backend == "pq":
        backend = pq_mod.from_arrays(
            _tensor(b["codebooks"], dev), _tensor(b["codes"], dev, None),
            _tensor(b["coarse_centers"], dev),
            _tensor(b["coarse_ids"], dev, torch.int32))
    elif config.backend == "ivf":
        backend = ivf_mod.from_lists(
            _tensor(b["vectors"], dev, None), _tensor(b["centroids"], dev),
            _tensor(b["lists"], dev, torch.int32),
            _tensor(b["list_sizes"], dev, torch.int32), scales)
    else:
        backend = flat_mod.from_stored(_tensor(b["vectors"], dev, None),
                                       scales)
    return FCVIIndex(config=config, transform=tfm, backend=backend,
                     vectors_n=_tensor(state["vectors_n"], dev),
                     filters_n=_tensor(state["filters_n"], dev))


def extend(index: FCVIIndex, new_vectors: Tensor,
           new_filters: Tensor) -> FCVIIndex:
    """Append rows and rebuild the backend over the re-transformed corpus
    (normalizers and centers stay frozen, paper section 4.2). The engine
    calls this on compaction.

    The backend is rebuilt at the configured storage dtype (int8 rows are
    re-quantized from the fp32 transformed corpus). As in the reference
    (``build_backend`` with its default key), an IVF or PQ backend is
    rebuilt from scratch: its k-means is re-trained on the
    whole corpus with the seed-0 generator, so compaction costs the k-means
    at full width, and the new quantizer (and codebooks) differ from the old
    ones."""
    tfm = index.transform
    vn_new, fn_new = tfm.normalize(new_vectors, new_filters)
    vectors_n = torch.cat([index.vectors_n, vn_new], dim=0)
    filters_n = torch.cat([index.filters_n, fn_new], dim=0)
    backend = build_backend(tfm.apply_normalized(vectors_n, filters_n),
                            index.config)
    return FCVIIndex(config=index.config, transform=tfm, backend=backend,
                     vectors_n=vectors_n, filters_n=filters_n)
