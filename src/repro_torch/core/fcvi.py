"""FCVIIndex - the paper's Algorithm 1 in PyTorch (flat and IVF, fp32).

Offline: fit per-dim normalizers, fit psi, transform the corpus (the fused
transform kernel on the card), build the flat or IVF backend over the
transformed vectors, keep the normalized originals for re-scoring.

Online: transform the query with its filter, over-retrieve
k' = min(c * k/lambda * 1/alpha^2, N) (Thm 5.4), re-score the candidates with
lambda*cos(v,q) + (1-lambda)*cos(f,F_q) (the rescore kernel), return top-k.

Mirrors ``repro.core.fcvi``. The PQ backend (ROADMAP A9) and
reduced-precision storage (A6) are later slices and raise here.
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
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_first

Tensor = torch.Tensor

BACKENDS = ("flat", "ivf", "pq")
_LATER = {"pq": "ROADMAP A9"}


@dataclasses.dataclass(frozen=True)
class FCVIConfig:
    """Static configuration of an FCVI index.

    ``alpha`` is the filter fold strength, ``lam`` the combined-score
    weight, ``c`` the k' over-retrieval headroom, ``mode`` the psi variant
    (``n_clusters`` centers in cluster mode), ``nlist`` / ``nprobe`` the IVF
    lists and the lists each query probes. ``backend`` and
    ``storage_dtype`` name what the JAX package offers; the port serves
    ``"flat"`` and ``"ivf"`` at ``"float32"`` and raises
    NotImplementedError naming the ROADMAP item for the rest."""

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

    def resolved_alpha(self) -> float:
        if self.auto_alpha:
            return float(theory.optimal_alpha(self.lam))
        return max(1.0, float(self.alpha))

    def check_supported(self) -> None:
        """Raise for a backend or storage dtype the port does not serve
        yet."""
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.backend in _LATER:
            raise NotImplementedError(
                f"backend={self.backend!r} is {_LATER[self.backend]}; the "
                "port serves backend='flat' and backend='ivf'")
        if self.storage_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"storage_dtype must be float32, bfloat16 or int8, got "
                f"{self.storage_dtype!r}")
        if self.storage_dtype != "float32":
            raise NotImplementedError(
                f"storage_dtype={self.storage_dtype!r} is ROADMAP A6; the "
                f"port stores {self.backend} indexes in float32")


@dataclasses.dataclass(frozen=True)
class FCVIIndex:
    config: FCVIConfig
    transform: Transform
    backend: Union[flat_mod.FlatIndex, ivf_mod.IVFIndex]  # transformed space
    vectors_n: Tensor            # (n, d) normalized originals (re-scoring)
    filters_n: Tensor            # (n, m) normalized filters

    @property
    def size(self) -> int:
        return self.vectors_n.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors_n.device


def _tensor(x, device: torch.device, dtype=torch.float32) -> Tensor:
    """A ``dtype`` tensor on ``device`` from a tensor or array-like (arrays
    are copied, so the index never aliases the caller's memory)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


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
    of the IVF quantizer, in that order."""
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
    """The configured backend over the transformed corpus; IVF trains its
    quantizer with ``generator`` (seed 0 when None)."""
    if config.backend == "ivf":
        return ivf_mod.build(transformed, config.nlist, generator)
    return flat_mod.build(transformed)


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
    cand_idx (b, k'). Returns (scores (b, k), ids (b, k))."""
    cand = cand_idx.long()
    score = combined_score(index.vectors_n[cand], index.filters_n[cand],
                           qn, fqn, index.config.lam)
    vals, pos = topk_first(score, k)
    return vals, torch.gather(cand_idx, -1, pos)


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
    bstate = {"vectors": b.vectors}
    if index.config.backend == "ivf":
        bstate.update(centroids=b.centroids, lists=b.lists,
                      list_sizes=b.list_sizes)
    return {"transform": t, "backend": bstate,
            "vectors_n": index.vectors_n, "filters_n": index.filters_n}


def index_from_state(config: FCVIConfig, state: dict,
                     device: DeviceLike = "cuda") -> FCVIIndex:
    """Rebuild an ``FCVIIndex`` on ``device`` from ``index_state`` output:
    this package's, or the JAX package's with its leaves converted to numpy.
    No re-fitting: the normalizers, centers, IVF centroids and id lists come
    from the state; the squared norms (and the IVF serving slabs) are
    rematerialised in fp32 from the stored vectors."""
    config.check_supported()
    dev = resolve_device(device)
    t, b = state["transform"], state["backend"]
    if "scales" in b:
        raise NotImplementedError("int8 storage state is ROADMAP A6")
    tfm = Transform(
        mode=config.mode,
        alpha=float(t["alpha"]),
        vec_norm=Normalizer(mean=_tensor(t["vec_mean"], dev),
                            std=_tensor(t["vec_std"], dev)),
        filt_norm=Normalizer(mean=_tensor(t["filt_mean"], dev),
                             std=_tensor(t["filt_std"], dev)),
        centers=_tensor(t["centers"], dev) if "centers" in t else None,
        proj=_tensor(t["proj"], dev) if "proj" in t else None)
    vectors = _tensor(b["vectors"], dev)
    if config.backend == "ivf":
        backend = ivf_mod.from_lists(
            vectors, _tensor(b["centroids"], dev),
            _tensor(b["lists"], dev, torch.int32),
            _tensor(b["list_sizes"], dev, torch.int32))
    else:
        backend = flat_mod.build(vectors)
    return FCVIIndex(config=config, transform=tfm, backend=backend,
                     vectors_n=_tensor(state["vectors_n"], dev),
                     filters_n=_tensor(state["filters_n"], dev))


def extend(index: FCVIIndex, new_vectors: Tensor,
           new_filters: Tensor) -> FCVIIndex:
    """Append rows and rebuild the backend over the re-transformed corpus
    (normalizers and centers stay frozen, paper section 4.2). The engine
    calls this on compaction.

    As in the reference (``build_backend`` with its default key), an IVF
    backend is rebuilt from scratch: its k-means is re-trained on the whole
    corpus with the seed-0 generator, so compaction costs a k-means at full
    width, and the new quantizer differs from the old one."""
    tfm = index.transform
    vn_new, fn_new = tfm.normalize(new_vectors, new_filters)
    vectors_n = torch.cat([index.vectors_n, vn_new], dim=0)
    filters_n = torch.cat([index.filters_n, fn_new], dim=0)
    backend = build_backend(tfm.apply_normalized(vectors_n, filters_n),
                            index.config)
    return FCVIIndex(config=index.config, transform=tfm, backend=backend,
                     vectors_n=vectors_n, filters_n=filters_n)
