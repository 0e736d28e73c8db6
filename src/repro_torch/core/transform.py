"""FCVI geometric transformations (paper section 4.1), in PyTorch.

psi(v, f, alpha) folds a filter vector f in R^m into an embedding v in R^d:

  * partition (Eq. 5): subtract alpha * f from each m-segment of v;
  * cluster   (Eq. 6): the same with the nearest k-means center of f;
  * embedding (Eq. 7): v - alpha * W f with W in R^{d x m}.

All three are ``v - alpha * (f @ P)`` for an (m, d) fold matrix P (the 0/1
tiling, or W^T), which is what the fused transform kernel computes. Each
dimension of v and f is first standardized over the corpus (Eq. 1-2).
Mirrors ``repro.core.transform``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.clustering import Seed, kmeans
from repro_torch.kernels import ops
from repro_torch.kernels.ref import partition_matrix

Tensor = torch.Tensor

MODES = ("partition", "cluster", "embedding")


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """Per-dimension affine standardizer: x -> (x - mean) / std."""

    mean: Tensor  # (dim,)
    std: Tensor   # (dim,)

    @staticmethod
    def fit(x: Tensor, eps: float = 1e-6) -> "Normalizer":
        """Fit over all leading axes of ``x`` (..., dim). The std is the
        population std (``correction=0``), as ``jnp.std`` computes it."""
        flat = x.reshape(-1, x.shape[-1])
        mean = flat.mean(dim=0)
        std = flat.std(dim=0, correction=0) + eps
        return Normalizer(mean=mean, std=std)

    def apply(self, x: Tensor) -> Tensor:
        return (x - self.mean) / self.std

    def inverse(self, x: Tensor) -> Tensor:
        return x * self.std + self.mean

    @staticmethod
    def identity(dim: int, dtype=torch.float32, device=None) -> "Normalizer":
        return Normalizer(mean=torch.zeros(dim, dtype=dtype, device=device),
                          std=torch.ones(dim, dtype=dtype, device=device))


def check_partition(d: int, m: int) -> int:
    """The number of m-segments of a d-vector; raises unless m divides d."""
    if m <= 0 or d <= 0:
        raise ValueError(f"dims must be positive, got d={d} m={m}")
    if m > d:
        raise ValueError(f"filter dim m={m} must be <= vector dim d={d}")
    if d % m != 0:
        raise ValueError(
            f"partition transform needs d % m == 0, got d={d}, m={m}; "
            "pad the filter or use the embedding transform")
    return d // m


def psi_partition(v: Tensor, f: Tensor, alpha: float) -> Tensor:
    """Eq. 5: [v^(1) - a f, ..., v^(d/m) - a f] for v (..., d), f (..., m)."""
    d, m = v.shape[-1], f.shape[-1]
    segs = check_partition(d, m)
    vt = v.reshape(*v.shape[:-1], segs, m)
    return (vt - alpha * f[..., None, :]).reshape(v.shape)


def nearest_center(f: Tensor, centers: Tensor) -> Tensor:
    """Each filter replaced by its nearest center (squared L2; the first
    center wins a tie, as ``jnp.argmin`` picks)."""
    d2 = (torch.sum(f * f, dim=-1, keepdim=True) - 2.0 * f @ centers.T
          + torch.sum(centers * centers, dim=-1))
    return centers[torch.argmin(d2, dim=-1)]


def psi_cluster(v: Tensor, f: Tensor, alpha: float, centers: Tensor) -> Tensor:
    """Eq. 6: Eq. 5 with the nearest center of f; centers (n_clusters, m)."""
    return psi_partition(v, nearest_center(f, centers), alpha)


def psi_embedding(v: Tensor, f: Tensor, alpha: float, w: Tensor) -> Tensor:
    """Eq. 7: v - a * W f with W (d, m)."""
    return v - alpha * (f @ w.T)


@dataclasses.dataclass(frozen=True)
class Transform:
    """Fitted FCVI transform: mode + alpha + normalizers (+ centers / W)."""

    mode: str
    alpha: float
    vec_norm: Normalizer
    filt_norm: Normalizer
    centers: Optional[Tensor] = None   # (n_clusters, m) for mode=cluster
    proj: Optional[Tensor] = None      # (d, m) for mode=embedding

    def normalize(self, v: Tensor, f: Tensor) -> tuple:
        return self.vec_norm.apply(v), self.filt_norm.apply(f)

    def projection(self) -> Tensor:
        """The (m, d) fold matrix P with psi(v, f, a) == v - a * (f @ P):
        the 0/1 tiling for partition and cluster, W^T for embedding."""
        if self.mode == "embedding":
            return self.proj.T.contiguous()
        mean = self.vec_norm.mean
        return partition_matrix(mean.shape[-1], self.filt_norm.mean.shape[-1],
                                mean.dtype, mean.device)

    def _fused(self, v: Tensor, f: Tensor,
               vec_norm: Optional[Normalizer],
               filt_norm: Optional[Normalizer]) -> Tensor:
        """One fused transform over the flattened rows; a None normalizer is
        the identity."""
        d, m = v.shape[-1], f.shape[-1]
        vm = vs = fm = fs = None
        if vec_norm is not None:
            vm, vs = vec_norm.mean, vec_norm.std
        if filt_norm is not None:
            fm, fs = filt_norm.mean, filt_norm.std
        out = ops.fused_transform(
            v.reshape(-1, d).contiguous(), f.reshape(-1, m).contiguous(),
            self.projection(), self.alpha, vm, vs, fm, fs)
        return out.reshape(*v.shape[:-1], d)

    def apply(self, v: Tensor, f: Tensor) -> Tensor:
        """psi(norm(v), norm(f), alpha) on RAW v (..., d) and f (..., m): one
        fused transform (cluster mode substitutes the centers first)."""
        if self.mode == "cluster":
            mu = nearest_center(self.filt_norm.apply(f), self.centers)
            return self._fused(v, mu, self.vec_norm, None)
        return self._fused(v, f, self.vec_norm, self.filt_norm)

    def apply_normalized(self, vn: Tensor, fn: Tensor) -> Tensor:
        """psi on ALREADY-normalized vn (..., d) and fn (..., m): the hot
        path's entry point (the engine normalizes once and reuses vn/fn for
        re-ranking)."""
        if self.mode == "cluster":
            fn = nearest_center(fn, self.centers)
        return self._fused(vn, fn, None, None)


def fit_transform(vectors: Tensor, filters: Tensor, alpha: float,
                  mode: str = "partition", *, n_clusters: int = 0,
                  proj: Optional[Tensor] = None, generator: Seed = None,
                  normalize: bool = True) -> Transform:
    """Fit the normalizers (and, in cluster mode, ``n_clusters`` k-means
    centers of the normalized filters, drawn with ``generator``) on the
    corpus and return the Transform."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    d, m = vectors.shape[-1], filters.shape[-1]
    if mode != "embedding":
        check_partition(d, m)
    dev = vectors.device
    if normalize:
        vec_norm, filt_norm = Normalizer.fit(vectors), Normalizer.fit(filters)
    else:
        vec_norm = Normalizer.identity(d, vectors.dtype, dev)
        filt_norm = Normalizer.identity(m, filters.dtype, dev)
    centers = None
    if mode == "cluster":
        if n_clusters <= 0:
            raise ValueError("cluster mode needs n_clusters > 0")
        centers, _ = kmeans(filt_norm.apply(filters), n_clusters,
                            generator=generator)
    w = None
    if mode == "embedding":
        if proj is None:
            # untrained default: the tiled identity, under which embedding
            # reduces to partition
            if d % m:
                raise ValueError(
                    "embedding mode with d % m != 0 requires proj")
            w = torch.eye(m, dtype=vectors.dtype, device=dev).repeat(d // m, 1)
        else:
            w = torch.as_tensor(proj, dtype=vectors.dtype, device=dev)
            if tuple(w.shape) != (d, m):
                raise ValueError(
                    f"proj must be (d={d}, m={m}), got {tuple(w.shape)}")
    return Transform(mode=mode, alpha=float(alpha), vec_norm=vec_norm,
                     filt_norm=filt_norm, centers=centers, proj=w)
