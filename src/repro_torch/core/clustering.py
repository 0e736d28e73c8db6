"""Fixed-iteration k-means (k-means++ seeding + Lloyd's), in PyTorch.

Used by the cluster-mode transform (Eq. 6) and the IVF coarse quantizer.
Mirrors ``repro.core.clustering``; the random draws come from an explicit
``torch.Generator`` and so differ from the JAX package's PRNG (parity tests
hand centroids across instead of comparing trained ones).

The JAX formulation materialises (n, k) matrices that do not fit the card
at n=1M, k=1024: it recomputes every point's distance to all k centers on
each of the k seeding steps, and builds an (n, k) one-hot for the center
update. Here seeding keeps a running ``dmin`` updated with the newest
center only (the same sampling distribution: a min over the same centers),
the update sums with ``index_add_``, and distances are taken over row
chunks of at most ``CHUNK_ELEMS`` entries. ``index_add_`` on a CUDA tensor
adds with atomics, so centers trained on the card may differ in their last
bits from run to run; on the CPU they are deterministic.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Tensor = torch.Tensor

CHUNK_ELEMS = 1 << 26   # largest (rows, k) distance block held at once


def _pairwise_sq_dists(x: Tensor, c: Tensor) -> Tensor:
    """(n, d) x (k, d) -> (n, k) squared Euclidean distances (clamped >= 0),
    the JAX package's expansion."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    return torch.clamp(x2 - 2.0 * (x @ c.T) + c2, min=0.0)


def _chunks(n: int, k: int):
    step = max(1, CHUNK_ELEMS // max(k, 1))
    return ((s, min(n, s + step)) for s in range(0, n, step))


def _nearest(x: Tensor, centers: Tensor):
    """(labels (n,) int64, min squared distance (n,)) over row chunks; the
    first center wins a tie, as ``jnp.argmin`` picks."""
    labels = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    dmin = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
    for s, e in _chunks(x.shape[0], centers.shape[0]):
        dmin[s:e], labels[s:e] = torch.min(
            _pairwise_sq_dists(x[s:e], centers), dim=-1)
    return labels, dmin


Seed = Union[None, int, torch.Generator]


def make_generator(rng: Seed, device: torch.device) -> torch.Generator:
    """A given generator as it is, else one on ``device`` seeded with
    ``rng`` (0 when None, as the reference's default ``PRNGKey(0)``)."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=device).manual_seed(0 if rng is None
                                                      else int(rng))


def kmeans_plus_plus_init(x: Tensor, k: int, generator: Seed = None
                          ) -> Tensor:
    """k-means++ seeding: the first center uniform, each next one drawn with
    probability proportional to the squared distance to the nearest center
    chosen so far. Returns centers (k, d), rows of x. O(k n d) with one
    (n,) running minimum; no host sync."""
    return _plus_plus(x, k, make_generator(generator, x.device))[0]


def _plus_plus(x: Tensor, k: int, gen: torch.Generator):
    """k-means++ seeding; returns (centers, the running minimum squared
    distance of each row to them)."""
    n = x.shape[0]
    centers = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    centers[0] = x[first[0]]
    dmin = _pairwise_sq_dists(x, centers[:1])[:, 0]
    for i in range(1, k):
        # inverse-CDF draw: rows at distance 0 (the chosen centers) have
        # zero width and cannot be drawn while any other row remains
        cdf = torch.cumsum(dmin.double(), 0)
        u = torch.rand((1,), generator=gen, device=x.device,
                       dtype=torch.float64) * cdf[-1]
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
        centers[i] = x[idx[0]]
        dmin = torch.minimum(dmin, _pairwise_sq_dists(x, centers[i:i + 1])[:, 0])
    return centers, dmin


def lloyd_step(x: Tensor, centers: Tensor) -> Tensor:
    """One Lloyd update: each center becomes the mean of the rows nearest
    to it; a center with no rows keeps its place."""
    k = centers.shape[0]
    labels, _ = _nearest(x, centers)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    sums = torch.zeros_like(centers).index_add_(0, labels, x)
    new = sums / torch.clamp(counts[:, None], min=1.0)
    return torch.where(counts[:, None] > 0, new, centers)


def kmeans(x: Tensor, k: int, iters: int = 25, generator: Seed = None):
    """Lloyd's with k-means++ seeding and a fixed iteration count. Returns
    (centers (k, d), labels (n,) int64). Empty clusters keep their center."""
    x = x.to(torch.float32)
    centers = kmeans_plus_plus_init(x, k, generator)
    for _ in range(iters):
        centers = lloyd_step(x, centers)
    labels, _ = _nearest(x, centers)
    return centers, labels


def assign(x: Tensor, centers: Tensor) -> Tensor:
    """Nearest-center assignment (n,) int64."""
    return _nearest(x, centers)[0]


def quantization_error(x: Tensor, centers: Tensor) -> Tensor:
    """Mean squared distance of each row to its nearest center."""
    return torch.mean(_nearest(x, centers)[1])
