"""Synthetic vector+filter corpora structurally matched to the paper's data.

The paper's main dataset is SIFT1M with synthetic filters; these generators
reproduce its structure from a seed: mixture-of-Gaussians vectors and filters
that concatenate a Zipf-categorical one-hot group with uniform numeric
attributes. A numpy copy of ``CorpusSpec``, ``make_corpus`` and
``sample_queries`` from ``repro.data.synthetic``, draw for draw, so the same
spec and seed give the same corpus in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n: int = 50_000
    d: int = 128
    n_vec_clusters: int = 32
    n_categories: int = 8           # Zipf categorical attribute
    n_numeric: int = 3              # uniform numeric attributes
    zipf_a: float = 1.5
    noise: float = 0.35
    corr: float = 0.6               # filter<->vector-cluster correlation
    seed: int = 0

    @property
    def m(self) -> int:
        return self.n_categories + self.n_numeric


@dataclasses.dataclass
class Corpus:
    vectors: np.ndarray             # (n, d) f32
    filters: np.ndarray             # (n, m) f32
    vec_labels: np.ndarray          # (n,) vector cluster ids
    cat_labels: np.ndarray          # (n,) categorical attribute values
    spec: CorpusSpec


def make_corpus(spec: CorpusSpec) -> Corpus:
    rng = np.random.default_rng(spec.seed)
    centers = rng.normal(size=(spec.n_vec_clusters, spec.d)).astype(np.float32)
    labels = rng.integers(0, spec.n_vec_clusters, spec.n)
    vectors = (centers[labels]
               + spec.noise * rng.normal(size=(spec.n, spec.d))).astype(np.float32)

    # categorical attribute: Zipf-distributed, correlated with vector cluster
    zipf_p = 1.0 / np.arange(1, spec.n_categories + 1) ** spec.zipf_a
    zipf_p /= zipf_p.sum()
    random_cat = rng.choice(spec.n_categories, size=spec.n, p=zipf_p)
    correlated_cat = labels % spec.n_categories
    use_corr = rng.random(spec.n) < spec.corr
    cat = np.where(use_corr, correlated_cat, random_cat)
    onehot = np.zeros((spec.n, spec.n_categories), np.float32)
    onehot[np.arange(spec.n), cat] = 1.0

    # numeric attributes: uniform, one correlated with cluster id
    numeric = rng.uniform(0.0, 1.0, size=(spec.n, spec.n_numeric)).astype(np.float32)
    if spec.n_numeric > 0:
        numeric[:, 0] = (labels / spec.n_vec_clusters
                         + 0.1 * rng.normal(size=spec.n)).astype(np.float32)

    filters = np.concatenate([onehot, numeric], axis=1)
    return Corpus(vectors=vectors, filters=filters, vec_labels=labels,
                  cat_labels=cat, spec=spec)


def sample_queries(corpus: Corpus, n_queries: int, seed: int = 1,
                   in_distribution: bool = True):
    """Queries near corpus clusters with filter targets drawn from the data."""
    rng = np.random.default_rng(seed)
    spec = corpus.spec
    idx = rng.integers(0, spec.n, n_queries)
    q = (corpus.vectors[idx]
         + 0.5 * spec.noise * rng.normal(size=(n_queries, spec.d))).astype(np.float32)
    if in_distribution:
        fq = corpus.filters[rng.integers(0, spec.n, n_queries)].copy()
    else:
        fq = rng.normal(size=(n_queries, spec.m)).astype(np.float32)
    return q, fq.astype(np.float32)
