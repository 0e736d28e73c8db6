"""Synthetic vector+filter corpora structurally matched to the paper's data.

The paper's main dataset is SIFT1M with synthetic filters; these generators
reproduce its structure from a seed: mixture-of-Gaussians vectors and filters
that concatenate a Zipf-categorical one-hot group with uniform numeric
attributes, plus the three distribution-shift protocols of the paper's
Table 2. A numpy copy of ``repro.data.synthetic``, draw for draw, so the
same spec and seeds give the same arrays in both packages.
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


# ---------------------------------------------------------------------------
# Distribution shifts (Table 2 protocols)
# ---------------------------------------------------------------------------

def shift_filter_distribution(corpus: Corpus, seed: int = 7) -> Corpus:
    """Low -> high selectivity: concentrate categories on the rare tail and
    stretch the numeric attribute (the paper's 'filter distribution change').
    Draws nothing: ``seed`` is kept for the reference's signature."""
    spec = corpus.spec
    new = Corpus(vectors=corpus.vectors.copy(), filters=corpus.filters.copy(),
                 vec_labels=corpus.vec_labels.copy(),
                 cat_labels=corpus.cat_labels.copy(), spec=spec)
    # remap: most-frequent category -> rarest (inverts selectivity)
    remap = np.arange(spec.n_categories)[::-1]
    cat = remap[corpus.cat_labels]
    onehot = np.zeros((spec.n, spec.n_categories), np.float32)
    onehot[np.arange(spec.n), cat] = 1.0
    new.filters[:, : spec.n_categories] = onehot
    # compress numeric mass into the upper half (selectivity shift while
    # staying in-support, the paper's low->high selectivity protocol)
    new.filters[:, spec.n_categories:] = (
        0.5 + 0.5 * corpus.filters[:, spec.n_categories:])
    new.cat_labels = cat
    return new


def shift_vector_distribution(corpus: Corpus, frac_new: float = 0.3,
                              seed: int = 8) -> Corpus:
    """Inject novel vector clusters (the paper's 'vector distribution change')."""
    rng = np.random.default_rng(seed)
    spec = corpus.spec
    n_new = int(spec.n * frac_new)
    k_new = max(4, spec.n_vec_clusters // 4)
    centers = 2.5 * rng.normal(size=(k_new, spec.d)).astype(np.float32)
    labels = rng.integers(0, k_new, n_new)
    vec_new = (centers[labels]
               + spec.noise * rng.normal(size=(n_new, spec.d))).astype(np.float32)
    cat_new = rng.integers(0, spec.n_categories, n_new)
    onehot = np.zeros((n_new, spec.n_categories), np.float32)
    onehot[np.arange(n_new), cat_new] = 1.0
    num_new = rng.uniform(0, 1, size=(n_new, spec.n_numeric)).astype(np.float32)
    filt_new = np.concatenate([onehot, num_new], axis=1)

    keep = spec.n - n_new
    return Corpus(
        vectors=np.concatenate([corpus.vectors[:keep], vec_new]),
        filters=np.concatenate([corpus.filters[:keep], filt_new]),
        vec_labels=np.concatenate(
            [corpus.vec_labels[:keep], labels + spec.n_vec_clusters]),
        cat_labels=np.concatenate([corpus.cat_labels[:keep], cat_new]),
        spec=spec,
    )


def shifted_query_pattern(corpus: Corpus, n_queries: int, seed: int = 9):
    """Out-of-pattern queries: off-cluster vectors + rare-category filters."""
    rng = np.random.default_rng(seed)
    spec = corpus.spec
    q = rng.normal(size=(n_queries, spec.d)).astype(np.float32) * 1.5
    rare = spec.n_categories - 1 - rng.integers(0, max(spec.n_categories // 3, 1),
                                                n_queries)
    onehot = np.zeros((n_queries, spec.n_categories), np.float32)
    onehot[np.arange(n_queries), rare] = 1.0
    num = rng.uniform(0.8, 1.0, size=(n_queries, spec.n_numeric)).astype(np.float32)
    return q, np.concatenate([onehot, num], axis=1).astype(np.float32)
