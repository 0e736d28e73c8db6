"""Distribution-shift stability on the PyTorch/CUDA port (paper section
6.3, Table 2).

FCVI's recall holds under filter- and vector-distribution shifts WITHOUT
rebuilding the index. The same corpus, seeds and printed lines as
``examples/distribution_shift.py``.

    PYTHONPATH=src python examples/distribution_shift_torch.py [--device cpu]

Runs on the card (``--device cuda``, the default) unless asked for the CPU.
"""
import argparse

import torch

from repro_torch.core import (FCVIConfig, build, ground_truth_combined, query,
                              recall_at_k)
from repro_torch.data.synthetic import (CorpusSpec, make_corpus,
                                        sample_queries,
                                        shift_filter_distribution,
                                        shift_vector_distribution,
                                        shifted_query_pattern)
from repro_torch.device import resolve_device


def fcvi_recall(idx, q, fq, k=10):
    dev = idx.device
    qt, ft = torch.tensor(q, device=dev), torch.tensor(fq, device=dev)
    _, ids = query(idx, qt, ft, k)
    qn, fqn = idx.transform.normalize(qt, ft)
    _, ref = ground_truth_combined(idx.vectors_n, idx.filters_n, qn, fqn, k,
                                   idx.config.lam)
    return recall_at_k(ids.cpu(), ref.cpu())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    spec = CorpusSpec(n=12000, d=64, n_categories=6, n_numeric=2, seed=10)
    corpus = make_corpus(spec)
    idx = build(corpus.vectors, corpus.filters,
                FCVIConfig(alpha=1.0, lam=0.6, c=16.0), device=dev)
    q, fq = sample_queries(corpus, 48, seed=11)
    out = {"baseline": fcvi_recall(idx, q, fq)}
    print(f"baseline recall@10:            {out['baseline']:.3f}")

    sh = shift_filter_distribution(corpus)
    q2, fq2 = sample_queries(sh, 48, seed=12)
    out["filter_shift"] = fcvi_recall(idx, q2, fq2)
    print(f"after FILTER-dist shift:       {out['filter_shift']:.3f}  "
          "(index NOT rebuilt)")

    sv = shift_vector_distribution(corpus)
    q3, fq3 = sample_queries(sv, 48, seed=13)
    out["vector_shift"] = fcvi_recall(idx, q3, fq3)
    print(f"after VECTOR-dist shift:       {out['vector_shift']:.3f}")

    q4, fq4 = shifted_query_pattern(corpus, 48)
    out["query_shift"] = fcvi_recall(idx, q4, fq4)
    print(f"under shifted QUERY pattern:   {out['query_shift']:.3f}")
    print("\n(see benchmarks/table2.py for the full latency+recall protocol "
          "with pre-/post-filter baselines)")
    return out


if __name__ == "__main__":
    main()
