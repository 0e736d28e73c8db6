"""Quickstart on the PyTorch/CUDA port: build an FCVI index, run filtered
queries, compare with post-filtering. The same corpus, seeds and printed
lines as ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card (``--device cuda``, the default) unless asked for the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (BoxPredicate, FCVIConfig, build,
                              ground_truth_combined, ground_truth_filtered,
                              post_filter_search, query, recall_at_k)
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.device import resolve_device
from repro_torch.index import flat as flat_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. a corpus of vectors with filter attributes (e.g. product embeddings
    #    with [category-onehot..., price, rating])
    spec = CorpusSpec(n=20000, d=128, n_categories=6, n_numeric=2, seed=0)
    corpus = make_corpus(spec)
    print(f"corpus: {spec.n} vectors, d={spec.d}, m={spec.m} filter dims")
    v = torch.tensor(corpus.vectors, device=dev)
    f = torch.tensor(corpus.filters, device=dev)

    # 2. offline indexing (Alg. 1): psi-transform + any ANN backend
    cfg = FCVIConfig(alpha=1.0, lam=0.6, c=16.0, backend="flat")
    index = build(v, f, cfg, device=dev)

    # 3. online filtered queries: (query vector, filter target)
    q_np, fq_np = sample_queries(corpus, 32, seed=1)
    q, fq = torch.tensor(q_np, device=dev), torch.tensor(fq_np, device=dev)
    _, ids = query(index, q, fq, k=10)

    qn, fqn = index.transform.normalize(q, fq)
    _, ref = ground_truth_combined(index.vectors_n, index.filters_n, qn, fqn,
                                   10, cfg.lam)
    recall = recall_at_k(ids.cpu(), ref.cpu())
    print(f"FCVI recall@10 vs combined-score oracle: {recall:.3f}")

    # 4. compare with post-filtering under a selective CATEGORY predicate
    #    (narrow numeric ranges are the multi-probe case: see
    #    examples/multiprobe_range_filters_torch.py)
    rare = int(np.bincount(corpus.cat_labels,
                           minlength=spec.n_categories).argmin())
    lo = np.full(spec.m, -np.inf, np.float32)
    hi = np.full(spec.m, np.inf, np.float32)
    lo[rare], hi[rare] = 0.5, 1.5                    # category == rare
    pred = BoxPredicate(low=torch.tensor(lo, device=dev),
                        high=torch.tensor(hi, device=dev))
    sel = float(pred.mask(f).float().mean())
    print(f"selective category predicate: {sel:.1%} of corpus")
    raw = flat_mod.build(v)
    _, post_ids = post_filter_search(raw, f, q, pred, 10, oversample=5)
    _, pref = ground_truth_filtered(v, f, q, pred, 10)
    fq_pred = pred.to_filter_query(f)[None].expand(32, spec.m).contiguous()
    idx2 = build(v, f, FCVIConfig(alpha=2.0, lam=0.4, c=16.0), device=dev)
    _, fids = query(idx2, q, fq_pred, 10)
    post = recall_at_k(post_ids.cpu(), pref.cpu())
    fcvi_pred = recall_at_k(fids.cpu(), pref.cpu())
    print(f"selective predicate: post-filter recall={post:.3f}  "
          f"FCVI recall={fcvi_pred:.3f}")
    return {"recall": recall, "selectivity": sel, "post_recall": post,
            "fcvi_recall": fcvi_pred}


if __name__ == "__main__":
    main()
