"""Serving launcher: build an FCVI index over a synthetic corpus and serve
batched filtered queries through the engine (caching, adaptive k',
escalation). Mirrors ``repro.launch.serve``, with ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.serve --n 50000 --queries 512

Runs on the card (``--device cuda``, the default) unless asked for the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import FCVIConfig, build, ground_truth_combined, \
    recall_at_k
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.device import resolve_device
from repro_torch.serve.engine import EngineConfig, FCVIEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--backend", default="flat", choices=["flat", "ivf", "pq"])
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--lam", type=float, default=0.6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = CorpusSpec(n=args.n, d=args.d, n_categories=6, n_numeric=2, seed=0)
    corpus = make_corpus(spec)
    t0 = time.perf_counter()
    index = build(corpus.vectors, corpus.filters,
                  FCVIConfig(alpha=args.alpha, lam=args.lam, c=16.0,
                             backend=args.backend, nlist=128, nprobe=16),
                  device=dev)
    print(f"built fcvi-{args.backend} over {args.n} vectors "
          f"in {time.perf_counter()-t0:.1f}s on {dev}")

    engine = FCVIEngine(index, EngineConfig(k=args.k, batch_size=64),
                        device=dev)
    q, fq = sample_queries(corpus, args.queries, seed=1)

    t0 = time.perf_counter()
    _, ids = engine.search(q, fq)
    dt = time.perf_counter() - t0

    qn, fqn = index.transform.normalize(torch.tensor(q, device=dev),
                                        torch.tensor(fq, device=dev))
    _, ref = ground_truth_combined(index.vectors_n, index.filters_n, qn, fqn,
                                   args.k, args.lam)
    rec = recall_at_k(ids, ref.cpu())
    print(f"{args.queries} queries in {dt:.2f}s -> {args.queries/dt:.0f} qps, "
          f"recall@{args.k}={rec:.3f}")
    print(f"engine stats: {engine.stats.cache_hits} cache hits, "
          f"{engine.stats.escalations} escalations")

    # repeat -> cache hits
    t0 = time.perf_counter()
    engine.search(q[:128], fq[:128])
    print(f"cached re-serve of 128 queries: "
          f"{(time.perf_counter()-t0)*1e3:.0f}ms "
          f"({engine.stats.cache_hits} total cache hits)")
    return {"recall": rec, "qps": args.queries / dt,
            "cache_hits": engine.stats.cache_hits}


if __name__ == "__main__":
    main()
