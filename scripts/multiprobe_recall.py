#!/usr/bin/env python3
"""Recall@10 of FCVI multi-probe + verify against the filtered ground
truth, as the corpus grows: the flow of
``examples/multiprobe_range_filters_torch.py`` (k=200 multi-probe
candidates at r=4, the predicate, exact distance) on ``chip_smoke.py``'s
corpus shape (d=128, 6 Zipf categories + 2 numeric attributes, seed 0),
every ``FCVIConfig`` default, 64 queries, ``f7`` in [0.3, 0.7].

Two probe encodings: the reference's (``BoxPredicate.probes``: the box
from its low to its high corner, 0 in unconstrained columns) and the
unconstrained columns at the corpus mean (``to_filter_query``'s neutral
value). Recall is a count, not a device metric: any device gives it.

    PYTHONPATH=src python3 scripts/multiprobe_recall.py --n 12000 100000 \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import baselines, fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import topk_first


def recall(n: int, dev) -> dict:
    c = make_corpus(CorpusSpec(n=n, d=128, n_categories=6, n_numeric=2,
                               seed=0))
    q, _ = sample_queries(c, 64, seed=1)
    v, f = (torch.tensor(a, device=dev) for a in (c.vectors, c.filters))
    qt = torch.tensor(q, device=dev)
    ix = fcvi.build(v, f, fcvi.FCVIConfig(), device=dev)
    low = torch.full((8,), -float("inf"), device=dev)
    high = torch.full((8,), float("inf"), device=dev)
    low[7], high[7] = 0.3, 0.7
    pred = baselines.BoxPredicate(low=low, high=high)
    _, truth = baselines.ground_truth_filtered(v, f, qt, pred, 10)

    def verify(probes):
        _, cids = fcvi.multi_probe_query(ix, qt, probes[None].expand(
            64, *probes.shape), 200)
        rows = cids.long()
        d2 = torch.sum((v[rows] - qt[:, None]) ** 2, dim=-1)
        vs = torch.where(pred.mask(f[rows]), -d2, float("-inf"))
        _, pos = topk_first(vs, 10)
        return fcvi.recall_at_k(torch.gather(cids, -1, pos).cpu(),
                                truth.cpu())

    probes = pred.probes(4)
    at_mean = torch.where(torch.isfinite(low) | torch.isfinite(high), probes,
                          f.mean(dim=0))
    return {"reference": verify(probes), "mean": verify(at_mean)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[12000, 100000])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for n in args.n:
        r = recall(n, dev)
        print(f"n={n}: recall@10 {r['reference']:.4f} with the reference's "
              f"probes, {r['mean']:.4f} with the unconstrained columns at "
              f"the corpus mean ({dev.type})")


if __name__ == "__main__":
    main()
