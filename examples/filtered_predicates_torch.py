"""Predicate-filtered search on the PyTorch/CUDA port: the filter algebra
and the selectivity-aware planner, on one engine and on 8 shards. The same
catalog, seeds and printed lines as ``examples/filtered_predicates.py``.

Builds an FCVI index over a synthetic product catalog whose rows carry RAW
attribute columns (price, stock, two category one-hots) and serves
composable predicates through ``engine.search(q, filter=...)``:

  * ``F.range / F.eq / F.isin`` combined with ``&`` into conjunctions;
  * the planner picks a physical plan per query from per-column
    selectivity statistics: psi ``fold`` for broad single-attribute
    predicates, in-kernel ``mask`` as the safe default, ``routed`` list or
    shard pruning for selective ones;
  * every plan is EXACT: forcing each capable plan returns the same
    scores and ids, and an engine sharded over 8 mesh positions
    (``make_host_mesh``; on one card they all share it) matches the
    meshless one;
  * a predicate matching nothing returns certified-empty ``(-inf, -1)``
    rows.

    PYTHONPATH=src python examples/filtered_predicates_torch.py [--device cpu]

Runs on the card (``--device cuda``, the default) unless asked for the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import FCVIConfig, build
from repro_torch.core.filters import F, compile_predicate
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.engine import EngineConfig, FCVIEngine

N, D = 4096, 32
NAMES = ("price", "stock", "cat_a", "cat_b")
SHARDS = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    out = {"est_sel": [], "plans": [], "top": []}

    r = np.random.default_rng(0)
    vectors = r.normal(size=(N, D)).astype(np.float32)
    # raw attribute columns: price in [0, 100), stock in [0, 1), two
    # category one-hots (the table feeds both predicate evaluation and the
    # fold plan's psi target, so it has m = 4 columns like the index filters)
    cat = r.integers(0, 2, N)
    attrs = np.stack([r.uniform(0, 100, N), r.uniform(0, 1, N),
                      (cat == 0).astype(np.float32),
                      (cat == 1).astype(np.float32)], axis=1).astype(np.float32)

    v, a = torch.tensor(vectors, device=dev), torch.tensor(attrs, device=dev)
    index = build(v, a, FCVIConfig(alpha=1.0, lam=0.6, c=8.0, backend="ivf",
                                   nlist=16, nprobe=8), device=dev)
    engine = FCVIEngine(index, EngineConfig(k=5, batch_size=32), device=dev,
                        attributes=attrs, attr_names=NAMES)
    q = r.normal(size=(16, D)).astype(np.float32)

    # the planner maps selectivity bands to plans; predicate bounds are data
    preds = [
        ("broad price band", F.range("price", 5.0, 95.0)),
        ("mid conjunction", F.range("price", 20.0, 60.0) & F.eq("cat_a", 1.0)),
        ("narrow corner", F.range("price", 0.0, 3.0) & F.range("stock", 0.0, 0.4)),
    ]
    for label, pred in preds:
        cp = compile_predicate(pred, NAMES)
        plan = engine.planner.choose(cp)
        sel = engine.planner.selectivity(cp)
        scores, ids = engine.search(q, filter=pred)
        n_hits = int((ids[0] >= 0).sum())
        print(f"{label:18s} est_sel={sel:0.3f} plan={plan:6s} "
              f"top-{n_hits} ids={ids[0][:3].tolist()}")
        out["est_sel"].append(sel)
        out["plans"].append(plan)
        out["top"].append(ids[0][:3].tolist())
        # exactness: every row returned satisfies the predicate
        live = ids[ids >= 0]
        assert bool(cp.eval_np(attrs[live]).all())

    # the plan is a performance knob: every capable plan, the same bits
    pred = F.range("price", 0.0, 10.0)
    base = engine.search(q, filter=pred)
    for plan in ("mask", "routed"):
        s, i = engine.search(q, filter=pred, plan=plan)
        assert (s == base[0]).all() and (i == base[1]).all()
    print("forced mask == routed == planner choice: OK")

    # the fold plan (the paper's psi transform carrying the predicate) needs
    # the flat fp32 scan: on a flat engine the broad band folds instead
    flat_idx = build(v, a, FCVIConfig(alpha=1.0, lam=0.6, c=8.0,
                                      backend="flat"), device=dev)
    flat_eng = FCVIEngine(flat_idx, EngineConfig(k=5, batch_size=32),
                          device=dev, attributes=attrs, attr_names=NAMES)
    cp = compile_predicate(preds[0][1], NAMES)
    sf, if_ = flat_eng.search(q, filter=preds[0][1])
    sm, im = flat_eng.search(q, filter=preds[0][1], plan="mask")
    assert flat_eng.planner.choose(cp) == "fold"
    assert (sf == sm).all() and (if_ == im).all()
    print(f"flat engine: broad band folds (plan="
          f"{flat_eng.planner.choose(cp)}), fold == mask bitwise: OK")

    # zero-match predicates return certified-empty rows, not id-0 garbage
    s, i = engine.search(q, filter=F.range("price", 1000.0, 2000.0))
    assert (i == -1).all() and np.isneginf(s).all()
    print("zero-match predicate -> certified empty: OK")

    # sharded serving answers the same predicates bit for bit; the routed
    # plan skips the shards that hold no eligible row
    mesh = make_host_mesh(dev, n_shards=SHARDS)
    for e, placement in ((engine, "balanced"), (flat_eng, "cluster")):
        sharded = FCVIEngine(e.index, EngineConfig(k=5, batch_size=32),
                             device=dev, mesh=mesh, placement=placement,
                             attributes=attrs, attr_names=NAMES)
        for _, pred in preds:
            s0, i0 = e.search(q, filter=pred)
            s1, i1 = sharded.search(q, filter=pred)
            assert (s0 == s1).all() and (i0 == i1).all()
    print(f"sharded ({sharded._sharded.n_shards} shards on {mesh.size} mesh "
          f"positions) == meshless: OK")

    # live inserts are predicate-checked against their insert attributes
    engine.insert(vectors[:8] + 0.01, attrs[:8])
    engine.search(q, filter=preds[0][1])
    st = engine.stats
    print(f"stats: {st.filtered_queries} filtered queries, plans "
          f"fold={st.plan_fold} mask={st.plan_mask} routed={st.plan_routed}, "
          f"{st.filtered_fallbacks} fold fallbacks")
    out["stats"] = (st.filtered_queries, st.plan_fold, st.plan_mask,
                    st.plan_routed, st.filtered_fallbacks)
    return out


if __name__ == "__main__":
    main()
