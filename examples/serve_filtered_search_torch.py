"""End-to-end serving on the PyTorch/CUDA port: LM-embedded documents ->
an FCVI engine over 8 shards with filter-routed serving -> batched filtered
queries -> live inserts -> checkpoint save/restore. The same corpus, seeds
and steps as ``examples/serve_filtered_search.py``.

A gemma3-family model with weights drawn from a seed embeds token
sequences (the mean-pooled fp32 final hidden state); documents carry filter
attributes (topic one-hot + recency). The engine serves over 8 shards of
``make_host_mesh`` (on one card they all share it) with filter-centric
(cluster) placement and ``routing="routed"``: shards holding none of a
query's psi-clusters skip their scan, and a query the router cannot certify
is re-run dense, so routed results equal dense ones bit for bit. The engine
state then round-trips through a checkpoint (``engine.save`` ->
``FCVIEngine.restore``).

    PYTHONPATH=src python examples/serve_filtered_search_torch.py \
        [--device cpu] [--arch-width reduced|full]

Runs on the card (``--device cuda``, the default) unless asked for the CPU.
``--arch-width reduced`` (the default) is the reference example's reduced
gemma3; ``full`` is gemma-3-1b at its published widths (26 layers,
d_model 1152, vocab 262144: about 1.0 B parameters, 4 GB in fp32).
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core import FCVIConfig, build
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.serve.engine import EngineConfig, FCVIEngine

N_DOCS, SEQ, N_TOPICS = 2048, 32, 6
SHARDS = 8


def embed_docs(model, tokens) -> np.ndarray:
    """Mean-pooled fp32 final hidden state as the document embedding."""
    return M.pooled_embedding(model, tokens, batch_size=256).cpu().numpy()


def topic_tokens(r, vocab: int, n_docs: int, seq: int):
    """Synthetic "documents": token rows whose leading block of 8 encodes
    the topic, so embeddings cluster by topic. Returns (topics, tokens)."""
    topics = r.integers(0, N_TOPICS, n_docs)
    tokens = r.integers(0, vocab, (n_docs, seq)).astype(np.int32)
    tokens[:, :8] = (topics[:, None] * 17 + np.arange(8)) % vocab
    return topics, tokens


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch-width", default="reduced",
                    choices=["reduced", "full"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gemma3-1b")
    if args.arch_width == "reduced":
        cfg = reduced(cfg)
    model = M.init_params(0, cfg, device=dev)
    print(f"embedder: {args.arch_width} {cfg.name} "
          f"({M.param_count(model):,} params) on {dev}")

    r = np.random.default_rng(0)
    topics, tokens = topic_tokens(r, cfg.vocab_size, N_DOCS, SEQ)
    t0 = time.perf_counter()
    embs = embed_docs(model, tokens)
    print(f"embedded {N_DOCS} docs in {time.perf_counter()-t0:.1f}s "
          f"-> d={embs.shape[1]}")

    onehot = np.zeros((N_DOCS, N_TOPICS), np.float32)
    onehot[np.arange(N_DOCS), topics] = 1.0
    recency = r.uniform(0, 1, (N_DOCS, 2)).astype(np.float32)
    filters = np.concatenate([onehot, recency], axis=1)

    # offline build: psi-transform (a strong filter fold makes filtered
    # queries geometrically local) + the flat backend
    index = build(embs, filters, FCVIConfig(alpha=2.0, lam=0.5, c=8.0),
                  device=dev)

    # sharded, filter-routed serving: cluster placement packs whole
    # psi-clusters a shard; routing="routed" skips the shards the router
    # does not activate for a batch (the dense fallback keeps it exact)
    mesh = make_host_mesh(dev, n_shards=SHARDS)
    print(f"mesh: {SHARDS} shards on {dev}, placement=cluster "
          f"routing=routed")
    engine = FCVIEngine(index, EngineConfig(k=5, batch_size=32), device=dev,
                        mesh=mesh, placement="cluster", routing="routed")

    # batched serving: the docs' own embeddings + topic filters, selective
    # filtered traffic, what routing exploits
    q_ids = r.integers(0, N_DOCS, 128)
    queries = embs[q_ids] + 0.05 * r.normal(
        size=(128, embs.shape[1])).astype(np.float32)
    fq = filters[q_ids]
    t0 = time.perf_counter()
    scores, ids = engine.search(queries, fq)
    dt = time.perf_counter() - t0
    topic_match = float((topics[ids[:, 0]] == topics[q_ids]).mean())
    st = engine.stats
    print(f"served 128 queries in {dt*1e3:.0f}ms ({128/dt:.0f} qps), "
          f"top-1 topic match: {topic_match:.2%}")
    print(f"router: {st.shard_skip_rate:.0%} of shard scans skipped, "
          f"{st.router_fallbacks} dense fallbacks, "
          f"{st.escalations} escalations")

    # the routing knob never changes results: a dense engine over the same
    # index returns bit-identical scores and ids
    dense = FCVIEngine(index, EngineConfig(k=5, batch_size=32), device=dev,
                       mesh=mesh, placement="cluster", routing="dense")
    ds, di = dense.search(queries, fq)
    assert (ds == scores).all() and (di == ids).all()
    print("routed == dense: OK")

    # live inserts through the delta buffer
    engine.insert(embs[:64] + 0.01, filters[:64])
    engine.search(queries[:16], fq[:16])
    print(f"after insert: delta={engine.delta_size()} rows, "
          f"stats: {st.queries} queries, {st.cache_hits} cache hits")

    # checkpoint lifecycle: save (router tables included) -> restore onto
    # the same mesh -> identical results, identical routing
    with tempfile.TemporaryDirectory() as ckpt_dir:
        engine.save(ckpt_dir, step=1)
        restored = FCVIEngine.restore(ckpt_dir, device=dev, mesh=mesh)
        engine._cache.clear()
        s0, i0 = engine.search(queries[:32], fq[:32])
        s1, i1 = restored.search(queries[:32], fq[:32])
        assert (s0 == s1).all() and (i0 == i1).all()
        print(f"checkpoint restore (routing={restored._routing!r}): "
              f"identical results OK")
    return {"topic_match": topic_match, "qps": 128 / dt, "scores": scores,
            "ids": ids, "embs": embs, "tokens": tokens}


if __name__ == "__main__":
    main()
