"""The port's engine against the JAX package's at the shapes the card's scans
once refused: ``EngineConfig(k=64)``, whose stage-2 escalation asks for
k' = 32 k candidates (2048, plus the flat refine's pad of 8), and rows of
d=384, a common sentence-embedding width (several 128-column chunks of the
card's staging).

Both engines serve the same state (the JAX package builds it, the port
loads it through ``index_from_state``), on the CPU: the port's plain path,
which the card's kernels are held to bit for bit (selection path against
buffered path) and to the scan tolerance (kernel against plain version)
in ``tests/test_torch_gpu.py``. ``escalate_margin`` is set so that every
query escalates. Combined scores: atol 1e-5; ids equal outside near-ties;
PQ queries at a candidate near-tie of either stage are left out, as in
``tests/test_torch_pq_engine.py``.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import fcvi as jfcvi
from repro.serve import engine as jengine
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.index import pq
from repro_torch.kernels import fused_score_topk, ivf_score
from repro_torch.serve import engine
from test_torch_support import (assert_topk_match, candidate_ties, tensor,
                                to_numpy_tree)

TOL = dict(rtol=0.0, atol=1e-5)
BACKENDS = {"flat": {}, "ivf": dict(nlist=16, nprobe=4),
            "pq": dict(pq_m=8, pq_ksub=32, pq_coarse=8)}


def _case(n, d, backend, seed):
    corpus = make_corpus(CorpusSpec(n=n, d=d, n_categories=5, n_numeric=3,
                                    seed=seed))
    q, fq = sample_queries(corpus, 40, seed=seed + 1)
    cfg = dict(backend=backend, **BACKENDS[backend])
    jidx = jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters), jfcvi.FCVIConfig(**cfg))
    mine = fcvi.index_from_state(fcvi.FCVIConfig(**cfg),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")
    return q, fq, jidx, mine


def _pq_ties(index, q, fq, kps):
    """(b,) bool: queries at a candidate near-tie at any of ``kps``."""
    qn, fqn = index.transform.normalize(tensor(q), tensor(fq))
    q_t = index.transform.apply_normalized(qn, fqn)
    ties = np.zeros(len(q), bool)
    for kp in kps:
        ties |= candidate_ties(pq.search(index.backend, q_t, kp + 1)[0], kp)
    return ties


@pytest.mark.parametrize("backend,n,d,k", [
    ("flat", 4096, 64, 64), ("ivf", 4096, 64, 64), ("pq", 4096, 64, 64),
    ("flat", 3000, 384, 10), ("ivf", 3000, 384, 10), ("flat", 3000, 384, 64)])
def test_wide_and_large_k_engine_matches_jax(backend, n, d, k):
    q, fq, jidx, mine = _case(n, d, backend, seed=11)
    cfg = dict(k=k, escalate_margin=10.0)   # every query escalates
    engines = (jengine.FCVIEngine(jidx, jengine.EngineConfig(**cfg)),
               engine.FCVIEngine(mine, engine.EngineConfig(**cfg),
                                 device="cpu"))
    (js, ji), (s, i) = (e.search(q, fq) for e in engines)
    assert s.shape == (len(q), k) and np.isfinite(s).all()
    assert engines[1].stats.escalations == engines[0].stats.escalations \
        == len(q)
    keep = np.ones(len(q), bool)
    if backend == "pq":
        keep = ~_pq_ties(mine, q, fq, (8 * k, 32 * k))
        assert keep.sum() >= len(q) // 2
    assert_topk_match(js[keep], ji[keep], s[keep], i[keep], **TOL)


@pytest.mark.parametrize("d", [384, 960])
def test_card_plans_take_these_shapes(d):
    """The card's planners take the widths and k' these engines ask for
    (what used to raise): the stage-2 flat scan at kk=2056 on the
    selection path (its merge's buffers do not fit) for a batch of 40 and
    a sub-batch of 4, at every stored type; kk=1032 on the buffers for a
    sub-batch of 4; the IVF scan at k'=1024 on the buffered path and at
    k'=2048 and 3200 on the selection path (its merge's buffers do not fit)
    at any d and stored type, a forced fold at kp=4096 on the selection
    path."""
    for et, dtype in enumerate((torch.float32, torch.bfloat16, torch.int8)):
        assert fused_score_topk.plan(4096, 40, 2056, d, 132, et=et).select
        assert fused_score_topk.plan(4096, 4, 2056, d, 132, et=et).select
        assert not fused_score_topk.plan(4096, 4, 1032, d, 132,
                                         et=et).select
        assert not ivf_score.plan(1024, d, dtype).select
        assert ivf_score.plan(2048, d, dtype).select
        assert ivf_score.plan(3200, d, dtype).select
    assert fused_score_topk.plan(1_000_000, 64, 4096, d, 132).select
