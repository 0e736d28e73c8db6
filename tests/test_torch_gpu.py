"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where there is no CUDA device
(decided in the ``cuda`` fixture at run time). On the card run
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``. This
file imports no JAX: the card's machine has none.

Tolerances: fused_transform rtol = atol = 1e-5, and bit for bit with the
0/1 partition fold; scan scores rtol 1e-5, atol 1e-4 with ids equal outside
near-ties (the kernel sums the dot product in another order than the plain
matmul); the carried rows and the rows variant's (scores, ids) exactly;
rescore atol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.kernels import _build, ops, ref
from repro_torch.serve.engine import EngineConfig, FCVIEngine
from test_torch_support import (assert_topk_match, cuda, normal,  # noqa: F401
                                scan_inputs, tensor, tie_inputs,
                                transform_inputs)

pytestmark = pytest.mark.gpu

L2_RTOL, L2_ATOL = 1e-5, 1e-4


@pytest.mark.parametrize("embedding", [False, True])
@pytest.mark.parametrize("n", [1, 300, 4099])
def test_fused_transform_matches_plain(cuda, embedding, n):
    v, f, proj, norms = transform_inputs(n, 64, 8, embedding)
    args = [tensor(a, cuda) for a in (v, f, proj)]
    nargs = [tensor(a, cuda) for a in norms]
    for norm_args in ([], nargs):
        got = ops.fused_transform(*args, 1.5, *norm_args)
        want = ref.ref_fused_transform(*args, 1.5, *norm_args)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if not embedding:  # the 0/1 fold is exact: bit for bit
        assert torch.equal(ops.fused_transform(*args, 1.5),
                           ref.ref_fused_transform(*args, 1.5))


@pytest.mark.parametrize("n,b,k,d", [(1000, 5, 10, 64), (1000, 5, 88, 64),
                                     (1000, 70, 300, 64), (256, 3, 256, 64),
                                     (5000, 17, 1500, 64), (3000, 2, 2048, 64),
                                     (2000, 9, 88, 128), (1000, 5, 88, 30)])
def test_score_topk_matches_plain(cuda, n, b, k, d):
    """Ragged corpus and query tiles, widths up to the 2048 limit, and a
    width d that is no multiple of 4 (the kernel's scalar staging path)."""
    x, sq, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(n, b, d=d))
    vals, ids = ops.score_topk(x, sq, q, k)
    rv, ri = ref.ref_score_topk(x, sq, q, k)
    nxt = None
    if k < n:
        nxt = ref.ref_score_topk(x, sq, q, k + 1)[0][:, -1].cpu()
    assert_topk_match(rv.cpu(), ri.cpu(), vals.cpu(), ids.cpu(),
                      rtol=L2_RTOL, atol=L2_ATOL, next_vals=nxt)
    out = ops.score_topk_rows(x, sq, pv, pf, q, k)
    assert torch.equal(out[0], vals) and torch.equal(out[1], ids)
    idx = ids.long()
    assert torch.equal(out[2], x[idx])
    assert torch.equal(out[3], pv[idx])
    assert torch.equal(out[4], pf[idx])


def test_score_topk_ties_keep_first_occurrence(cuda):
    x, sq, q = (tensor(a, cuda) for a in tie_inputs())
    vals, ids = ops.score_topk(x, sq, q, 40)
    rv, ri = ref.ref_score_topk(x, sq, q, 40)
    assert torch.equal(vals, rv) and torch.equal(ids, ri)


def test_rescore_matches_plain(cuda):
    rng = np.random.default_rng(3)
    args = [tensor(a, cuda) for a in (normal(rng, 5, 80, 64),
                                      normal(rng, 5, 80, 8),
                                      normal(rng, 5, 64), normal(rng, 5, 8))]
    torch.testing.assert_close(ops.rescore(*args, 0.6),
                               ref.ref_rescore(*args, 0.6), rtol=0, atol=1e-5)


def test_wrappers_count_launches_and_check_inputs(cuda):
    _build.reset_launch_counts()
    x, sq, q, pv, pf = (tensor(a, cuda) for a in scan_inputs(300, 3))
    ops.score_topk(x, sq, q, 10)
    ops.score_topk_rows(x, sq, pv, pf, q, 10)
    assert _build.launch_counts() == {"score_topk": 1, "score_topk_rows": 1}
    with pytest.raises(ValueError):
        ops.score_topk(x.double(), sq, q, 10)
    with pytest.raises(ValueError):
        ops.score_topk(x, sq, q, 301)
    assert _build.launch_counts() == {"score_topk": 1, "score_topk_rows": 1}


def test_engine_on_card_matches_cpu_engine(cuda):
    """The whole serving path through the kernels (delta tier and
    compaction included) against the plain path on the same state."""
    corpus = make_corpus(CorpusSpec(n=4000, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 100, seed=3)
    cfg = EngineConfig(k=10, batch_size=32, escalate_margin=0.05,
                       compact_threshold=600)
    gpu_ix = fcvi.build(corpus.vectors, corpus.filters, fcvi.FCVIConfig(),
                        device=cuda)
    cpu_ix = fcvi.index_from_state(gpu_ix.config, fcvi.index_state(gpu_ix),
                                   device="cpu")
    engines = [FCVIEngine(gpu_ix, cfg, device=cuda),
               FCVIEngine(cpu_ix, EngineConfig(**vars(cfg)), device="cpu")]
    _build.reset_launch_counts()
    rng = np.random.default_rng(4)
    new_v, new_f = normal(rng, 700, 64), corpus.filters[:700]
    for step in range(3):
        (gs, gi), (cs, ci) = (e.search(q, fq) for e in engines)
        assert_topk_match(cs, ci, gs, gi, rtol=0, atol=1e-5)
        for e in engines:
            e.insert(new_v[step * 300:(step + 1) * 300],
                     new_f[step * 300:(step + 1) * 300])
    assert engines[0].stats.compactions == engines[1].stats.compactions == 1
    assert engines[0].stats.escalations == engines[1].stats.escalations > 0
    counts = _build.launch_counts()
    for name in ("fused_transform", "score_topk_rows", "rescore"):
        assert counts.get(name, 0) > 0, counts
