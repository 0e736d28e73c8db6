"""The serving entry points of the LM slice on the CPU, against the JAX
package's: ``repro_torch.launch.serve`` (the FCVI serving launcher) and
``examples/serve_filtered_search_torch.py`` (LM-embedded documents served
over 8 shards, routed, with inserts and a checkpoint round trip).

The launcher's recall@10 must reach 0.9 and equal the reference
launcher's printed value at the same n (one result slot in 100). The
example asserts inside that routed equals dense and the restored engine
equals the saved one bit for bit; here its top-1 topic match must reach 0.9
and its embeddings, on the reference example's tokens and weights carried
across, lie within cosine 0.9999 of the reference's ``embed_docs``.
"""
import importlib.util
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"ex_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_launcher_on_the_cpu_matches_the_reference(capsys, monkeypatch):
    out = serve.main(["--device", "cpu", "--n", "2000", "--queries", "128"])
    mine = capsys.readouterr().out
    assert "on cpu" in mine and out["cache_hits"] == 128
    assert out["recall"] >= 0.9
    from repro.launch import serve as jserve
    monkeypatch.setattr(sys, "argv", ["serve", "--n", "2000",
                                      "--queries", "128"])
    jserve.main()
    ref = float(re.search(r"recall@10=(\d\.\d+)",
                          capsys.readouterr().out).group(1))
    assert out["recall"] == pytest.approx(ref, abs=0.01)


def test_serve_filtered_search_example_on_the_cpu(capsys):
    ex = _load("serve_filtered_search_torch")
    out = ex.main(["--device", "cpu"])
    lines = capsys.readouterr().out
    assert "routed == dense: OK" in lines
    assert "identical results OK" in lines
    assert "mesh: 8 shards on cpu" in lines
    assert out["topic_match"] >= 0.9
    assert out["embs"].shape == (ex.N_DOCS, 64)
    assert np.isfinite(out["scores"]).all()


def test_example_embeddings_match_the_reference_embed_docs():
    """The reference example's first 256 documents (its tokens, from its
    seed) and its weights (``PRNGKey(0)``) carried across: the port
    example's ``embed_docs`` against the reference's."""
    ref_ex = _load("serve_filtered_search")
    ex = _load("serve_filtered_search_torch")
    jcfg = jreduced(jget_config("gemma3-1b"))
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = M.params_from_jax(jax.tree.map(np.asarray, params),
                              reduced(get_config("gemma3-1b")), device="cpu")
    # the reference example's corpus, as it draws it
    r = np.random.default_rng(0)
    topics = r.integers(0, ref_ex.N_TOPICS, ref_ex.N_DOCS)
    tokens = r.integers(0, jcfg.vocab_size, (ref_ex.N_DOCS, ref_ex.SEQ)) \
        .astype(np.int32)
    tokens[:, :8] = (topics[:, None] * 17 + np.arange(8)) % jcfg.vocab_size
    mine_topics, mine_tokens = ex.topic_tokens(np.random.default_rng(0),
                                               jcfg.vocab_size, ex.N_DOCS,
                                               ex.SEQ)
    np.testing.assert_array_equal(mine_topics, topics)
    np.testing.assert_array_equal(mine_tokens, tokens)
    want = ref_ex.embed_docs(params, jcfg, jax.numpy.asarray(tokens[:256]))
    got = ex.embed_docs(model, tokens[:256])
    assert got.dtype == np.float32 and got.shape == want.shape
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) \
        / np.linalg.norm(want, axis=-1)
    assert cos.min() >= 0.9999
    # and the example's own draw: the reference's shapes, any seed's weights
    drawn = M.init_params(0, reduced(get_config("gemma3-1b")), device="cpu")
    assert M.param_count(drawn) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(params))
    assert torch.isfinite(torch.tensor(ex.embed_docs(drawn, tokens[:8]))
                          ).all()
