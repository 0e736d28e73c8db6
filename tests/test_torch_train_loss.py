"""The port's ``lm_loss`` (``repro_torch.models.model``) against the
reference's on the same weights and batch, at ``reduced()`` widths: the
sequence chunking (one chunk against several, a length that is not a
multiple of the chunk), ``loss_mask``, the padded-vocab columns, the
vision prefix and the encoder; that the (b, s, V) logits never exist; and
that serving builds no autograd graph, also after a training step.

Some test modules switch autograd off at import (``torch.set_grad_enabled
(False)``), and every worker imports every module, so a gradient here is
taken under ``torch.enable_grad()``.

The loss is held to the reference's within ``LOSS_ATOL`` (see
``lm_train_support.check_loss_and_metrics``); within the port, changing
the chunking only reorders the fp32 sums (relative 1e-6)."""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from lm_train_support import (LOSS_ATOL, case, jbatch,  # noqa: E402
                              port_model, tbatch)
from repro.models import model as JM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

CHUNK_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _reference_loss(arch, seq_chunk, masked=False, **changes):
    jcfg, params, _, batch = case(arch, **changes)
    batch = dict(batch, **_mask(batch) if masked else {})
    fn = jax.jit(lambda p, b: JM.lm_loss(p, jcfg, b, seq_chunk=seq_chunk))
    loss, metrics = fn(params, jbatch(batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}


def _mask(batch):
    r = np.random.default_rng(1)
    return {"loss_mask": (r.random(batch["tokens"].shape) < 0.6)
            .astype(np.float32)}


def _port_loss(arch, seq_chunk, masked=False, **changes):
    batch = case(arch, **changes)[3]
    batch = dict(batch, **_mask(batch) if masked else {})
    with torch.no_grad():
        loss, metrics = M.lm_loss(port_model(arch, **changes), tbatch(batch),
                                  seq_chunk=seq_chunk)
    return float(loss), {k: float(v) for k, v in metrics.items()}


def _close(got, want):
    assert abs(got[0] - want[0]) <= LOSS_ATOL
    assert got[1]["tokens"] == want[1]["tokens"]
    assert abs(got[1]["logz_mean"] - want[1]["logz_mean"]) <= LOSS_ATOL


@pytest.mark.parametrize("seq_chunk", [512, 32, 8, 12])
def test_chunked_loss_matches_the_reference_and_one_chunk(seq_chunk):
    """512 and 32 are one chunk of the 32 positions; 8 is four; 12 pads
    the sequence to 36 with masked positions."""
    got = _port_loss("gemma3-1b", seq_chunk)
    _close(got, _reference_loss("gemma3-1b", seq_chunk))
    whole = _port_loss("gemma3-1b", 512)
    assert abs(got[0] - whole[0]) <= CHUNK_RTOL * abs(whole[0])
    assert got[1]["tokens"] == whole[1]["tokens"] == 2 * 31


@pytest.mark.parametrize("seq_chunk", [512, 12])
def test_loss_mask(seq_chunk):
    got = _port_loss("gemma3-1b", seq_chunk, masked=True)
    _close(got, _reference_loss("gemma3-1b", seq_chunk, masked=True))
    mask = _mask(case("gemma3-1b")[3])["loss_mask"]
    assert got[1]["tokens"] == mask[:, :-1].sum()
    assert abs(got[0] - _port_loss("gemma3-1b", 512)[0]) > 1e-3


def test_padded_vocab_columns_take_no_probability_and_no_gradient():
    """vocab 250 pads to 256: the six padded logits sit at -1e30, so log Z
    is the 250 columns' and the padded embedding rows get no gradient."""
    arch, changes = "gemma3-1b", {"vocab_size": 250}
    assert case(arch, **changes)[2].padded_vocab == 256
    for seq_chunk in (512, 12):
        _close(_port_loss(arch, seq_chunk, **changes),
               _reference_loss(arch, seq_chunk, **changes))
    model = port_model(arch, **changes)
    with torch.enable_grad():
        loss, _ = M.lm_loss(model, tbatch(case(arch, **changes)[3]),
                            seq_chunk=12)
        (g,) = torch.autograd.grad(loss, [model.embed.embedding])
    assert (g[250:] == 0).all() and (g[:250] != 0).any()


@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-large-v3"])
def test_vision_prefix_and_encoder(arch):
    """internvl2's 8 patch positions are cut off before the loss (the
    tokens count is the text's); whisper's decoder attends the encoder's
    frames. Both chunked and not."""
    for seq_chunk in (512, 12):
        got = _port_loss(arch, seq_chunk)
        _close(got, _reference_loss(arch, seq_chunk))
        assert got[1]["tokens"] == 2 * 31


def test_logits_exist_one_chunk_at_a_time():
    """Forward and backward compute the unembedding a chunk at a time:
    (b, seq_chunk, d) in, each chunk twice (the forward and its
    recomputation in the backward); never the whole sequence."""
    model = port_model("gemma3-1b")
    shapes, logits = [], M._logits

    def record(m, x):
        shapes.append(tuple(x.shape))
        return logits(m, x)

    M._logits = record
    try:
        with torch.enable_grad():
            loss, _ = M.lm_loss(model, tbatch(case("gemma3-1b")[3]),
                                seq_chunk=8)
            torch.autograd.grad(loss, list(model.parameters()))
    finally:
        M._logits = logits
    assert shapes == [(2, 8, 64)] * 8


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-large-v3",
                                  "granite-moe-3b-a800m"])
def test_serving_builds_no_graph_even_after_a_training_step(arch):
    model = port_model(arch)
    batch = tbatch(case(arch)[3])
    step = loop.make_train_step(model.cfg, opt.AdamWConfig(warmup_steps=1))
    before = model.embed.embedding.detach().clone()
    model, state, metrics = step(model, opt.init(dict(
        model.named_parameters())), batch)
    assert not torch.equal(before, model.embed.embedding)
    assert int(state.step) == 1 and np.isfinite(float(metrics["loss"]))

    def no_graph(t):
        assert t.grad_fn is None and not t.requires_grad

    no_graph(M.forward(model, batch))
    no_graph(M.forward_hidden(model, batch))
    if not model.cfg.enc_dec:       # embeds token rows alone
        no_graph(M.pooled_embedding(model, batch["tokens"]))
    prompt = {k: v[:, :16] if k == "tokens" else v for k, v in batch.items()}
    logits, cache = M.prefill(model, prompt, max_len=24)
    no_graph(logits)
    for c in cache["self"]:
        for t in c.values():
            no_graph(t)
    for kv in cache["cross"] or []:
        for t in kv:
            no_graph(t)
    logits, cache = M.decode_step(model, batch["tokens"][:, 16:17], cache)
    no_graph(logits)
    # the model's own params still take gradients
    assert all(p.requires_grad for p in model.parameters())
