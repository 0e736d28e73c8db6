"""The port's encoder-decoder (whisper-large-v3 at ``reduced()``: 2
encoder and 2 decoder layers, d = 64) against the reference on the same
numpy frames and tokens and the same weights: ``encode``, the cross keys
and values, cross attention, the cross caches, and the audio stub's
frames ahead of a decoder-only model's tokens.

Tolerances, and why (as ``tests/test_torch_lm_model.py``'s):

* each block, and each cross-attention call, fed the reference's inputs:
  bf16 outputs within 1e-2 of the row's largest magnitude plus rtol 1e-2
  (equal but for the odd ulp of a bf16 matmul summed in another order);
* the cross keys and values of the same encoder output: the same bound;
* whole passes (``encode``, the decoder over the port's own encoder
  output): row-relative error at most 1.5 times the reference's own
  distance from the same function computed without bf16 rounding;
* the zero cross caches: equal.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCH = "whisper-large-v3"
B, FRAMES, TOKENS = 2, 40, 24
BLOCK = 1e-2

torch.set_grad_enabled(False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf(x):
    return torch.tensor(_np(x)).bfloat16()


def _block_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = BLOCK * np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= scale + BLOCK * np.abs(want)).all()


def _row_rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float((np.linalg.norm(a - b, axis=-1)
                  / np.linalg.norm(b, axis=-1)).max())


@functools.lru_cache(maxsize=None)
def _case():
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = M.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    r = np.random.default_rng(0)
    frames = r.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
    tokens = r.integers(0, cfg.vocab_size, (B, TOKENS)).astype(np.int32)
    return jcfg, params, cfg, model, frames, tokens


@functools.lru_cache(maxsize=None)
def _reference_encoder():
    """The reference's input to each encoder block, and ``encode``'s
    output."""
    jcfg, params, _, _, frames, _ = _case()
    x = jnp.asarray(frames).astype(jnp.bfloat16)
    x = x + JM.sinusoidal_positions(FRAMES, jcfg.d_model)[None].astype(
        x.dtype)
    ins, enc = [], params["encoder"]
    for i in range(jcfg.n_enc_layers):
        ins.append(x)
        x, _ = JM.apply_block(jax.tree.map(lambda a: a[i], enc["scan"][0]),
                              x, jcfg, "attn", "encode")
    return ins, x, JM.encode(params, jcfg, jnp.asarray(frames))


def _unrounded(fn, model):
    """``fn(model)`` with bf16 rounding taken out (compute dtype float64;
    fp32 where the reference computes fp32)."""
    hi = copy.deepcopy(model).double()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(L, "COMPUTE_DTYPE", torch.float64)
        return fn(hi)


def test_encoder_blocks_and_encode_match_the_reference():
    jcfg, params, cfg, model, frames, _ = _case()
    ins, last, want = _reference_encoder()
    assert len(model.encoder) == cfg.n_enc_layers == 2
    for i, bp in enumerate(model.encoder):
        got, _ = M.apply_block(bp, _bf(ins[i]), cfg, "encode")
        _block_close(got, ins[i + 1] if i + 1 < len(ins) else last)
    np.testing.assert_array_equal(
        _np(model.enc_norm(_bf(last))),
        _np(JM._norm(jcfg, params["enc_norm"], last)))
    got = M.encode(model, torch.tensor(frames))
    assert got.dtype == torch.bfloat16 and got.shape == (B, FRAMES,
                                                         cfg.d_model)
    exact = _unrounded(lambda m: M.encode(m, torch.tensor(frames)), model)
    assert _row_rel(got, want) <= 1.5 * _row_rel(want, exact)


def test_encode_mode_is_not_causal():
    """Changing the last frame moves the first frame's encoding."""
    _, _, cfg, model, frames, _ = _case()
    other = frames.copy()
    other[:, -1] += 1.0
    a = M.encode(model, torch.tensor(frames))
    b = M.encode(model, torch.tensor(other))
    assert not torch.equal(a[:, 0], b[:, 0])


def test_cross_kv_and_cross_attend_match_the_reference():
    jcfg, params, cfg, model, _, tokens = _case()
    _, _, enc = _reference_encoder()
    dec = params["decoder"]
    for i, bp in enumerate(model.layers):
        jp = jax.tree.map(lambda a: a[i], dec["scan"][0])["cross"]
        jk, jv = JA.cross_kv(jp, enc)
        k, v = A.cross_kv(bp.cross, _bf(enc))
        assert k.dtype == torch.bfloat16 and k.shape == jk.shape
        _block_close(k, jk)
        _block_close(v, jv)
        x = jnp.asarray(np.random.default_rng(i).normal(
            size=(B, TOKENS, cfg.d_model)).astype(np.float32)).astype(
                jnp.bfloat16)
        want = JA.cross_attend(jp, x, jk, jv, q_chunk=jcfg.q_chunk,
                               kv_chunk=jcfg.kv_chunk)
        got = A.cross_attend(bp.cross, _bf(x), _bf(jk), _bf(jv),
                             q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        _block_close(got, want)


def test_cross_caches_match_the_reference():
    jcfg, params, cfg, model, _, _ = _case()
    _, _, enc = _reference_encoder()
    want = JM.build_cross_cache(params, jcfg, enc)
    got = M.build_cross_cache(model, _bf(enc))
    assert len(got) == cfg.n_layers
    for i, (k, v) in enumerate(got):
        jk, jv = (a[i] for a in want["scan"][0])
        _block_close(k, jk)
        _block_close(v, jv)
    zero = M.init_cross_cache(cfg, B, FRAMES, device="cpu")
    jzero = JM.init_cross_cache(jcfg, B, FRAMES)
    for i, (k, v) in enumerate(zero):
        for t, ref in ((k, jzero["scan"][0][0][i]),
                       (v, jzero["scan"][0][1][i])):
            assert t.dtype == torch.bfloat16 and t.shape == ref.shape
            assert not t.any()


def test_decoder_over_the_encoder_matches_the_reference():
    """The decoder's blocks on the reference's inputs and encoder output,
    then the whole forward from frames and tokens."""
    jcfg, params, cfg, model, frames, tokens = _case()
    _, _, enc = _reference_encoder()
    x = JM._embed_in(params, jcfg, jnp.asarray(tokens))
    dec = params["decoder"]
    for i, bp in enumerate(model.layers):
        want, _ = JM.apply_block(jax.tree.map(lambda a: a[i],
                                              dec["scan"][0]),
                                 x, jcfg, "attn", "train", enc_out=enc)
        got, _ = M.apply_block(bp, _bf(x), cfg, "train", enc_out=_bf(enc))
        _block_close(got, want)
        x = want
    batch = {"tokens": tokens, "frames": frames}
    want = JM.forward_hidden(params, jcfg, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    got = M.forward_hidden(model, tb)
    assert got.shape == (B, TOKENS, cfg.d_model)
    exact = _unrounded(lambda m: M.forward_hidden(m, tb), model)
    assert _row_rel(got, want) <= 1.5 * _row_rel(want, exact)


def test_audio_stub_frames_precede_a_decoder_only_models_tokens():
    """A decoder-only config with the audio stub (no registered arch has
    one; the reference supports it): the frames are concatenated ahead of
    the tokens in both packages, and without frames only the tokens run."""
    jcfg = dataclasses.replace(jreduced(jget_config("mistral-nemo-12b")),
                               frontend="audio_stub")
    cfg = dataclasses.replace(reduced(get_config("mistral-nemo-12b")),
                              frontend="audio_stub")
    params = JM.init_params(jax.random.PRNGKey(1), jcfg)
    model = M.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    r = np.random.default_rng(1)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (B, 12)).astype(
        np.int32),
        "frames": r.normal(size=(B, 6, cfg.d_model)).astype(np.float32)}
    for b in (batch, {"tokens": batch["tokens"]}):
        want = JM.forward_hidden(params, jcfg, {k: jnp.asarray(v)
                                                for k, v in b.items()})
        tb = {k: torch.tensor(v) for k, v in b.items()}
        got = M.forward_hidden(model, tb)
        assert got.shape == want.shape
        exact = _unrounded(lambda m: M.forward_hidden(m, tb), model)
        assert _row_rel(got, want) <= 1.5 * _row_rel(want, exact)
