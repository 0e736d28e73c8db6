"""The decoder LMs of the port (``repro_torch.models.model``,
``repro_torch.configs``) against the JAX package's on the same numpy inputs
and the same weights, carried across by ``params_from_jax``.

All ten archs run at ``reduced()``: the five dense decoders (gemma3-1b,
gemma2-27b, mistral-nemo-12b, starcoder2-7b, internvl2-26b), the MoE
decoders (granite-moe-3b-a800m, dbrx-132b), the recurrent ones
(recurrentgemma-2b: RG-LRU and local attention; xlstm-125m: mLSTM and
sLSTM, no attention) and the encoder-decoder whisper-large-v3 (its batch
carries the audio stub's frames). The MoE archs serve at
``moe_capacity_factor=8.0`` (nothing dropped), as the reference's own
serving test does; their forward runs at the default 1.25 (the MoE
module's own tests hold the dropped set at 1.25 and 0.5).

Tolerances, and why:

* each block fed the reference's input to that block: bf16 outputs at
  rtol 1e-2 and atol 1e-2 of the row's largest magnitude (in practice equal
  but for the odd ulp; where the residual sum cancels, the result keeps
  the ulp of its larger terms);
* the logits of the same final hidden state: max |diff| <= 0.05;
* the caches' integer state after prefill and after each decode step: bit
  for bit; the KV caches' bf16 keys within 5% of the reference's norm, the
  recurrent states (fp32) and the cross caches likewise;
* end to end (every block fed its own input): the two packages round the
  same ops, but each bf16 matmul sums its fp32 products in its own order,
  so about 1 element in 5,000 lands one ulp apart (the port's is the
  correctly rounded one where we looked), and the random-weight stacks
  amplify such flips: one ulp in one weight moves the reference's own
  logits by up to 0.05. So the port's final hidden states are held to the
  reference as closely as the reference lies to the same function computed
  without bf16 rounding (row-relative error at most 1.5 times that), the
  mean-pooled embeddings to cosine >= 0.9999, and the logits to 0.15, the
  reference's own bound between two computations of the same logits
  (``tests/test_models.py``'s decode drift).
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
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, list_archs, reduced  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

DENSE = ["gemma3-1b", "gemma2-27b", "mistral-nemo-12b", "starcoder2-7b",
         "internvl2-26b", "granite-moe-3b-a800m", "dbrx-132b",
         "recurrentgemma-2b", "xlstm-125m", "whisper-large-v3"]
# refused until the MoE, recurrent and encoder-decoder blocks were ported
UNPORTED = {"recurrentgemma-2b": "A13c", "xlstm-125m": "A13c",
            "granite-moe-3b-a800m": "A13b", "dbrx-132b": "A13b",
            "whisper-large-v3": "A13d"}
FRAMES = 16                  # the encoder-decoder's audio-stub frames
RTOL = ATOL = 1e-2
LOGITS_SAME_INPUT = 0.05
LOGITS = 0.15                # the reference's decode drift bound
COS = 0.9999
PREFILL, STEPS = 136, 7      # past the 128-slot local caches


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _case(arch, pos_kind=None, serve=False):
    """(JAX cfg, its params, the port's cfg, the port's model with the same
    weights, a numpy batch from a seed). ``serve``: MoE at capacity 8.0."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    changes = {}
    if pos_kind is not None:
        changes["pos_kind"] = pos_kind
    if serve and cfg.is_moe:
        changes["moe_capacity_factor"] = 8.0
    jcfg = dataclasses.replace(jcfg, **changes)
    cfg = dataclasses.replace(cfg, **changes)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = M.params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    r = np.random.default_rng(0)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (2, PREFILL + STEPS))
             .astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = r.normal(size=(2, cfg.n_prefix, cfg.d_model)) \
            .astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = r.normal(size=(2, FRAMES, cfg.d_model)) \
            .astype(np.float32)
    return jcfg, params, cfg, model, batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# -- configs -----------------------------------------------------------------

def test_list_archs_and_every_config_equal_the_reference():
    assert list_archs() == jlist_archs()
    assert len(list_archs()) == 10
    for arch in list_archs():
        for mine, ref in ((get_config(arch), jget_config(arch)),
                          (reduced(get_config(arch)),
                           jreduced(jget_config(arch)))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
            for prop in ("padded_vocab", "period", "n_periods", "rest_kinds",
                         "is_moe"):
                assert getattr(mine, prop) == getattr(ref, prop)
            assert mine.layer_kinds() == ref.layer_kinds()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


@pytest.mark.parametrize("arch", DENSE)
def test_full_config_parameter_counts_on_meta(arch):
    """The published widths, counted without memory, equal the reference's
    ``jax.eval_shape`` count; the shapes match name by name."""
    model = M.init_params(0, get_config(arch), device="meta")
    jcfg = jget_config(arch)
    sds = jax.eval_shape(functools.partial(JM.init_params, cfg=jcfg),
                         jax.random.PRNGKey(0))
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(sds))
    assert M.param_count(model) == want
    assert model.embed.embedding.shape == (jcfg.padded_vocab, jcfg.d_model)
    assert len(model.layers) == jcfg.n_layers
    if arch == "gemma3-1b":
        assert 0.99e9 < want < 1.01e9


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_archs_raise_naming_their_roadmap_item(arch):
    """The five archs the port refused before MoE (A13b), the recurrent
    blocks (A13c) and the encoder-decoder (A13d) now construct and run:
    the published config on the meta device counts the reference's
    parameters; at ``reduced()`` the forward gives finite logits of the
    reference's shape, and prefill + decode steps run and stay within the
    reference's drift bound of the reference's own logits."""
    cfg = get_config(arch)
    sds = jax.eval_shape(functools.partial(JM.init_params,
                                           cfg=jget_config(arch)),
                         jax.random.PRNGKey(0))
    assert M.param_count(M.Model(cfg, device="meta")) == sum(
        int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(sds))
    jcfg, params, cfg, model, batch = _case(arch)
    logits = M.forward(model, _tbatch(batch))
    assert logits.shape == jax.eval_shape(
        lambda p, b: JM.forward(p, jcfg, b), params, _jbatch(batch)).shape
    assert bool(torch.isfinite(logits).all())
    assert len(M.init_cache(cfg, 1, 16, device="cpu")) == cfg.n_layers
    mine, ref, _ = _serve_both(arch)
    for m, r in zip(mine, ref):
        assert np.isfinite(m).all() and np.abs(m - r).max() <= LOGITS


def test_unknown_block_kind_and_mode_raise():
    cfg = dataclasses.replace(reduced(get_config("mistral-nemo-12b")),
                              pattern=("conv",))
    with pytest.raises(ValueError, match="unknown block kind"):
        M.Model(cfg, device="meta")
    _, _, cfg, model, _ = _case("mistral-nemo-12b")
    x = torch.zeros(1, 4, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown mode"):
        M.apply_block(model.layers[0], x, cfg, "score")
    with pytest.raises(ValueError, match="unknown block kind"):
        M._block_cache(cfg, "conv", 1, 16, "cpu")


# -- weights -----------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_unstacks_periods_in_layer_order(arch):
    """decoder.scan[j]'s leaf p -> layer p * period + j; decoder.rest[i] ->
    layer n_periods * period + i; every leaf bit for bit."""
    jcfg, params, cfg, model, _ = _case(arch)
    dec = params["decoder"]
    flat = jax.tree_util.tree_flatten_with_path
    for i in range(cfg.n_layers):
        p, j = divmod(i, cfg.period)
        if p < cfg.n_periods:
            bp = jax.tree.map(lambda a: a[p], dec["scan"][j])
        else:
            bp = dec["rest"][i - cfg.n_periods * cfg.period]
        mine = model.layers[i].state_dict()
        leaves = {".".join(k.key for k in path): v
                  for path, v in flat(bp)[0]}
        assert set(mine) == set(leaves)
        for name, v in leaves.items():
            np.testing.assert_array_equal(mine[name].numpy(), np.asarray(v))
        assert model.layers[i].kind == jcfg.layer_kinds()[i]
    np.testing.assert_array_equal(model.embed.embedding.detach().numpy(),
                                  np.asarray(params["embed"]["embedding"]))
    assert hasattr(model, "unembed") == ("unembed" in params)
    assert hasattr(model, "encoder") == ("encoder" in params)
    if cfg.enc_dec:
        enc = params["encoder"]
        for i, bp in enumerate(model.encoder):
            want = jax.tree.map(lambda a: a[i], enc["scan"][0])
            leaves = {".".join(k.key for k in path): v
                      for path, v in flat(want)[0]}
            mine = bp.state_dict()
            assert set(mine) == set(leaves)
            for name, v in leaves.items():
                np.testing.assert_array_equal(mine[name].numpy(),
                                              np.asarray(v))
        np.testing.assert_array_equal(
            model.enc_norm.scale.detach().numpy(),
            np.asarray(params["enc_norm"]["scale"]))


def test_init_params_draws_the_reference_shapes_and_stds():
    cfg = reduced(get_config("gemma2-27b"))
    a = M.init_params(0, cfg, device="cpu")
    b = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    c = M.init_params(1, cfg, device="cpu")
    ref = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                  jreduced(jget_config(
                                                      "gemma2-27b"))))
    carried = M.params_from_jax(ref, cfg, device="cpu").state_dict()
    for name, p in a.state_dict().items():
        assert torch.equal(p, b.state_dict()[name])
        want = carried[name]
        assert p.shape == want.shape and p.dtype == torch.float32
        if float(want.std()) == 0:    # norms: zeros (rms) as the reference
            assert torch.equal(p, want)
        else:
            assert not torch.equal(p, c.state_dict()[name])
            assert float(p.std()) == pytest.approx(float(want.std()),
                                                   rel=0.15)


# -- forward -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_hidden(arch):
    """The reference's input to each block and its final hidden state on
    ``_case(arch)``'s batch, block by block."""
    jcfg, params, _, _, batch = _case(arch)
    return _reference_stack(jcfg, params, _jbatch(batch))


def _reference_stack(jcfg, params, jb):
    """The reference's input to each block and its final hidden state (for
    the encoder-decoder, over the reference's ``encode`` output)."""
    x = JM._embed_in(params, jcfg, jb["tokens"])
    enc = JM.encode(params, jcfg, jb["frames"]) if jcfg.enc_dec else None
    if jcfg.frontend == "vision_stub":
        x = jnp.concatenate([jb["patches"].astype(jnp.bfloat16), x], axis=1)
    dec, ins = params["decoder"], []
    for i, kind in enumerate(jcfg.layer_kinds()):
        p, j = divmod(i, jcfg.period)
        bp = (jax.tree.map(lambda a: a[p], dec["scan"][j])
              if p < jcfg.n_periods
              else dec["rest"][i - jcfg.n_periods * jcfg.period])
        ins.append(x)
        x, _ = JM.apply_block(bp, x, jcfg, kind, "train", enc_out=enc)
    return ins, x


@pytest.mark.parametrize("arch", DENSE)
def test_blocks_match_the_reference_on_its_inputs(arch):
    jcfg, params, cfg, model, batch = _case(arch)
    ins, last = _reference_hidden(arch)
    enc = None
    if cfg.enc_dec:
        enc = torch.tensor(_np(JM.encode(params, jcfg, jnp.asarray(
            batch["frames"])))).bfloat16()
    with torch.no_grad():
        emb = M._with_prefix(model, M._embed_in(model, torch.tensor(
            batch["tokens"])), _tbatch(batch))
        np.testing.assert_array_equal(_np(emb), _np(ins[0]))
        for i, bp in enumerate(model.layers):
            x = torch.tensor(_np(ins[i])).bfloat16()
            got, _ = M.apply_block(bp, x, cfg, "train", enc_out=enc)
            want = _np(ins[i + 1] if i + 1 < len(ins) else last)
            scale = ATOL * np.abs(want).max(axis=-1, keepdims=True)
            assert (np.abs(_np(got) - want) <= scale + RTOL * np.abs(want)
                    ).all(), f"layer {i}"
        # the logits of the reference's final hidden state
        got = M._logits(model, torch.tensor(_np(last)).bfloat16())
    want = JM._logits(params, jcfg, last)
    assert np.abs(_np(got) - _np(want)).max() <= LOGITS_SAME_INPUT


def _unrounded_hidden(model, batch, monkeypatch):
    """The port's forward with bf16 rounding taken out (compute dtype
    float64; fp32 where the reference computes fp32)."""
    hi = copy.deepcopy(model).double()
    with monkeypatch.context() as m:
        m.setattr(L, "COMPUTE_DTYPE", torch.float64)
        out = M.forward_hidden(hi, batch)
    assert out.dtype == torch.float64
    return out.numpy()


def _row_rel(a, b):
    return float((np.linalg.norm(a - b, axis=-1)
                  / np.linalg.norm(b, axis=-1)).max())


@pytest.mark.parametrize("arch", DENSE)
def test_forward_hidden_and_forward_end_to_end(arch, monkeypatch):
    jcfg, params, cfg, model, batch = _case(arch)
    want = _np(_reference_hidden(arch)[1])
    got = M.forward_hidden(model, _tbatch(batch))
    prefix = cfg.n_prefix if cfg.frontend == "vision_stub" else 0
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, prefix + PREFILL + STEPS, cfg.d_model)
    got = _np(got)
    exact = _unrounded_hidden(model, _tbatch(batch), monkeypatch)
    floor = _row_rel(want, exact)
    assert _row_rel(got, want) <= 1.5 * floor, (_row_rel(got, want), floor)
    e1, e2 = got.mean(axis=1), want.mean(axis=1)
    cos = (e1 * e2).sum(-1) / np.linalg.norm(e1, axis=-1) \
        / np.linalg.norm(e2, axis=-1)
    assert cos.min() >= COS
    logits = M.forward(model, _tbatch(batch))
    assert logits.dtype == torch.float32
    assert logits.shape == (2, prefix + PREFILL + STEPS, cfg.padded_vocab)
    jlogits = JM._logits(params, jcfg, jnp.asarray(want).astype(jnp.bfloat16))
    assert np.abs(_np(logits) - _np(jlogits)).max() <= LOGITS


# -- serving -----------------------------------------------------------------

def _layer_caches(jcfg, cache):
    """The reference's cache (stacked by pattern slot) as a list in layer
    order."""
    sc, out = cache["self"], []
    for i in range(jcfg.n_layers):
        p, j = divmod(i, jcfg.period)
        out.append(jax.tree.map(lambda a: a[p], sc["scan"][j])
                   if p < jcfg.n_periods
                   else sc["rest"][i - jcfg.n_periods * jcfg.period])
    return out


def _near(a, b, share=0.05):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    assert np.linalg.norm(a - b) <= share * max(np.linalg.norm(b), 1e-30)


def _same_cache_state(mine, ref, jcfg):
    cross = ref["cross"]
    ref = _layer_caches(jcfg, ref)
    assert len(mine["self"]) == len(ref)
    assert (mine["cross"] is None) == (cross is None)
    if cross is not None:
        for i, kv in enumerate(mine["cross"]):
            for t, r in zip(kv, cross["scan"][0]):
                assert t.dtype == torch.bfloat16
                _near(t, r[i])
    for kind, c, r in zip(jcfg.layer_kinds(), mine["self"], ref):
        assert set(c) == set(r)
        if kind not in ("attn", "local"):
            # the recurrent state: fp32 (RG-LRU's conv history bf16)
            for name in r:
                assert c[name].dtype == (torch.bfloat16 if name == "conv"
                                         else torch.float32)
                _near(c[name], r[name])
            continue
        np.testing.assert_array_equal(c["slot_pos"].numpy(),
                                      np.asarray(r["slot_pos"]))
        assert c["slot_pos"].dtype == torch.int32
        assert c["pos"].dtype == torch.int32 and int(c["pos"]) == int(
            r["pos"])
        assert c["k"].shape == r["k"].shape and c["k"].dtype == torch.bfloat16
        k, rk = _np(c["k"]), _np(r["k"])
        assert np.linalg.norm(k - rk) <= 0.05 * np.linalg.norm(rk)


@functools.lru_cache(maxsize=None)
def _serve_both(arch, pos_kind=None):
    """Prefill and decode in both packages; returns per position (the
    port's logits, the reference's, the port's teacher-forced forward's)."""
    jcfg, params, cfg, model, batch = _case(arch, pos_kind, serve=True)
    tokens = batch["tokens"]
    prefix = cfg.n_prefix if cfg.frontend == "vision_stub" else 0
    max_len = prefix + PREFILL + STEPS      # the global caches never wrap
    pb = dict(batch, tokens=tokens[:, :PREFILL])
    jprefill = jax.jit(lambda p, b: JM.prefill(p, jcfg, b, max_len))
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(p, jcfg, t, c))
    lp, cache = M.prefill(model, _tbatch(pb), max_len)
    jlp, jcache = jprefill(params, _jbatch(pb))
    _same_cache_state(cache, jcache, jcfg)
    mine, ref = [lp[:, 0]], [jlp[:, 0]]
    for t in range(PREFILL, PREFILL + STEPS - 1):
        lg, cache = M.decode_step(model, torch.tensor(tokens[:, t:t + 1]),
                                  cache)
        jlg, jcache = jdecode(params, jnp.asarray(tokens[:, t:t + 1]), jcache)
        _same_cache_state(cache, jcache, jcfg)
        mine.append(lg[:, 0])
        ref.append(jlg[:, 0])
    full = M.forward(model, _tbatch(batch))[:, prefix + PREFILL - 1:-1]
    return ([_np(m) for m in mine], [_np(r) for r in ref],
            [_np(full[:, i]) for i in range(full.shape[1])])


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference(arch):
    """Prefill past the local caches' 128 slots (they roll), then decode
    steps: the caches' integer state equals the reference's at every step,
    each step's logits lie within the reference's drift bound of its own,
    and the port's decode reproduces its teacher-forced forward (< 0.15,
    the reference test's serving-consistency bound)."""
    mine, ref, full = _serve_both(arch)
    assert len(mine) == STEPS
    for m, r in zip(mine, ref):
        assert m.shape == r.shape and np.isfinite(m).all()
        assert np.abs(m - r).max() <= LOGITS
    drift = max(float(np.abs(m - f).max()) for m, f in zip(mine, full))
    assert drift < LOGITS, f"decode drift {drift}"


def test_sinusoidal_positions_in_forward_and_decode():
    """A config with sinusoidal positions (no dense arch has one; the
    reference supports it): the decode step's position comes from the
    cache."""
    mine, ref, full = _serve_both("starcoder2-7b", pos_kind="sinusoidal")
    for m, r, f in zip(mine, ref, full):
        assert np.abs(m - r).max() <= LOGITS
        assert np.abs(m - f).max() < LOGITS


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_decode_position_without_attention_in_layer_0(arch):
    """The decode step's position is the first attention layer's cache's
    (recurrentgemma's pattern starts rec, rec, local), or 0 where no layer
    attends (xlstm), as the reference's ``_cache_pos``: with sinusoidal
    positions switched on, the port's decode logits follow the
    reference's."""
    jcfg, _, cfg, _, _ = _case(arch, "sinusoidal", serve=True)
    caches = M.init_cache(cfg, 2, 32, device="cpu")
    kinds = cfg.layer_kinds()
    assert kinds[0] not in ("attn", "local")
    for i, kind in enumerate(kinds):
        if kind in ("attn", "local"):
            caches[i]["pos"] = torch.tensor(7 + i, dtype=torch.int32)
    first = next((i for i, k in enumerate(kinds) if k in ("attn", "local")),
                 None)
    pos = M._cache_pos(cfg, caches)
    assert int(pos) == (0 if first is None else 7 + first)
    mine, ref, _ = _serve_both(arch, pos_kind="sinusoidal")
    for m, r in zip(mine, ref):
        assert np.abs(m - r).max() <= LOGITS


def test_pooled_embedding_is_the_mean_fp32_hidden_state():
    _, _, cfg, model, batch = _case("gemma3-1b")
    tokens = batch["tokens"][:, :40]
    got = M.pooled_embedding(model, tokens, batch_size=1)
    want = M.forward_hidden(model, {"tokens": tokens}).float().mean(dim=1)
    assert got.dtype == torch.float32 and got.shape == (2, cfg.d_model)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _maxima(arch):
    """The measured maxima behind the tolerances above, for one arch."""
    jcfg, params, cfg, model, batch = _case(arch)
    ins, last = _reference_hidden(arch)
    enc = None
    if cfg.enc_dec:
        enc = torch.tensor(_np(JM.encode(params, jcfg, jnp.asarray(
            batch["frames"])))).bfloat16()
    block = 0.0
    for i, bp in enumerate(model.layers):
        got, _ = M.apply_block(bp, torch.tensor(_np(ins[i])).bfloat16(), cfg,
                               "train", enc_out=enc)
        want = _np(ins[i + 1] if i + 1 < len(ins) else last)
        scale = np.abs(want).max(axis=-1, keepdims=True)
        block = max(block, float((np.abs(_np(got) - want) / scale).max()))
    want = _np(last)
    got = _np(M.forward_hidden(model, _tbatch(batch)))
    with pytest.MonkeyPatch.context() as mp:
        exact = _unrounded_hidden(model, _tbatch(batch), mp)
    e1, e2 = got.mean(axis=1), want.mean(axis=1)
    cos = (e1 * e2).sum(-1) / np.linalg.norm(e1, axis=-1) \
        / np.linalg.norm(e2, axis=-1)
    logits = float(np.abs(_np(M._logits(model, torch.tensor(got).bfloat16()))
                          - _np(JM._logits(params, jcfg, jnp.asarray(want)
                                           .astype(jnp.bfloat16)))).max())
    mine, ref, full = _serve_both(arch)
    return {"block (of the row's max)": block,
            "hidden row-rel vs reference": _row_rel(got, want),
            "reference vs unrounded": _row_rel(want, exact),
            "1 - pooled cosine": float(1 - cos.min()),
            "logits": logits,
            "decode logits vs reference": max(float(np.abs(m - r).max())
                                              for m, r in zip(mine, ref)),
            "port's decode drift": max(float(np.abs(m - f).max())
                                       for m, f in zip(mine, full))}


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_model.py
    for arch in DENSE:
        print(arch, {k: round(v, 6) for k, v in _maxima(arch).items()})
