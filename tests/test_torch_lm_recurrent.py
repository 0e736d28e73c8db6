"""The port's recurrent mixers (``repro_torch.models.recurrent``) against
the reference's (``repro.models.recurrent``) on the same numpy inputs and
the same weights, at reduced widths (d = d_rnn = 64; 4 heads of 16).

Tolerances, and why:

* ``causal_conv1d`` and its state: bit for bit (bf16 products and adds,
  each rounded, in the reference's order);
* ``softplus`` and ``sigmoid``: the reference's formulas, within 2 fp32
  ulps (rtol 3e-7; the exp and log1p implementations differ), and
  subnormal results may flush to zero on XLA's side (atol 1.2e-38);
* ``rglru_scan`` on the same (a, bx): rtol 1e-6. The port runs the
  reference's ``associative_scan`` recursion, so the products group as
  the reference's do; only the last bit may move;
* the RG-LRU gates, the mLSTM and sLSTM states and every fp32 output:
  rtol 1e-4 with an atol of 1e-5 of the tensor's largest magnitude. Their
  fp32 products (gates, chunk einsums, recurrent matrices) sum in another
  order than XLA's, and the chunkwise mLSTM's exponentials amplify a last
  bit by the stabiliser;
* the blocks' bf16 outputs: within 1e-2 of the row's largest magnitude
  (one bf16 rounding of a sum whose fp32 inputs moved by an ulp), as
  ``tests/test_torch_lm_model.py`` holds each block.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.models import recurrent as JR  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402

D, H, DH, B = 64, 4, 16, 2
CHUNK = 16                   # reduced()'s lstm_chunk
RTOL, ATOL = 1e-4, 1e-5
BLOCK = 1e-2

torch.set_grad_enabled(False)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=torch.float32):
    return torch.tensor(_np(x)).to(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


def _block_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = BLOCK * np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= scale + BLOCK * np.abs(want)).all()


def _load(mod, params):
    mod.load_state_dict({k: torch.tensor(np.asarray(v))
                         for k, v in params.items()})
    return mod


def _x(s, seed=0, scale=1.0):
    x = np.random.default_rng(seed).normal(size=(B, s, D)) * scale
    return jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)


def _cache(c):
    return {k: _t(v, torch.bfloat16 if v.dtype == jnp.bfloat16
                  else torch.float32) for k, v in c.items()}


# -- helpers in the reference's formulas -------------------------------------

def test_softplus_and_sigmoid_are_the_reference_formulas():
    x = np.concatenate([np.linspace(-40, 40, 2001),
                        [-1e30, -88.0, 0.0, 19.5, 20.0, 20.5, 1e4]]) \
        .astype(np.float32)
    for mine, ref in ((R.softplus, jax.nn.softplus),
                      (R.sigmoid, jax.nn.sigmoid)):
        np.testing.assert_allclose(mine(torch.tensor(x)).numpy(),
                                   np.asarray(ref(jnp.asarray(x))),
                                   rtol=3e-7, atol=1.2e-38)


# -- causal conv --------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 5, 33])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_and_its_state_bit_equal(s, with_state):
    r = np.random.default_rng(s)
    x = jnp.asarray(r.normal(size=(B, s, D)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    w = jnp.asarray(r.normal(size=(4, D)).astype(np.float32) / 8) \
        .astype(jnp.bfloat16)
    st = (jnp.asarray(r.normal(size=(B, 3, D)).astype(np.float32))
          .astype(jnp.bfloat16) if with_state else None)
    want_y, want_s = JR.causal_conv1d(x, w, st)
    y, new = R.causal_conv1d(_t(x, torch.bfloat16), _t(w, torch.bfloat16),
                             None if st is None else _t(st, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and new.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(y), _np(want_y))
    np.testing.assert_array_equal(_np(new), _np(want_s))


# -- RG-LRU -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rglru():
    k = jax.random.PRNGKey(1)
    params = JR.init_rglru(k, D, D, 4)
    params.update(JR.init_rglru_out(jax.random.fold_in(k, 1), D, D))
    return params, _load(R.RGLRU(D, D, 4), params)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 33, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_the_associative_scan(s, with_h0):
    r = np.random.default_rng(s)
    a = r.uniform(0.5, 1.0, (B, s, D)).astype(np.float32)
    bx = r.normal(size=(B, s, D)).astype(np.float32)
    h0 = r.normal(size=(B, D)).astype(np.float32) if with_h0 else None
    want = JR.rglru_scan(jnp.asarray(a), jnp.asarray(bx),
                         None if h0 is None else jnp.asarray(h0))
    got = R.rglru_scan(torch.tensor(a), torch.tensor(bx),
                       None if h0 is None else torch.tensor(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # against the recurrence itself, in fp64
    h = np.zeros((B, D)) if h0 is None else h0.astype(np.float64)
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-5)


def test_rglru_gates_match_the_reference():
    params, mod = _rglru()
    u = _x(9, seed=2)
    wa, wb = JR._rglru_gates(params, u)
    a, bx = R._rglru_gates(mod, _t(u, torch.bfloat16))
    _close(a, wa)
    _close(bx, wb)


def test_rglru_block_prefill_then_decode_match_the_reference():
    """The training form (no cache), a prefill from the zero cache, then
    three one-token steps: outputs and caches against the reference's."""
    params, mod = _rglru()
    x = _x(24, seed=3)
    want, none = JR.rglru_block(params, x)
    got, mine = R.rglru_block(mod, _t(x, torch.bfloat16))
    assert none is None and mine is None
    _block_close(got, want)
    jc = JR.init_rglru_cache(B, D, 4)
    tc = R.init_rglru_cache(B, D, 4)
    for name in ("h", "conv"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_array_equal(_np(tc[name]), _np(jc[name]))
    assert tc["conv"].dtype == torch.bfloat16
    jy, jc = JR.rglru_block(params, x[:, :20], jc)
    ty, tc = R.rglru_block(mod, _t(x[:, :20], torch.bfloat16), tc)
    _block_close(ty, jy)
    for t in range(20, 24):
        jy, jc = JR.rglru_decode(params, x[:, t:t + 1], jc)
        ty, tc = R.rglru_decode(mod, _t(x[:, t:t + 1], torch.bfloat16), tc)
        _block_close(ty, jy)
        _close(tc["h"], jc["h"])
        np.testing.assert_array_equal(_np(tc["conv"]), _np(jc["conv"]))
        # the step continues the training form's sequence
        _block_close(ty, want[:, t:t + 1])


# -- mLSTM --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mlstm():
    params = JR.init_mlstm(jax.random.PRNGKey(4), D, H, DH)
    return params, _load(R.MLSTM(D, H, DH), params)


def _same_state(mine, ref):
    assert set(mine) == set(ref)
    for k in ref:
        assert mine[k].dtype == torch.float32
        _close(mine[k], ref[k])


@functools.lru_cache(maxsize=None)
def _mlstm_reference(s, with_cache):
    params, _ = _mlstm()
    x = _x(s, seed=5)
    cache = None
    if with_cache:
        _, cache = JR.mlstm_chunkwise(params, _x(20, seed=6), None,
                                      chunk=CHUNK)
    out, new = JR.mlstm_chunkwise(params, x, cache, chunk=min(CHUNK, s))
    return x, cache, out, new


@pytest.mark.parametrize("s", [1, 16, 37])
@pytest.mark.parametrize("with_cache", [False, True])
def test_mlstm_chunkwise_matches_the_reference(s, with_cache):
    """One chunk, several chunks with the identity pad (37 = 2 x 16 + 5),
    and one step (chunk 1, the model's decode), from the zero state and
    from a carried one."""
    params, mod = _mlstm()
    x, cache, want, want_c = _mlstm_reference(s, with_cache)
    got, mine = R.mlstm_chunkwise(
        mod, _t(x, torch.bfloat16),
        None if cache is None else _cache(cache), chunk=min(CHUNK, s))
    assert got.dtype == torch.bfloat16
    _block_close(got, want)
    _same_state(mine, want_c)


def test_mlstm_pad_does_not_move_the_state():
    """37 tokens in chunks of 16 (the last padded by 11 identity steps)
    equal 37 tokens in chunks of 37 (no pad)."""
    _, mod = _mlstm()
    x = _t(_x(37, seed=5), torch.bfloat16)
    a, ca = R.mlstm_chunkwise(mod, x, chunk=CHUNK)
    b, cb = R.mlstm_chunkwise(mod, x, chunk=37)
    _block_close(a, b)
    _same_state(ca, {k: v.numpy() for k, v in cb.items()})


def test_mlstm_decode_matches_the_reference_and_the_chunk_of_one():
    params, mod = _mlstm()
    _, jc = JR.mlstm_chunkwise(params, _x(20, seed=6), None, chunk=CHUNK)
    tc = _cache(jc)
    init = R.init_mlstm_cache(B, H, DH)
    for k, v in JR.init_mlstm_cache(B, H, DH).items():
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(v))
    x = _x(4, seed=7)
    chunk_c = dict(tc)
    for t in range(4):
        xt = x[:, t:t + 1]
        jy, jc = JR.mlstm_decode(params, xt, jc)
        ty, tc = R.mlstm_decode(mod, _t(xt, torch.bfloat16), tc)
        assert ty.shape == (B, 1, D) and ty.dtype == torch.bfloat16
        _block_close(ty, jy)
        _same_state(tc, jc)
        cy, chunk_c = R.mlstm_chunkwise(mod, _t(xt, torch.bfloat16),
                                        chunk_c, chunk=1)
        _block_close(cy, ty)
        _same_state(chunk_c, {k: v.numpy() for k, v in tc.items()})


# -- sLSTM --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _slstm():
    params = JR.init_slstm(jax.random.PRNGKey(8), D, H, DH)
    return params, _load(R.SLSTM(D, H, DH), params)


@pytest.mark.parametrize("with_cache", [False, True])
def test_slstm_block_matches_the_reference(with_cache):
    params, mod = _slstm()
    cache = None
    if with_cache:
        _, cache = JR.slstm_block(params, _x(9, seed=9))
    x = _x(21, seed=10)
    want, want_c = JR.slstm_block(params, x, cache)
    got, mine = R.slstm_block(mod, _t(x, torch.bfloat16),
                              None if cache is None else _cache(cache))
    assert got.dtype == torch.bfloat16
    _block_close(got, want)
    _same_state(mine, want_c)


def test_slstm_decode_and_its_cache_match_the_reference():
    params, mod = _slstm()
    jc = JR.init_slstm_cache(B, H, DH)
    tc = R.init_slstm_cache(B, H, DH)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    x = _x(5, seed=11)
    whole, _ = R.slstm_block(mod, _t(x, torch.bfloat16))
    for t in range(5):
        jy, jc = JR.slstm_decode(params, x[:, t:t + 1], jc)
        ty, tc = R.slstm_decode(mod, _t(x[:, t:t + 1], torch.bfloat16), tc)
        _block_close(ty, jy)
        _same_state(tc, jc)
        # step by step equals the sequence at once, bit for bit
        assert torch.equal(ty, whole[:, t:t + 1])
