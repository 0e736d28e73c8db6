"""Attention and KV caches of the port (``repro_torch.models.attention``)
against the JAX package's (``repro.models.attention``) on the same numpy
inputs from a seed.

Tolerances: bf16 outputs compared in fp32 at rtol = atol = 1e-2 (the
chunked core keeps the reference's chunking, so each chunk's ``p`` rounds
to bf16 against the same running max); the caches' integer state
(``slot_pos``, ``pos``) and the K/V they hold bit for bit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

RTOL = ATOL = 1e-2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    """The same bf16 values in both packages."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.tensor(_np(j)).bfloat16()


def _qkv(b, sq, skv, H, KV, dh, seed=0):
    r = np.random.default_rng(seed)
    return (_bf16(r.normal(size=(b, sq, H, dh)).astype(np.float32)),
            _bf16(r.normal(size=(b, skv, KV, dh)).astype(np.float32)),
            _bf16(r.normal(size=(b, skv, KV, dh)).astype(np.float32)))


def _close(got, want):
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


# (name, s, H, KV, kwargs): every path of the core
CASES = [
    ("causal full", 64, 4, 2, dict(causal=True)),
    ("banded local, seq > window + q_chunk", 100, 4, 2,
     dict(causal=True, window=24)),
    ("padding at a non-divisible length", 45, 4, 4, dict(causal=True)),
    ("local padded and clipped", 45, 4, 1, dict(causal=True, window=16)),
    ("softcap", 64, 4, 2, dict(causal=True, cap=5.0)),
    ("GQA g = 4", 64, 8, 2, dict(causal=True)),
    ("banded_causal", 70, 4, 2, dict(causal=True, banded_causal=True)),
    ("not causal", 45, 4, 2, dict(causal=False)),
]


@pytest.mark.parametrize("chunks", [(32, 32), (16, 8), (512, 512)])
@pytest.mark.parametrize("name,s,H,KV,kw", CASES, ids=[c[0] for c in CASES])
def test_chunked_attention(name, s, H, KV, kw, chunks):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, s, H, KV, 16)
    qc, kc = chunks
    got = A.chunked_attention(tq, tk, tv, q_chunk=qc, kv_chunk=kc, **kw)
    want = JA.chunked_attention(jq, jk, jv, q_chunk=qc, kv_chunk=kc, **kw)
    assert got.shape == (2, s, H, 16)
    _close(got, want)


def test_chunked_attention_offset_and_scale():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 20, 60, 4, 2, 16, seed=1)
    kw = dict(causal=True, q_offset=40, scale=0.3, q_chunk=8, kv_chunk=16)
    _close(A.chunked_attention(tq, tk, tv, **kw),
           JA.chunked_attention(jq, jk, jv, **kw))


def test_a_fully_masked_row_is_finite_as_the_reference():
    """NEG = -1e30, not -inf, and acc / max(l, 1e-30): queries that see no
    key (here an offset before every key) give the reference's finite
    values, not nan."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 3, 3, 2, 2, 8, seed=2)
    got = A.chunked_attention(tq, tk, tv, causal=True, q_offset=-10)
    assert torch.isfinite(got.float()).all()
    _close(got, JA.chunked_attention(jq, jk, jv, causal=True, q_offset=-10))


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
def test_projections_group_query_heads_as_the_reference(H, KV):
    """GQA: q reshapes to (b, s, KV, g, dh), so head h = kv * g + j."""
    d, dh = 32, 8
    params = JA.init_attention(jax.random.PRNGKey(3), d, H, KV, dh)
    p = A.Attention(d, H, KV, dh)
    p.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in params.items()})
    jx, tx = _bf16(np.random.default_rng(4).normal(size=(2, 9, d))
                   .astype(np.float32))
    with torch.no_grad():
        got = A._qkv(p, tx)
        for g, w in zip(got, JA._qkv(params, jx, KV)):
            np.testing.assert_array_equal(_np(g), _np(w))
        o = got[0]
        np.testing.assert_array_equal(_np(A._out(p, o)),
                                      _np(JA._out(params, jnp.asarray(
                                          _np(o)).astype(jnp.bfloat16))))
        for kw in (dict(causal=True, window=0), dict(causal=True, window=4)):
            _close(A.attn_forward(p, tx, q_chunk=4, kv_chunk=4, **kw),
                   JA.attn_forward(params, jx, n_kv=KV, q_chunk=4,
                                   kv_chunk=4, **kw))


@pytest.mark.parametrize("max_len,window", [
    (64, 0), (127, 0), (128, 0), (300, 0), (1056, 0), (64, 32), (300, 32),
    (1056, 512), (100, 200), (4096, 4096)])
def test_cache_sizes_equal_the_reference(max_len, window):
    jc = JA.init_kv_cache(2, 1, 8, max_len, window=window)
    tc = A.init_kv_cache(2, 1, 8, max_len, window=window)
    assert tc["k"].shape == jc["k"].shape == (2, A.cache_size(max_len,
                                                              window), 1, 8)
    assert tc["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    assert tc["slot_pos"].dtype == torch.int32 and tc["pos"].dtype == \
        torch.int32 and int(tc["pos"]) == int(jc["pos"]) == 0


def _same_cache(tc, jc):
    """Integer state and the K/V held, bit for bit."""
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    assert tc["slot_pos"].dtype == torch.int32
    assert tuple(tc["pos"].shape) == () and tc["pos"].dtype == torch.int32
    assert int(tc["pos"]) == int(jc["pos"])
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(tc[n]), _np(jc[n]))


@pytest.mark.parametrize("max_len,window,s", [
    (64, 0, 20), (300, 32, 100), (300, 32, 128), (300, 32, 200),
    (160, 0, 160), (150, 0, 149)])
def test_cache_updates_prefill_then_decode(max_len, window, s):
    """Prefill shorter than, equal to and longer than the cache (the last
    ``size`` positions kept in slot order pos % size), then decode steps
    that wrap the rolling buffer; the attention over each state too."""
    r = np.random.default_rng(s)
    jc = JA.init_kv_cache(2, 2, 8, max_len, window=window)
    tc = A.init_kv_cache(2, 2, 8, max_len, window=window)
    jk, tk = _bf16(r.normal(size=(2, s, 2, 8)).astype(np.float32))
    jv, tv = _bf16(r.normal(size=(2, s, 2, 8)).astype(np.float32))
    jc = JA.cache_update_prefill(jc, jk, jv)
    tc = A.cache_update_prefill(tc, tk, tv)
    _same_cache(tc, jc)
    for step in range(min(6, max_len - s) if window == 0 else 6):
        jk1, tk1 = _bf16(r.normal(size=(2, 1, 2, 8)).astype(np.float32))
        jv1, tv1 = _bf16(r.normal(size=(2, 1, 2, 8)).astype(np.float32))
        jc = JA.cache_update_decode(jc, jk1, jv1)
        tc = A.cache_update_decode(tc, tk1, tv1)
        _same_cache(tc, jc)
        jq, tq = _bf16(r.normal(size=(2, 1, 4, 8)).astype(np.float32))
        for cap in (None, 5.0):
            got = A.decode_attend(tq, tc, window=window, cap=cap)
            want = JA.decode_attend(jq, jc, window=window, cap=cap)
            _close(got, want)


def test_decode_does_not_touch_the_callers_cache():
    tc = A.init_kv_cache(1, 1, 4, 16)
    k1 = torch.ones(1, 1, 1, 4, dtype=torch.bfloat16)
    new = A.cache_update_decode(tc, k1, k1)
    assert int(tc["pos"]) == 0 and (tc["k"] == 0).all()
    assert int(new["pos"]) == 1 and int(new["slot_pos"][0]) == 0


@pytest.mark.parametrize("window,cap", [(0, None), (24, None), (24, 50.0)])
def test_attention_blocks_prefill_then_decode(window, cap):
    """attn_prefill and attn_decode as a model layer calls them (RoPE at
    theta 1e6, the cache past the window) against the reference's."""
    d, H, KV, dh, s, max_len = 32, 4, 2, 8, 140, 150
    params = JA.init_attention(jax.random.PRNGKey(5), d, H, KV, dh)
    p = A.Attention(d, H, KV, dh)
    p.load_state_dict({k: torch.tensor(np.asarray(v))
                       for k, v in params.items()})
    r = np.random.default_rng(6)
    jx, tx = _bf16(r.normal(size=(2, s, d)).astype(np.float32))
    kw = dict(window=window, rope_theta=1e6, cap=cap)
    jc = JA.init_kv_cache(2, KV, dh, max_len, window=window)
    tc = A.init_kv_cache(2, KV, dh, max_len, window=window)
    with torch.no_grad():
        got, tc = A.attn_prefill(p, tx, tc, q_chunk=32, kv_chunk=32, **kw)
    want, jc = JA.attn_prefill(params, jx, jc, n_kv=KV, q_chunk=32,
                               kv_chunk=32, **kw)
    _close(got, want)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), rtol=RTOL,
                               atol=ATOL)
    for _ in range(4):
        jx1, tx1 = _bf16(r.normal(size=(2, 1, d)).astype(np.float32))
        with torch.no_grad():
            got, tc = A.attn_decode(p, tx1, tc, **kw)
        want, jc = JA.attn_decode(params, jx1, jc, n_kv=KV, **kw)
        _close(got, want)
        np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        assert int(tc["pos"]) == int(jc["pos"])
