"""The pieces of the port's sharded step, each against the reference's and
its own unsharded function: the mesh's collectives
(``repro_torch.distributed.sharding``), the sequence-parallel attention
core, the MoE's grouped dispatch and ``cross_pod_grad_sync``.

Tolerances, and why:

* the collectives: forward and backward equal the plain PyTorch function
  they stand for (a sum, a concatenation, a split) and its adjoint, bit
  for bit where the sum runs in one order; their bytes as counted;
* the sequence-parallel core: bit for bit the port's unsharded core where
  each slice is a whole number of query chunks (the chunks are the same),
  the queries' gradient too (K's and V's sum the positions' bf16
  gradients in another order: rtol = atol = 1e-2); against the reference's ``chunked_attention(...,
  _no_seq_shard=True)`` called per slice with the slice's ``q_offset``
  (what its ``shard_map`` body runs) at the attention tests' rtol = atol
  = 1e-2 (the reference's own sequence-parallel test allows 2e-2);
* the grouped dispatch: each group's routing and kept set equal the
  reference's grouped ``apply_moe`` (its ``shard_act`` the identity: it
  only constrains a layout), the output by the MoE tests' rule (at most
  one bf16 ulp of the row's largest magnitude, in under 1 element in
  1,000);
* ``cross_pod_grad_sync``: within 0.02 of the exact sum (the reference's
  cross-pod test); the pods' codes within one step of the reference's
  ``quantize_int8`` of the same partial and the scales bit-equal (the
  port's quantizer rule); the output, the pods' dequantized codes summed,
  bit for bit.
"""
import functools
import threading
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as JC  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    cross_pod_grad_sync, dequantize_int8, quantize_int8)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SEQ_RULES = {"attn_core_seq_shard": "model", "heads": None,
             "head_dim": "model"}


@pytest.fixture(autouse=True)
def grad_on():
    """Gradients on: other test modules switch autograd off at import,
    and an xdist worker may import them before this one runs."""
    with torch.enable_grad():
        yield


def _group(n=3, stats=None):
    return S.AxisGroup([torch.device("cpu")] * n, "model", stats)


def _rand(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


# -- the collectives ---------------------------------------------------------

def test_collectives_forward_backward_and_bytes():
    """Each collective against the plain function it stands for and the
    function's adjoint; bytes counted by kind and axis."""
    stats = S.CollectiveStats()
    g = _group(3, stats)
    parts = [_rand(2, 6, seed=i).requires_grad_() for i in range(3)]
    cot = _rand(2, 6, seed=9)
    # sum: backward hands each part the gradient
    out = g.psum(parts)
    assert torch.equal(out, parts[0] + parts[1] + parts[2])
    grads = torch.autograd.grad(out, parts, cot)
    assert all(torch.equal(x, cot) for x in grads)
    # broadcast: backward sums the positions' gradients (an all-reduce)
    x = _rand(2, 6, seed=4).requires_grad_()
    cots = [_rand(2, 6, seed=10 + i) for i in range(3)]
    copies = g.broadcast(x)
    assert all(torch.equal(c, x) for c in copies)
    (gx,) = torch.autograd.grad(copies, [x], cots)
    assert torch.equal(gx, cots[0] + cots[1] + cots[2])
    # all-gather: each position's copy; backward a reduce-scatter
    full = g.all_gather(parts, 1)
    assert all(torch.equal(f, torch.cat(parts, 1)) for f in full)
    fc = [_rand(2, 18, seed=20 + i) for i in range(3)]
    grads = torch.autograd.grad(full, parts, fc)
    total = fc[0] + fc[1] + fc[2]
    for i, gi in enumerate(grads):
        assert torch.equal(gi, total[:, 6 * i:6 * i + 6])
    # reduce-scatter: backward an all-gather
    blocks = g.reduce_scatter(parts, 1)
    assert blocks.dim == 1
    assert torch.equal(torch.cat(list(blocks), 1),
                       parts[0] + parts[1] + parts[2])
    bc = [_rand(2, 2, seed=30 + i) for i in range(3)]
    grads = torch.autograd.grad(list(blocks), parts, bc)
    assert all(torch.equal(gi, torch.cat(bc, 1)) for gi in grads)
    # all-to-all: split dim 1, joined along dim 0; backward the way back
    moved = g.all_to_all(parts, 1, 0)
    for m in range(3):
        assert torch.equal(moved[m], torch.cat(
            [p[:, 2 * m:2 * m + 2] for p in parts], 0))
    mc = [_rand(6, 2, seed=40 + i) for i in range(3)]
    grads = torch.autograd.grad(list(moved), parts, mc)
    for j, gj in enumerate(grads):
        assert torch.equal(gj, torch.cat([mc[m][2 * j:2 * j + 2]
                                          for m in range(3)], 1))
    # split: backward an all-gather
    pieces = g.split(x, 1)
    assert torch.equal(torch.cat(list(pieces), 1), x)
    (gx,) = torch.autograd.grad(list(pieces), [x], [c[:, :2] for c in cots])
    assert torch.equal(gx, torch.cat([c[:, :2] for c in cots], 1))
    assert torch.equal(g.pmax(parts), torch.maximum(
        torch.maximum(parts[0], parts[1]), parts[2]))
    b = 2 * 6 * 4
    kinds = {k: (v["count"], v["bytes"]) for k, v in stats.by_kind.items()}
    assert kinds == {
        # psum, broadcast's backward, pmax
        "all-reduce": (3, 9 * b),
        # all_gather, reduce_scatter's and split's backward
        "all-gather": (3, 3 * b + 3 * b // 3 + 3 * b // 3),
        # all_gather's backward (3 full copies), reduce_scatter
        "reduce-scatter": (2, 9 * b + 3 * b),
        "all-to-all": (2, 6 * b)}
    assert set(stats.by_kind["all-gather"]["by_axis"]) == {"model"}


def test_a_group_of_one_is_the_identity_and_counts_nothing():
    stats = S.CollectiveStats()
    g = _group(1, stats)
    x = _rand(4, 4)
    assert g.psum([x]) is x and g.broadcast(x)[0] is x
    assert g.all_gather([x], 0)[0] is x and g.split(x, 0)[0] is x
    assert g.reduce_scatter([x], 0)[0] is x
    assert g.all_to_all([x], 0, 1)[0] is x
    assert stats.by_kind == {}
    with pytest.raises(ValueError, match="takes 1 blocks"):
        g.psum([x, x])
    with pytest.raises(ValueError, match="does not split"):
        _group(3).split(x, 0)


def test_rules_and_group_reach_the_autograd_threads():
    """A CUDA backward, and the recompute of a checkpointed block in it,
    run on the autograd engine's own threads: the current rules must be
    visible there, and gone after the block. The group a layer joins its
    blocks with travels with them (``Blocks.group``), and a module's view
    names its group (``group_of``)."""
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    rules = S.AxisRules(mesh)
    seen = []
    with S.use_rules(rules):
        t = threading.Thread(target=lambda: seen.append(S.current_rules()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [rules]
    assert S.current_rules() is None
    g = _group(2)
    x = _rand(4, 4)
    for blocks in (g.split(x, 0), g.reduce_scatter([x, x], 1),
                   g.all_to_all([x, x], 0, 1)):
        assert blocks.group is g
    assert S.group_of(torch.nn.Linear(2, 2)) is None
    cfg = reduced(get_config("granite-moe-3b-a800m"))
    sg = M.ShardGroup(mesh, rules, {"data": 1}, {})
    view = sg.view(M.Model(cfg, torch.device("meta")))
    assert S.group_of(view.layers[0].moe) is sg.tp
    assert sg.tp.axis == "model" and sg.tp.devices == [torch.device("cpu")]


# -- the sequence-parallel core ----------------------------------------------

def _bf16(a):
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).bfloat16()


# (name, s, H, KV, q_chunk, kwargs): causal with GQA (the reference test's
# case), windowed (gemma3's local layers), g = 4, not causal, and a slice
# narrower than a query chunk
CORE_CASES = [
    ("causal GQA 6/2", 64, 6, 2, 16, dict(causal=True)),
    ("windowed", 64, 4, 1, 8, dict(causal=True, window=12)),
    ("GQA g = 4", 64, 8, 2, 16, dict(causal=True)),
    ("not causal", 64, 4, 4, 16, dict(causal=False)),
    ("slice below a chunk", 64, 6, 2, 32, dict(causal=True, window=20)),
]


@pytest.mark.parametrize("name,s,H,KV,qc,kw", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_sequence_parallel_core(name, s, H, KV, qc, kw):
    r = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (_bf16(r.normal(size=shape).astype(
        np.float32)) for shape in ((2, s, H, 16), (2, s, KV, 16),
                                   (2, s, KV, 16)))
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    args = dict(q_chunk=qc, kv_chunk=16, **kw)
    plain = A.chunked_attention(q, k, v, **args)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    with S.use_rules(S.AxisRules(mesh, SEQ_RULES)):
        assert A.seq_core_group(s).n == 4
        assert A.seq_core_group(s, banded_causal=True) is None
        assert A.seq_core_group(6) is None
        sp = A.chunked_attention(tq, tk, tv, **args)
    s_loc = s // 4
    if s_loc % qc == 0:
        assert torch.equal(sp, plain)
        pq, pk, pv = (t.clone().requires_grad_() for t in (q, k, v))
        cot = torch.randn(sp.shape, generator=torch.Generator().manual_seed(
            1)).bfloat16()
        want = torch.autograd.grad(A.chunked_attention(pq, pk, pv, **args),
                                   [pq, pk, pv], cot)
        got = torch.autograd.grad(sp, [tq, tk, tv], cot)
        # the queries' gradient bit for bit; K's and V's sum the positions'
        # bf16 gradients in position order, not autograd's chunk order
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(sp.detach().float().numpy(),
                                   plain.float().numpy(),
                                   rtol=1e-2, atol=1e-2)
    for m in range(4):
        want = JA.chunked_attention(
            jq[:, m * s_loc:(m + 1) * s_loc], jk, jv, causal=kw["causal"],
            window=kw.get("window", 0), q_offset=m * s_loc,
            q_chunk=min(qc, s_loc), kv_chunk=16, _no_seq_shard=True)
        np.testing.assert_allclose(
            sp[:, m * s_loc:(m + 1) * s_loc].float().detach().numpy(),
            np.asarray(want.astype(jnp.float32)), rtol=1e-2, atol=1e-2)


# -- the MoE's grouped dispatch ----------------------------------------------

@functools.lru_cache(maxsize=None)
def _moe_case():
    """Reduced granite's MoE (d 64, 4 experts of 64, top 2)."""
    d, f, e, k = 64, 64, 4, 2
    params = JMoE.init_moe(jax.random.PRNGKey(3), d, f, e)
    mod = moe.MoE(d, f, e)
    mod.load_state_dict({n: torch.tensor(np.asarray(v))
                         for n, v in params.items()})
    x = np.random.default_rng(1).normal(size=(4, 40, d)).astype(np.float32)
    return params, mod.requires_grad_(False), jnp.asarray(x).astype(
        jnp.bfloat16), k


@pytest.mark.parametrize("cf", (1.25, 0.5))
def test_grouped_dispatch_matches_the_reference(cf, monkeypatch):
    """granite reduced with the data axis 2: two dispatch groups of 80
    tokens, each with its own capacity. The reference's grouped
    ``apply_moe`` runs under its rules with a stand-in mesh (its groups
    read only the mesh's axes and shape) and ``shard_act`` the identity."""
    params, mod, xb, k = _moe_case()
    x = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    monkeypatch.setattr(JMoE, "shard_act", lambda t, *names: t)
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  devices=np.empty((2, 1)))
    with JS.use_rules(JS.AxisRules(jmesh)):
        assert JMoE._dp_groups(4) == 2
        want = np.asarray(JMoE.apply_moe(params, xb, top_k=k,
                                         capacity_factor=cf).astype(
                                             jnp.float32))
    ungrouped = np.asarray(JMoE.apply_moe(params, xb, top_k=k,
                                          capacity_factor=cf).astype(
                                              jnp.float32))
    assert (want != ungrouped).any(), "the grouping must change the drops"
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    with S.use_rules(S.AxisRules(mesh)):
        assert moe._dp_groups(4) == 2 and moe._dp_groups(3) == 1
        got = moe.apply_moe(mod, x, top_k=k, capacity_factor=cf)
    got = got.float().numpy()
    row = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(got - want) <= 2.0 ** -7 * row).all()
    assert (got != want).mean() < 1e-3
    # each group's kept set is the reference's: the same tokens dropped
    for g in range(2):
        xt = x[2 * g:2 * g + 2].reshape(80, -1)
        cap = moe.capacity(cf, 80, k, 4)
        _, _, _, _, keep = moe.route(mod, xt, k, cap)
        jx = xb[2 * g:2 * g + 2].reshape(80, -1)
        probs = jax.nn.softmax(jx.astype(jnp.float32) @ params["w_router"])
        _, experts = jax.lax.top_k(probs, k)
        onehot = jax.nn.one_hot(experts.reshape(-1), 4, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, 0) - onehot) * onehot, -1)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(pos < cap))


# -- cross_pod_grad_sync -----------------------------------------------------

def _mesh222():
    return make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")


def _blocks(mesh, fn):
    out = np.empty(mesh.devices.shape, dtype=object)
    for pos, coords in S.positions(mesh):
        out[pos] = fn(coords)
    return out


def test_cross_pod_sync_the_reference_case():
    """The reference's (2, 2, 2) case: every position holds g; the sync is
    within 0.02 of 8 g. Each pod's partial (4 g) quantizes to codes within
    one step of the reference's and the same scales, and the output is the
    pods' dequantized partials summed, drawn from the generator pod by
    pod."""
    mesh = _mesh222()
    g = torch.tensor(np.random.default_rng(0).normal(size=(512,))
                     .astype(np.float32))
    stats = S.CollectiveStats()
    out = cross_pod_grad_sync(mesh, stats=stats)(
        _blocks(mesh, lambda c: g), torch.Generator().manual_seed(0))
    exact = 8 * g
    first = out[0, 0, 0]
    assert all(t is first for t in out.flat)
    rel = float((first - exact).abs().max() / exact.abs().max())
    assert rel < 0.02, rel
    gen = torch.Generator().manual_seed(0)
    partial = g + g + g + g
    deq = []
    jcodes, jscales, _ = JC.quantize_int8(jnp.asarray(partial.numpy()),
                                          jax.random.PRNGKey(0))
    for _ in range(2):
        codes, scales, pad = quantize_int8(partial, gen)
        assert np.abs(codes.numpy().astype(int)
                      - np.asarray(jcodes).astype(int)).max() <= 1
        np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
        deq.append(dequantize_int8(codes, scales, pad, partial.shape,
                                   torch.float32))
    assert torch.equal(first, deq[0] + deq[1])
    assert stats.by_kind["all-reduce"]["by_axis"] == {
        "data,model": 8 * 512 * 4, "pod": 8 * (512 + 4 * 2)}


def test_cross_pod_sync_when_the_pods_differ():
    """Each position holds its own gradient: the pods' partials differ;
    the sync stays within 0.02 of the exact sum, and the reduce-scatter
    form gives each position its slice of the same sum."""
    mesh = _mesh222()
    r = np.random.default_rng(1)
    vals = {pos: torch.tensor(r.normal(size=(8, 64)).astype(np.float32))
            for pos, _ in S.positions(mesh)}
    blocks = _blocks(mesh, lambda c: vals[(c["pod"], c["data"], c["model"])])
    exact = sum(vals.values())
    out = cross_pod_grad_sync(mesh)(blocks, torch.Generator().manual_seed(0))
    err = float((out[0, 0, 0] - exact).abs().max() / exact.abs().max())
    assert 0 < err < 0.02
    plain = cross_pod_grad_sync(mesh, int8=False)(blocks, None)
    torch.testing.assert_close(plain[1, 1, 1], exact, rtol=1e-6, atol=1e-6)
    scattered = cross_pod_grad_sync(mesh, int8=False)(blocks, None, dim=0)
    for pos, coords in S.positions(mesh):
        i = 2 * coords["data"] + coords["model"]
        assert torch.equal(scattered[pos], plain[pos][2 * i:2 * i + 2])
    int8 = cross_pod_grad_sync(mesh)(blocks, torch.Generator().manual_seed(
        0), dim=0)
    joined = torch.cat([int8[0, d, m] for d in range(2) for m in range(2)])
    assert float((joined - exact).abs().max() / exact.abs().max()) < 0.02


def test_cross_pod_sync_without_a_pod_axis_is_a_plain_sum():
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    r = np.random.default_rng(2)
    vals = [torch.tensor(r.normal(size=(300,)).astype(np.float32))
            for _ in range(8)]
    blocks = _blocks(mesh, lambda c: vals[2 * c["data"] + c["model"]])
    out = cross_pod_grad_sync(mesh)(blocks, None)
    want = vals[0]
    for v in vals[1:]:
        want = want + v
    assert all(torch.equal(t, want) for t in out.flat)
