"""The port's shard layouts and cross-shard merges (``index/distributed.py``,
``index/slab.py``, ``launch/mesh.py``, ``distributed/sharding.py``).

* The merges against a global first-occurrence top-k: per-shard top-k of
  row-contiguous blocks merged over 8 shards laid out as (8,), (4, 2) and
  (2, 2, 2) equal ``topk_first`` over the whole score matrix, ties
  included; a merge of merges equals one merge (associativity); duplicate
  ids across sets both compete, as in ``flat.merge_topk``; k larger than
  the candidates pads (-inf, 0); an all -inf shard and a shard that did
  not run (None) change nothing; carried rows follow their candidates.
* The three layout packers (``balanced_list_layout``,
  ``affinity_group_layout``, ``cluster_sharded_layout``) equal the JAX
  package's bit for bit, in-process. The affinity packer's region seeds
  come from a k-means that each package draws from its own generator, so
  the JAX seeds are handed over, as the router's centers are in a
  checkpoint.
* ``sharded_search_fn`` / ``routed_search_fn`` against a global search,
  the mesh helpers and the axis rules against the reference's.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX
jnp = pytest.importorskip("jax.numpy")

from repro.core import clustering as jclustering
from repro.distributed import sharding as jsharding
from repro.index import distributed as jdist
from repro.index import slab as jslab
from repro_torch.core.clustering import assign
from repro_torch.distributed.sharding import AxisRules
from repro_torch.index import distributed as dist
from repro_torch.index import flat as flat_mod
from repro_torch.index import slab
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_first
from repro_torch.launch import mesh as mesh_mod
from test_torch_support import one_thread  # noqa: F401  (autouse)

SHAPES = [(8,), (4, 2), (2, 2, 2)]


def _scores(b=6, n=400, seed=0):
    """Scores rounded to a coarse grid, so ties across shards are many."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.round(rng.normal(size=(b, n)), 1)
                        .astype(np.float32))


def _per_shard(scores, ns, kl):
    n = scores.shape[1]
    nl = -(-n // ns)
    vals, ids = [], []
    for s in range(ns):
        v, p = topk_first(scores[:, s * nl:(s + 1) * nl], kl)
        vals.append(v)
        ids.append((p + s * nl).to(torch.int32))
    return vals, ids


@pytest.mark.parametrize("sizes", SHAPES)
@pytest.mark.parametrize("k", [5, 40, 50])
def test_tree_merge_equals_global_first_occurrence(sizes, k):
    scores = _scores()
    vals, ids = _per_shard(scores, 8, min(k, 50))
    got_v, got_i = dist.tree_merge_topk(vals, ids, sizes, k)
    want_v, want_p = topk_first(scores, k)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_i.long(), want_p)


def test_merge_is_associative_and_pads_past_the_pool():
    scores = _scores(n=64)
    vals, ids = _per_shard(scores, 8, 3)               # a pool of 24
    flat_v, flat_i = dist.merge_over_axis(vals, ids, 30)
    assert torch.isneginf(flat_v[:, 24:]).all() and (flat_i[:, 24:] == 0).all()
    for sizes in SHAPES:
        v, i = dist.tree_merge_topk(vals, ids, sizes, 30)
        assert torch.equal(v, flat_v) and torch.equal(i, flat_i)
    # merging the two halves' merges equals merging everything at once
    a = dist.merge_over_axis(vals[:4], ids[:4], 12)
    b = dist.merge_over_axis(vals[4:], ids[4:], 12)
    v, i = dist.merge_over_axis([a[0], b[0]], [a[1], b[1]], 12)
    assert torch.equal(v, flat_v[:, :12]) and torch.equal(i, flat_i[:, :12])


def test_merge_matches_flat_merge_topk_with_duplicate_ids():
    rng = np.random.default_rng(1)
    va = torch.tensor(np.round(rng.normal(size=(4, 7)), 1).astype(np.float32))
    vb = torch.tensor(np.round(rng.normal(size=(4, 5)), 1).astype(np.float32))
    ia = torch.tensor(rng.integers(0, 6, (4, 7)).astype(np.int32))
    ib = torch.tensor(rng.integers(0, 6, (4, 5)).astype(np.int32))
    for k in (3, 12, 15):
        want = flat_mod.merge_topk(va, ia, vb, ib, k)
        got = dist.merge_over_axis([va, vb], [ia, ib], k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_all_padding_and_skipped_shards_change_nothing():
    scores = _scores()
    vals, ids = _per_shard(scores, 8, 10)
    dead_v, dead_i = list(vals), list(ids)
    dead_v[3], dead_i[3] = None, None
    keep = [j for j in range(8) if j != 3]
    got = dist.tree_merge_topk(dead_v, dead_i, (4, 2), 10)
    ref = dist.merge_over_axis([vals[j] for j in keep],
                               [ids[j] for j in keep], 10)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    pad_v = list(vals)
    pad_v[5] = torch.full_like(vals[5], float("-inf"))
    got = dist.tree_merge_topk(pad_v, ids, (8,), 10)
    # an all -inf shard only ever fills slots the others cannot
    assert torch.equal(got[0], dist.tree_merge_topk(
        [v for j, v in enumerate(vals) if j != 5],
        [i for j, i in enumerate(ids) if j != 5], (7,), 10)[0])
    none_v, none_i = dist.tree_merge_topk([None] * 8, [None] * 8, (8,), 4,
                                          like=scores)
    assert torch.isneginf(none_v).all() and (none_i == 0).all()


def test_rows_ride_with_their_candidates():
    scores = _scores(n=200)
    vals, ids = _per_shard(scores, 8, 9)
    rng = np.random.default_rng(2)
    table = torch.tensor(rng.normal(size=(200, 5)).astype(np.float32))
    rows = [(table[i.long()], table[i.long()][..., :2]) for i in ids]
    for sizes in SHAPES:
        v, i, (r5, r2) = dist.tree_merge_topk_rows(vals, ids, rows, sizes, 30)
        want = dist.tree_merge_topk(vals, ids, sizes, 30)
        assert torch.equal(v, want[0]) and torch.equal(i, want[1])
        assert torch.equal(r5, table[i.long()])
        assert torch.equal(r2, table[i.long()][..., :2])
    v, i, (r5, _) = dist.tree_merge_topk_rows(vals, ids, rows, (8,), 80)
    assert (r5[:, 72:] == 0).all() and torch.isneginf(v[:, 72:]).all()


# -- the layout packers against the reference -------------------------------

@pytest.mark.parametrize("ns,cap", [(8, 2), (4, 5), (3, 7)])
def test_balanced_list_layout_matches_reference(ns, cap):
    sizes = np.random.default_rng(ns).integers(1, 90, 16)
    got = slab.balanced_list_layout(sizes, ns, cap)
    want = jslab.balanced_list_layout(sizes, ns, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _jax_seeds(centers, ns):
    return np.asarray(jclustering.kmeans(jax.random.PRNGKey(0),
                                         jnp.asarray(centers), ns,
                                         iters=10)[0])


@pytest.mark.parametrize("ns,cap", [(8, None), (8, 2), (4, 6), (2, None)])
def test_affinity_group_layout_matches_reference(ns, cap):
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(16, 12)).astype(np.float32)
    sizes = rng.integers(5, 120, 16)
    want = jdist.affinity_group_layout(centers, sizes, ns, slot_capacity=cap)
    got = dist.affinity_group_layout(centers, sizes, ns, slot_capacity=cap,
                                     seeds=_jax_seeds(centers, ns))
    np.testing.assert_array_equal(got, np.asarray(want))
    # its own seeds: a valid packing all the same
    own = dist.affinity_group_layout(centers, sizes, ns, slot_capacity=cap)
    assert own.shape == (16,) and (own < ns).all()
    if cap is not None:
        assert (np.bincount(own, minlength=ns) <= cap).all()


def test_affinity_layout_separates_blobs_and_degenerate_shapes():
    r = np.random.default_rng(0)
    centers = np.concatenate([r.normal(size=(12, 8)),
                              r.normal(size=(12, 8)) + 50.0]).astype(
                                  np.float32)
    # two region seeds in each blob (a k-means++ draw may put three in one)
    seeds = centers[[0, 1, 12, 13]]
    shard_of = dist.affinity_group_layout(centers, np.full((24,), 10), 4,
                                          slot_capacity=6, seeds=seeds)
    assert (np.bincount(shard_of, minlength=4) <= 6).all()
    assert not set(shard_of[:12].tolist()) & set(shard_of[12:].tolist())
    c = r.normal(size=(3, 4)).astype(np.float32)
    s = np.asarray([5, 1, 2])
    assert (dist.affinity_group_layout(c, s, 1) == 0).all()
    assert len(set(dist.affinity_group_layout(c, s, 8).tolist())) == 3


@pytest.mark.parametrize("n,ns", [(2000, 8), (2003, 8), (997, 4)])
def test_cluster_sharded_layout_matches_reference(n, ns):
    rng = np.random.default_rng(n)
    v = rng.normal(size=(n, 16)).astype(np.float32)
    centers = v[rng.choice(n, 4 * ns, replace=False)] + 0.01
    # the premise of a bit-equal permutation: both packages label every
    # row with the same nearest center
    labels = jclustering.assign(jnp.asarray(v), jnp.asarray(centers))
    np.testing.assert_array_equal(
        assign(torch.tensor(v), torch.tensor(centers)).numpy(),
        np.asarray(labels))
    perm, shard_of = dist.cluster_sharded_layout(
        torch.tensor(v), torch.tensor(centers), ns,
        seeds=_jax_seeds(centers, ns))
    want_perm, want_of = jdist.cluster_sharded_layout(jnp.asarray(v),
                                                      jnp.asarray(centers),
                                                      ns)
    np.testing.assert_array_equal(perm, np.asarray(want_perm))
    np.testing.assert_array_equal(shard_of, np.asarray(want_of))
    assert len(perm) == (n // ns) * ns and len(set(perm.tolist())) == len(perm)


# -- search functions, mesh helpers, axis rules --------------------------------

def test_sharded_and_routed_search_fns_match_global_search():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(1003, 16)).astype(np.float32))
    sq = torch.sum(x * x, dim=-1)
    q = torch.tensor(rng.normal(size=(5, 16)).astype(np.float32))
    mesh = mesh_mod.make_mesh((4, 2), ("data", "model"), device="cpu")
    want_v, want_i = ops.score_topk(x, sq, q, 12)
    for axes in (("data",), ("data", "model")):
        v, i = dist.sharded_search_fn(mesh, axes, 12)(x, sq, q)
        assert torch.equal(v, want_v) and torch.equal(i, want_i)
        v, i = dist.sharded_search_fn(mesh, axes, 12, k_local=4)(x, sq, q)
        assert (v[:, :4] == want_v[:, :4]).all()
    fn = dist.routed_search_fn(mesh, ("data", "model"), 12, degraded=True)
    probe = torch.zeros((5, 8), dtype=torch.bool)
    probe[:, 2] = probe[0, 5] = True
    alive = np.ones(8, bool)
    alive[5] = False
    v, i = fn(x, sq, q, probe, alive)
    nl = -(-1003 // 8)
    rows = torch.arange(2 * nl, 3 * nl)
    wv, wp = ops.score_topk(x[rows], sq[rows], q, 12)
    assert torch.equal(v, wv) and torch.equal(i, wp + 2 * nl)


def test_mesh_helpers_and_linear_index():
    m = mesh_mod.make_mesh((4, 2), ("data", "model"), device="cpu")
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert mesh_mod.mesh_devices(m) == 8
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert mesh_mod.make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    assert mesh_mod.make_host_mesh("cpu", n_shards=8).size == 8
    prod = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    for s in range(8):
        c = dist.shard_coords(s, ("data", "model"), (4, 2))
        assert dist.linear_shard_index(("data", "model"), (4, 2), c) == s
    assert len(slab.shard_devices(m, ("data",))) == 4
    with pytest.raises(ValueError):
        mesh_mod.make_mesh((0, 2), ("a", "b"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            mesh_mod.make_mesh((8, 1), ("data", "model"))


def test_axis_rules_drop_missing_axes_as_the_reference():
    from repro.launch.mesh import make_mesh as jmake_mesh

    jm = jmake_mesh((1, 1), ("data", "model"))
    pm = mesh_mod.make_mesh((1, 1), ("data", "model"), device="cpu")
    extra = {"corpus": ("data", "model"), "ivf_lists": "pod"}
    for rules in (None, extra):
        want = jsharding.AxisRules(jm, rules).rules
        got = AxisRules(pm, rules).rules
        for name in ("corpus", "ivf_lists", "none"):
            assert got[name] == want[name], name
    assert slab.resolve_axes(pm, AxisRules(pm), "corpus") == ("data",)
    assert AxisRules(pm).spec("corpus", None) == (("data",), None)
