"""The port's IVF backend (``repro_torch.index.ivf``) and ``fcvi`` over it,
against the JAX package's.

The JAX package builds the IVF index; its ``fcvi.index_state`` (or its
labels) is handed across, so the two packages' k-means never enter the
comparison. Probe near-ties are excluded first: a query whose nprobe-th and
(nprobe+1)-th centroid scores lie within the L2 tolerance may probe
different lists in the two frameworks (``probe_ties``); the fixed seeds
leave most queries clear, and the tests assert that. Tolerances: L2 scores
rtol 1e-5, atol 1e-4; combined scores atol 1e-5; ids equal outside
near-ties; the id lists and the gathered slabs exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")  # the card's machine has no JAX

from repro.core import clustering as jcl
from repro.core import fcvi as jfcvi
from repro.index import ivf as jivf
from repro_torch.core import fcvi
from repro_torch.data.synthetic import CorpusSpec, make_corpus, sample_queries
from repro_torch.index import flat, ivf
from test_torch_support import (assert_topk_match, probe_ties, tensor,
                                to_numpy_tree)

L2 = dict(rtol=1e-5, atol=1e-4)
COS = dict(rtol=0.0, atol=1e-5)
CFG = dict(backend="ivf", nlist=16, nprobe=4)


@pytest.fixture(scope="module")
def data():
    corpus = make_corpus(CorpusSpec(n=3000, d=64, n_categories=5,
                                    n_numeric=3, seed=2))
    q, fq = sample_queries(corpus, 24, seed=3)
    jidx = jfcvi.build(jnp.asarray(corpus.vectors),
                       jnp.asarray(corpus.filters), jfcvi.FCVIConfig(**CFG))
    mine = fcvi.index_from_state(fcvi.FCVIConfig(**CFG),
                                 to_numpy_tree(jfcvi.index_state(jidx)),
                                 device="cpu")
    qn, fqn = mine.transform.normalize(tensor(q), tensor(fq))
    q_t = mine.transform.apply_normalized(qn, fqn)
    return corpus, q, fq, jidx, mine, q_t


def _clear(index, q_t, nprobe, least=0.75):
    """Queries with no probe near-tie (asserting the seed leaves most)."""
    keep = ~probe_ties(index.centroids.numpy(), q_t.numpy(), nprobe)
    assert keep.mean() >= least, keep.mean()
    return keep


def test_build_from_handed_labels_matches_jax(data):
    _, _, _, jidx, _, _ = data
    jb = jidx.backend
    x = np.asarray(jb.vectors)
    labels = np.asarray(jcl.assign(jb.vectors, jb.centroids))
    lists, sizes = ivf.lists_from_labels(torch.tensor(labels), 16)
    np.testing.assert_array_equal(lists.numpy(), np.asarray(jb.lists))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jb.list_sizes))
    mine = ivf.from_lists(tensor(x), tensor(np.asarray(jb.centroids)), lists,
                          sizes)
    np.testing.assert_array_equal(mine.grouped.numpy(), np.asarray(jb.grouped))
    np.testing.assert_array_equal(mine.valid.numpy(), np.asarray(jb.valid))
    np.testing.assert_allclose(mine.grouped_sq.numpy(),
                               np.asarray(jb.grouped_sq), rtol=1e-6)

    # the port's own build on the same rows: one consistent layout
    own = ivf.build(tensor(x), 16, torch.Generator().manual_seed(0))
    ids = own.lists[own.lists >= 0]
    assert torch.equal(torch.sort(ids).values,
                       torch.arange(len(x), dtype=torch.int32))
    assert own.max_list % 8 == 0 and int(own.list_sizes.sum()) == len(x)
    for row, size in zip(own.lists, own.list_sizes):
        assert (row[:size] >= 0).all() and (row[size:] == -1).all()
        assert (torch.diff(row[:size]) > 0).all()          # ascending ids
    own_lists, _ = ivf.lists_from_labels(
        ivf.assign(tensor(x), own.centroids), 16)
    assert torch.equal(own_lists, own.lists)
    live = own.valid > 0.5
    assert torch.equal(own.grouped[live], tensor(x)[own.lists[live].long()])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_search_and_search_rows_match_jax(data, use_pallas):
    """The index_from_state index: ivf.search and ivf.search_rows against
    the JAX package's on the same transformed queries."""
    _, _, _, jidx, mine, q_t = data
    jb, be, k = jidx.backend, mine.backend, 10
    keep = _clear(be, q_t, 4)
    vals, ids = be.search(q_t, k, nprobe=4)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    jq = jnp.asarray(q_t.numpy())
    jv, ji = jivf.search(jb, jq, k, nprobe=4, use_pallas=use_pallas)
    nxt = np.asarray(jivf.search(jb, jq, k + 1, nprobe=4)[0])[:, -1]
    assert_topk_match(np.asarray(jv)[keep], np.asarray(ji)[keep],
                      vals[keep], ids[keep], **L2, next_vals=nxt[keep])

    vn, fn = mine.vectors_n, mine.filters_n
    rv, ri, rows_v, rows_f = be.search_rows(q_t, k, vn, fn, nprobe=4)
    assert torch.equal(rv, vals) and torch.equal(ri, ids)
    assert torch.equal(rows_v, vn[ids.long()])
    assert torch.equal(rows_f, fn[ids.long()])
    gpv = jivf.build_grouped_payload(jnp.asarray(vn.numpy()), jb.lists)
    gpf = jivf.build_grouped_payload(jnp.asarray(fn.numpy()), jb.lists)
    out = jivf.search_rows(jb, jq, k, jnp.asarray(vn.numpy()),
                           jnp.asarray(fn.numpy()), gpv, gpf, nprobe=4,
                           use_pallas=use_pallas)
    same = ids.numpy() == np.asarray(out[1])
    np.testing.assert_array_equal(rows_v.numpy()[same],
                                  np.asarray(out[2])[same])
    np.testing.assert_array_equal(rows_f.numpy()[same],
                                  np.asarray(out[3])[same])
    # the grouped payloads, as the engine builds them once
    np.testing.assert_array_equal(
        ivf.build_grouped_payload(vn, be.lists).numpy(), np.asarray(gpv))


def test_dead_slots_carry_id_zero_and_row_zero_payload(data):
    """k beyond the probed lists' rows: the tail is dead (-inf, id 0) and
    carries corpus row 0's payload, as the JAX package's id gather does."""
    _, _, _, jidx, mine, q_t = data
    be = mine.backend
    k = int(be.list_sizes.max()) + 1            # more than one list holds
    vals, ids, rows_v, _ = be.search_rows(q_t[:3], k, mine.vectors_n,
                                          mine.filters_n, nprobe=1)
    dead = torch.isneginf(vals)
    assert dead.any() and (ids[dead] == 0).all()
    assert torch.equal(rows_v[dead], mine.vectors_n[0].expand(
        int(dead.sum()), -1))
    jv, ji = jivf.search(jidx.backend, jnp.asarray(q_t[:3].numpy()), k,
                         nprobe=1)
    np.testing.assert_array_equal(np.isneginf(np.asarray(jv)), dead.numpy())


def test_full_probe_equals_flat(data):
    """nprobe = nlist scans every row: the same top-k as the flat backend
    (the model is tests/test_index.py's full-probe test)."""
    _, _, _, _, mine, q_t = data
    x = mine.backend.vectors
    own = ivf.build(x, 8, torch.Generator().manual_seed(1))
    vals, ids = ivf.search(own, q_t, 10, nprobe=8)
    fl = flat.build(x)
    fv, fi = flat.search(fl, q_t, 10)
    nxt = flat.search(fl, q_t, 11)[0][:, -1]
    assert_topk_match(fv, fi, vals, ids, **L2, next_vals=nxt)


def test_add_matches_jax(data):
    """Inserts join their nearest list after its rows. The new rows' two
    nearest centroids are farther apart than the L2 tolerance (asserted),
    so both packages assign them alike and the lists must be equal."""
    _, _, _, jidx, _, q_t = data
    x = np.asarray(jidx.backend.vectors)
    jsmall = jivf.build(jnp.asarray(x[:2500]), nlist=16)
    jgrown = jivf.add(jsmall, jnp.asarray(x[2500:]))
    small = ivf.from_lists(tensor(x[:2500]),
                           tensor(np.asarray(jsmall.centroids)),
                           torch.tensor(np.asarray(jsmall.lists)),
                           torch.tensor(np.asarray(jsmall.list_sizes)))
    assert not probe_ties(np.asarray(jsmall.centroids), x[2500:], 1).any()
    grown = ivf.add(small, tensor(x[2500:]))
    assert grown.size == 3000 and grown.max_list == jgrown.max_list
    np.testing.assert_array_equal(grown.lists.numpy(),
                                  np.asarray(jgrown.lists))
    np.testing.assert_array_equal(grown.list_sizes.numpy(),
                                  np.asarray(jgrown.list_sizes))
    np.testing.assert_array_equal(grown.grouped.numpy(),
                                  np.asarray(jgrown.grouped))
    keep = _clear(grown, q_t, 4)
    vals, ids = ivf.search(grown, q_t, 10, nprobe=4)
    jv, ji = jivf.search(jgrown, jnp.asarray(q_t.numpy()), 10, nprobe=4)
    assert_topk_match(np.asarray(jv)[keep], np.asarray(ji)[keep],
                      vals[keep], ids[keep], **L2)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fcvi_query_ivf_matches_jax(data, use_pallas):
    _, q, fq, jidx, mine, q_t = data
    jidx = dataclasses.replace(jidx, config=dataclasses.replace(
        jidx.config, use_pallas=use_pallas))
    keep = _clear(mine.backend, q_t, 4)
    vals, ids = fcvi.query(mine, tensor(q), tensor(fq), 10)
    jv, ji = jfcvi.query(jidx, jnp.asarray(q), jnp.asarray(fq), 10)
    assert_topk_match(np.asarray(jv)[keep], np.asarray(ji)[keep],
                      vals[keep], ids[keep], **COS)


def test_ivf_state_round_trip_and_build(data):
    corpus, q, fq, _, mine, _ = data
    again = fcvi.index_from_state(mine.config, fcvi.index_state(mine),
                                  device="cpu")
    for name in ("vectors", "centroids", "lists", "list_sizes", "grouped",
                 "grouped_sq", "valid"):
        assert torch.equal(getattr(again.backend, name),
                           getattr(mine.backend, name)), name
    # the port's own build, seeded: the same index twice
    cfg = fcvi.FCVIConfig(**CFG)
    one, two = (fcvi.build(corpus.vectors, corpus.filters, cfg, device="cpu",
                           rng=7) for _ in range(2))
    assert torch.equal(one.backend.lists, two.backend.lists)
    assert torch.equal(one.backend.centroids, two.backend.centroids)
    assert one.backend.nlist == 16
    vals, ids = fcvi.query(one, tensor(q), tensor(fq), 10)
    assert torch.isfinite(vals).all() and ((ids >= 0) & (ids < 3000)).all()
