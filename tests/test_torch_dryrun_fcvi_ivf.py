"""The FCVI cell's IVF layouts (``launch.specs.build_fcvi_cell``'s
``ivf8``, ``ivf8-trunc`` and ``opt``) against the reference's cells, at
n = 2^14 on a (2, 2) ("data", "model") mesh (4 blocks of 64 lists of 64
rows), d = 128, m = 8, 128 queries (two of the reference's 64-query
chunks), k = 10 and k' = 160, so that ``ivf8-trunc``'s last merge stage
pools 2 x 64 = 128 candidates and pads 32 slots.

The inputs are drawn with numpy from a seed and laid out by the port's
``ivf_layout``; the same numpy arrays go through the reference's
``serve_step`` (one JAX subprocess with 4 forced host devices, which also
compiles each cell for ``hlo_analysis``, started with the module) and the
port's cell on CPU positions (B7's plain version). Held:

* each variant's per-position dot FLOPs within ``FLOPS_RTOL`` of the
  reference's compiled cell (the base cell's rule in
  ``test_torch_dryrun_cells.py``), and ``opt``'s all-reduce 4 b k' 4
  bytes a position;
* the meta trace equal to the trace on CPU tensors: FLOPs, op-boundary
  bytes and collectives exactly (a kernel entry records its kernel's
  work on either device);
* B7's count on meta equal to the hand count;
* the cell equal to the pipeline computed whole in torch (probes by the
  same product, every probed slot scored at once in fp64, the cuts,
  truncation, pads and re-rank): candidates and top-k ids equal outside
  near-ties of fp32 width (``fp32_width``), pads included;
* the cell against the reference's ``serve_step``: candidates (the
  reference's cell at k = k', whose top-k' is every candidate) and top-k
  ids equal outside near-ties whose width includes the reference's bf16
  rounding of each dot product (``bf16_width``: half a bf16 ulp of
  2 |q.x|, which B7's fp32 sum does not round away), queries with a
  probe near-tie left out; re-rank scores of the common ids within
  ``COS_TOL``;
* ``opt`` bit-equal to ``ivf8-trunc`` on the CPU.

A candidate is a near-tie at a cut (a block's k', a merge stage's keep,
the re-rank's k) when its score lies within its width plus the pool's
largest width of the last kept or first dropped score; two computations
of the cell may keep either such candidate.
"""
import collections
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the card's machine has no JAX

from repro_torch.core.transform import psi_partition  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import topk_first  # noqa: E402
from repro_torch.launch import cost_analysis as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from test_torch_support import one_thread  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
INFO = dict(n=1 << 14, d=128, m=8, batch=128, k=10, kprime=160)
MESH = ((2, 2), ("data", "model"))
VARIANTS = ("ivf8", "ivf8-trunc", "opt")
FLOPS_RTOL = 0.10            # test_torch_dryrun_cells.py's rule
L2_RTOL, L2_ATOL = 1e-5, 1e-4  # fp32 sums of 128 products, scores ~ 10
COS_TOL = 1e-6               # the re-rank's cosines, two fp32 computations
PROBE_RTOL = 1e-5            # the probes' fp32 products, XLA's and torch's
NAMES = ("grouped", "grouped_sq", "centroids", "vectors_n", "filters_n",
         "q", "fq")

REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    import ml_dtypes
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.sharding import use_rules
    from repro.launch import hlo_analysis as H
    from repro.launch import specs as S
    from repro.launch.mesh import make_mesh

    info, src, dst = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    names = sys.argv[4].split(",")
    data = np.load(src)
    args = [data[k].view(ml_dtypes.bfloat16) if k == "grouped" else data[k]
            for k in names]
    S.FCVI_SHAPES["t_ivf"] = info
    S.FCVI_SHAPES["t_ivf_all"] = dict(info, k=info["kprime"])
    mesh = make_mesh((2, 2), ("data", "model"))
    sh = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                is_leaf=lambda x: isinstance(x, P))
    out, arrays = {}, {}
    for variant in ("ivf8", "ivf8-trunc", "opt"):
        for shape in ("t_ivf", "t_ivf_all"):
            cell = S.build_fcvi_cell(shape, mesh, variant=variant)
            with use_rules(cell.rules):
                fn = jax.jit(cell.step_fn, in_shardings=sh(cell.in_pspecs),
                             out_shardings=sh(cell.out_pspecs))
                if shape == "t_ivf":
                    res = H.analyze(fn.lower(*cell.in_sds).compile()
                                    .as_text())
                    out[variant] = {"flops": res["flops"], "collectives": {
                        k: v["bytes"] for k, v in
                        res["collectives"].items()}}
                vals, ids = fn(*args)
            arrays[f"{variant}|{shape}|vals"] = np.asarray(vals)
            arrays[f"{variant}|{shape}|ids"] = np.asarray(ids)
    np.savez(dst, **arrays)
    print(json.dumps(out))
""")


def _inputs() -> dict:
    """Rows, filters and queries drawn with numpy from seed 0, the rows'
    psi transform laid out by ``ivf_layout`` over the mesh's 4 blocks."""
    r = np.random.default_rng(0)
    n, d, m, b = (INFO[k] for k in ("n", "d", "m", "batch"))
    v = r.standard_normal((n, d)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = r.random((n, m)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    q = r.standard_normal((b, d)).astype(np.float32)
    fq = r.random((b, m)).astype(np.float32)
    v, f = torch.tensor(v), torch.tensor(f)
    out = SP.ivf_layout(psi_partition(v, f, 1.0), 4,
                        torch.Generator().manual_seed(0))
    order = out.pop("order")
    return dict(out, vectors_n=v[order], filters_n=f[order],
                q=torch.tensor(q), fq=torch.tensor(fq))


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    """The reference's cells on ``data``: ``get()`` -> (per variant dot
    FLOPs and collective bytes, {"variant|shape|vals"/"ids": array}),
    started with the module while the port traces."""
    tmp = tmp_path_factory.mktemp("ref")
    src, dst = tmp / "in.npz", tmp / "out.npz"
    np.savez(src, **{k: (t.view(torch.int16) if t.dtype == torch.bfloat16
                         else t).numpy() for k, t in data.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(INFO), str(src),
         str(dst), ",".join(NAMES)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    got = {}

    def get():
        if not got:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            got["counts"] = json.loads(out.strip().splitlines()[-1])
            with np.load(dst) as z:
                got["arrays"] = {k: z[k] for k in z.files}
        return got["counts"], got["arrays"]

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _mesh(device):
    return make_mesh(*MESH, device=device)


def _run(data, variant):
    cell = SP.build_fcvi_cell(INFO, _mesh("cpu"), variant=variant,
                              device="cpu", data=dict(data))
    return cell.run(S.CollectiveStats())


# -- the pipeline computed whole ----------------------------------------------

def fp32_width(dot: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    return L2_ATOL + L2_RTOL * score.abs()


def bf16_width(dot: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    """``fp32_width`` plus the reference's rounding of the dot product to
    bf16 before it is doubled: half a bf16 ulp of 2 |q.x| (8 significant
    bits)."""
    ulp = torch.exp2(torch.floor(torch.log2(dot.abs().clamp_min(1e-30)))
                     - 7.0)
    return fp32_width(dot, score) + ulp


def _cut(v, i, w, keep, amb):
    """A stage's first-occurrence top-``keep`` of (v, i) with widths w;
    marks in ``amb`` (b, n) the candidates that are near-ties at its
    cut."""
    if keep > v.shape[1]:        # the pool is smaller: pads (-inf, id 0)
        pad = keep - v.shape[1]
        v = torch.cat([v, v.new_full((v.shape[0], pad), float("-inf"))], 1)
        i = torch.cat([i, i.new_zeros((i.shape[0], pad))], 1)
        w = torch.cat([w, w.new_zeros((w.shape[0], pad))], 1)
    _, pos = topk_first(v, v.shape[1])
    v, i, w = (torch.gather(t, 1, pos) for t in (v, i, w))
    if keep < v.shape[1]:
        wide = w.max(dim=1, keepdim=True).values
        near = ((v >= v[:, keep:keep + 1] - w - wide)
                & (v <= v[:, keep - 1:keep] + w + wide))
        rows = torch.arange(v.shape[0])[:, None].expand_as(i)
        amb[rows[near], i[near]] = True
    return v[:, :keep], i[:, :keep], w[:, :keep]


def whole(x: dict, variant: str, width) -> dict:
    """The cell computed whole: each block's probes by the cell's own fp32
    product, every probed slot's exact score (fp64 of the bf16 rows and
    queries, less the stored norms), the block's cut, the merge stages
    over the mesh (the model axis first), the last stage's pads, the
    re-rank of the candidates and its top-k. Returns the candidates, the
    top-k (scores, ids), the near-tie candidates (b, n) at every cut (L2
    cuts at ``width``, the re-rank's at ``COS_TOL``) and the queries with
    a probe near-tie."""
    kprime, k = INFO["kprime"], INFO["k"]
    kl = SP.K_LOCAL if variant in ("ivf8-trunc", "opt") else kprime
    q, fq = x["q"], x["fq"]
    q_t = psi_partition(q, fq, 1.0)
    q_b = q_t.to(torch.bfloat16).double()
    shards, nl, ls, _ = x["grouped"].shape
    b = q.shape[0]
    amb = torch.zeros((b, shards * nl * ls), dtype=torch.bool)
    probe_tie = torch.zeros(b, dtype=torch.bool)
    sets = []
    for s in range(shards):
        cd = q_t @ x["centroids"][s].T
        srt = torch.sort(cd.double(), dim=1, descending=True).values
        probe_tie |= (srt[:, SP.NPROBE - 1] - srt[:, SP.NPROBE]
                      <= PROBE_RTOL * srt[:, SP.NPROBE - 1].abs())
        probes = topk_first(cd, SP.NPROBE)[1]
        dot = torch.einsum("bd,nld->bnl", q_b, x["grouped"][s].double())
        sc = 2.0 * dot - x["grouped_sq"][s].double()
        w = width(dot, sc)
        pick = probes[:, :, None].expand(-1, -1, ls)
        ids = (s * nl * ls + torch.arange(nl * ls)).reshape(1, nl, ls)
        ids = ids.expand(b, -1, -1)
        sets.append(_cut(*(torch.gather(t, 1, pick).reshape(b, -1)
                           for t in (sc, ids, w)), kl, amb))
    fan = MESH[0][::-1]
    for j, n_ax in enumerate(fan):
        keep = kprime if j == len(fan) - 1 else kl
        sets = [_cut(*(torch.cat([st[t] for st in sets[g:g + n_ax]], 1)
                       for t in range(3)), keep, amb)
                for g in range(0, len(sets), n_ax)]
    cand = sets[0][1]

    def cos(c, qv):
        return torch.sum(c * qv[:, None], -1) / (
            torch.linalg.norm(c, dim=-1)
            * torch.linalg.norm(qv, dim=-1)[:, None] + 1e-8)

    score = 0.5 * cos(x["vectors_n"][cand], q) + 0.5 * cos(
        x["filters_n"][cand], fq)
    amb_r = torch.zeros_like(amb)
    _, pos = topk_first(score, score.shape[1])
    srt = torch.gather(score, 1, pos).double()
    near = ((srt >= srt[:, k:k + 1] - 2 * COS_TOL)
            & (srt <= srt[:, k - 1:k] + 2 * COS_TOL))
    rows = torch.arange(b)[:, None].expand_as(pos)
    amb_r[rows[near], torch.gather(cand, 1, pos)[near]] = True
    return {"cand": cand, "vals": srt[:, :k].float(),
            "ids": torch.gather(cand, 1, pos[:, :k]), "amb": amb,
            "amb_r": amb_r, "probe_tie": probe_tie}


def differ_outside_ties(got, want, amb, skip=None) -> tuple:
    """(queries compared, ids of ``got`` and ``want`` (b, x) differing as
    multisets outside ``amb``'s near-ties, [(query, id)])."""
    bad, compared = [], 0
    for qi in range(got.shape[0]):
        if skip is not None and bool(skip[qi]):
            continue
        compared += 1
        a = collections.Counter(got[qi].tolist())
        w = collections.Counter(want[qi].tolist())
        bad += [(qi, e) for e in ((a - w) + (w - a)) if not amb[qi, e]]
    return compared, bad


# -- tests ------------------------------------------------------------------

def test_ivf_layout(data):
    """Equal lists, each list's rows the psi rows of ``vectors_n`` /
    ``filters_n`` at their global ids, centroids the lists' means, and
    the refusals of sizes the reference's scan would cut."""
    g, n = data["grouped"], INFO["n"]
    assert tuple(g.shape) == (4, SP.NLIST, n // 4 // SP.NLIST, INFO["d"])
    psi = psi_partition(data["vectors_n"], data["filters_n"], 1.0)
    assert torch.equal(g.reshape(n, -1), psi.to(torch.bfloat16))
    assert torch.equal(data["grouped_sq"].reshape(n),
                       torch.sum(g.reshape(n, -1).float() ** 2, -1))
    np.testing.assert_allclose(data["centroids"], psi.reshape(
        g.shape).mean(2), rtol=1e-5, atol=1e-6)
    for bad in (dict(n=n + 4), dict(n=4 * SP.NLIST * 3 + 4),
                dict(batch=100)):
        with pytest.raises(ValueError):
            SP.build_fcvi_cell(dict(INFO, **bad), _mesh("meta"),
                               variant="ivf8")


def test_b7_meta_count_is_the_hand_count():
    """B7 on meta in a cost trace records 2 b nprobe max_list d FLOPs and
    the bytes of the lists the probes can reach (each with its norms and
    valid row), the queries, probes and (b, k) outputs; outside a trace it
    raises."""
    for b, nprobe, nlist, ls, d, k in ((2, 3, 64, 32, 128, 7),
                                       (16, 8, 64, 32, 96, 40)):
        e = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
            s, dtype=dt, device="meta")
        args = (e(nlist, ls, d, dt=torch.bfloat16), e(nlist, ls), e(nlist, ls),
                e(b, nprobe, dt=torch.int32), e(b, d), k)
        with pytest.raises(RuntimeError):
            ops.ivf_score_topk_batch(*args)
        with C.CostMode() as cm:
            vals, ids = ops.ivf_score_topk_batch(*args)
        lists = min(nlist, b * nprobe)
        want = (lists * ls * (d * 2 + 4 + 4) + b * nprobe * 4 + b * d * 4
                + b * k * (4 + 4))
        rec = cm.kernels["ivf_score_topk_batch"]
        assert (rec["calls"], rec["flops"], rec["bytes"]) == (
            1, 2.0 * b * nprobe * ls * d, want)
        assert vals.shape == ids.shape == (b, k)
        assert ids.dtype == torch.int32


@pytest.mark.parametrize("variant", VARIANTS)
def test_meta_trace_equals_cpu_trace(variant, data, one_thread):
    mesh, cpu_mesh = _mesh("meta"), _mesh("cpu")
    meta = D.trace(lambda: SP.build_fcvi_cell(INFO, mesh, variant=variant),
                   mesh)
    cpu = D.trace(lambda: SP.build_fcvi_cell(
        INFO, cpu_mesh, variant=variant, device="cpu", data=dict(data)),
        cpu_mesh)
    assert meta["kernels"]["ivf_score_topk_batch"]["calls"] == 4
    for key in ("flops", "conv_flops", "bytes"):
        assert np.array_equal(meta[key], cpu[key]), key
    assert ({k: (v["bytes"], v["count"], v["by_axis"])
             for k, v in meta["stats"].by_kind.items()}
            == {k: (v["bytes"], v["count"], v["by_axis"])
                for k, v in cpu["stats"].by_kind.items()})


@pytest.mark.parametrize("variant", VARIANTS)
def test_flops_and_collectives_against_reference(variant, reference):
    mesh = _mesh("meta")
    t = D.trace(lambda: SP.build_fcvi_cell(INFO, mesh, variant=variant),
                mesh)
    ref = reference()[0][variant]
    flops = float(t["flops"].max())
    mine = {k: v["bytes"] / 4 for k, v in t["stats"].by_kind.items()}
    print(f"fcvi {variant}: dot FLOPs a position {flops:.6g}, the "
          f"reference's {ref['flops']:.6g} (ratio {flops / ref['flops']:.4f});"
          f" collective bytes a position {mine} (reference "
          f"{ref['collectives']})")
    assert flops == pytest.approx(ref["flops"], rel=FLOPS_RTOL)
    b, kp = INFO["batch"], INFO["kprime"]
    gathers = b * 8 * (kp if variant == "ivf8" else SP.K_LOCAL) * 2
    assert mine["all-gather"] == gathers
    if variant == "opt":
        assert mine["all-reduce"] == 4 * b * kp * 4
    else:
        assert mine["all-reduce"] == b * kp * (INFO["d"] + INFO["m"]) * 4


@pytest.mark.parametrize("variant", VARIANTS)
def test_cell_equals_the_pipeline_computed_whole(variant, data, one_thread):
    vals, ids, cand = _run(data, variant)
    w = whole(data, variant, fp32_width)
    if variant != "ivf8":      # the last stage pools 2 x 64: 32 pads
        assert bool((torch.sum(cand == 0, 1) >= 32).all())
    n, bad = differ_outside_ties(cand, w["cand"], w["amb"])
    assert not bad, bad[:5]
    n, bad = differ_outside_ties(ids, w["ids"], w["amb"] | w["amb_r"])
    assert not bad, bad[:5]
    same = ids.long() == w["ids"]
    np.testing.assert_allclose(vals[same], w["vals"][same], rtol=0,
                               atol=COS_TOL)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cell_against_reference(variant, data, reference, one_thread):
    arrays = reference()[1]
    vals, ids, cand = _run(data, variant)
    w = whole(data, variant, bf16_width)
    skip = w["probe_tie"]
    r_cand = torch.tensor(arrays[f"{variant}|t_ivf_all|ids"]).long()
    r_vals = torch.tensor(arrays[f"{variant}|t_ivf|vals"])
    r_ids = torch.tensor(arrays[f"{variant}|t_ivf|ids"]).long()
    n, bad_c = differ_outside_ties(cand, r_cand, w["amb"], skip)
    _, bad = differ_outside_ties(ids, r_ids, w["amb"] | w["amb_r"], skip)
    same = (ids.long() == r_ids) & ~skip[:, None]
    differ = int((ids.long() != r_ids)[~skip].sum())
    rows = torch.arange(ids.shape[0])[:, None].expand_as(ids)
    clear = ~(w["amb"] | w["amb_r"])[rows, ids.long()] & ~skip[:, None]
    print(f"fcvi {variant} against the reference: {n} of {INFO['batch']} "
          f"queries compared ({int(skip.sum())} with a probe near-tie); "
          f"top-k slots differing {differ} of {n * INFO['k']}, all at "
          f"near-ties: {not bad}; slots clear of every near-tie "
          f"{int(clear.sum())}; pads a query {int((cand == 0).sum(1).max())}"
          f" (the reference's {int((r_cand == 0).sum(1).max())})")
    assert n >= 0.9 * INFO["batch"]
    assert not bad_c, bad_c[:5]
    assert not bad, bad[:5]
    assert int(clear.sum()) >= 0.5 * n * INFO["k"]
    np.testing.assert_allclose(vals[same], r_vals[same], rtol=0,
                               atol=COS_TOL)


def test_opt_equals_trunc_bit_for_bit(data, one_thread):
    """The compute-to-data re-rank's partials, summed in block order, are
    the holders' values: ``opt`` returns ``ivf8-trunc``'s bits."""
    a, b = _run(data, "opt"), _run(data, "ivf8-trunc")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_opt_partials_at_serve_268m():
    """``opt`` traced on the 16 x 16 production mesh of meta positions:
    the partials' all-reduce is 4 b k' 4 = 6,553,600 bytes a position,
    against the row gather's b k' (d + m) 4 = 222,822,400 of
    ``ivf8-trunc``."""
    got = {}
    for variant in ("opt", "ivf8-trunc"):
        r = D.run_fcvi_cell("serve_268m", False, verbose=False,
                            fcvi_variant=variant)
        assert r["status"] == "ok"
        got[variant] = r["collectives"]["all-reduce"]["bytes"] / 256
    assert got == {"opt": 6_553_600, "ivf8-trunc": 222_822_400}
