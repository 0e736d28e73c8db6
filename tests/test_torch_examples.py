"""The port's four examples on the CPU against the JAX examples they follow.

Each ``examples/*_torch.py`` runs its ``main`` with ``--device cpu`` and
returns the numbers it prints; the JAX example runs in the same process
and its printed numbers are parsed. The port's must equal them to within
one result slot in 100 (near-ties may order differently in the two
frameworks), and they must hold what the examples are there to show:
FCVI's recall@10 against the combined-score oracle >= 0.95, FCVI above
post-filtering under the selective predicate, every verified multi-probe
result inside the range and recall not falling as r grows, recall
>= 0.85 under every distribution shift with the index not rebuilt, and
the predicate example's plans, selectivities and ids (its sharded part on
8 shards of ``make_host_mesh``).
"""
import importlib.util
import pathlib
import re

import pytest

pytest.importorskip("jax")  # the card's machine has no JAX

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
SLOT = 0.01


def _load(name):
    spec = importlib.util.spec_from_file_location(f"ex_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(capsys, name):
    """The numbers the JAX example prints, line by line."""
    _load(name).main()
    return [[float(x) for x in re.findall(r"\d+\.\d+", line)]
            for line in capsys.readouterr().out.splitlines()]


def test_quickstart(capsys):
    jax_lines = _printed(capsys, "quickstart")
    out = _load("quickstart_torch").main(["--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert len(mine) == len(jax_lines) == 4
    (recall,), (sel,), (post, fcvi) = jax_lines[1:]
    assert out["recall"] == pytest.approx(recall, abs=SLOT)
    assert 100 * out["selectivity"] == pytest.approx(sel, abs=0.05)
    assert out["post_recall"] == pytest.approx(post, abs=SLOT)
    assert out["fcvi_recall"] == pytest.approx(fcvi, abs=SLOT)
    assert out["recall"] >= 0.95
    assert out["fcvi_recall"] > out["post_recall"]


def test_multiprobe_range_filters(capsys):
    jax_lines = _printed(capsys, "multiprobe_range_filters")
    out = _load("multiprobe_range_filters_torch").main(["--device", "cpu"])
    capsys.readouterr()
    assert 100 * out["selectivity"] == pytest.approx(jax_lines[0][0],
                                                     abs=0.05)
    rs = (1, 2, 4, 8)
    for r, line in zip(rs, jax_lines[2:]):
        assert out["recall"][r] == pytest.approx(line[0], abs=SLOT)
        assert out["in_range"][r] == 1.0 and line[1] == 100.0
    assert all(out["recall"][a] <= out["recall"][b] + 1e-9
               for a, b in zip(rs, rs[1:]))


def test_distribution_shift(capsys):
    jax_lines = _printed(capsys, "distribution_shift")
    out = _load("distribution_shift_torch").main(["--device", "cpu"])
    capsys.readouterr()
    keys = ("baseline", "filter_shift", "vector_shift", "query_shift")
    for key, line in zip(keys, jax_lines):
        assert out[key] == pytest.approx(line[0], abs=SLOT)
        assert out[key] >= 0.85


def test_filtered_predicates(capsys):
    """The plans, the estimated selectivities, query 0's top ids and the
    plan counters equal the JAX example's printed ones (the predicate
    results are exact, so the ids are the same), and the port's 8-shard
    engines answer as its meshless ones (asserted inside)."""
    _load("filtered_predicates").main()
    lines = capsys.readouterr().out.splitlines()
    out = _load("filtered_predicates_torch").main(["--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert len(mine) == len(lines) == 8
    for j, line in enumerate(lines[:3]):
        sel = float(re.search(r"est_sel=(\d+\.\d+)", line).group(1))
        assert round(out["est_sel"][j], 3) == pytest.approx(sel, abs=1e-9)
        assert out["plans"][j] == re.search(r"plan=(\w+)", line).group(1)
        ids = [int(x) for x in re.search(r"ids=\[([^]]*)\]", line)
               .group(1).split(",")]
        assert out["top"][j] == ids
    assert list(out["stats"]) == [int(x) for x in
                                  re.findall(r"\d+", lines[-1])]
    assert mine[:6] == lines[:6] and mine[-1] == lines[-1]
    assert "sharded (8 shards" in mine[6]


def test_examples_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    for name in ("quickstart_torch", "multiprobe_range_filters_torch",
                 "distribution_shift_torch", "filtered_predicates_torch",
                 "serve_filtered_search_torch"):
        with pytest.raises(RuntimeError, match="cuda"):
            _load(name).main([])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--n", "64"])
