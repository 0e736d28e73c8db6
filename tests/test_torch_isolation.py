"""The port stands alone and never falls back quietly.

* Importing every ``repro_torch`` module, and ``chip_smoke.py``, leaves no
  ``jax``, no ``repro``/``repro.*`` and no ``ml_dtypes`` (which the card's
  machine may lack; bf16 state arrives by bit pattern) in ``sys.modules``
  (checked in a fresh interpreter, since this test process imports both).
* The entry points default to ``device="cuda"`` and raise where there is no
  card; whether there is one is decided inside the test.
* No handler in the package catches an exception to fall back to the plain
  versions: the only ``except`` clauses are the engine's retry on
  ``TransientShardError``, the checkpoint module's four (the cleanup of a
  failed save, which re-raises; unreadable manifests and arrays turned
  into ``CheckpointCorruptError``; the walk back past corrupt steps) and
  the dry-run's one, which writes a cell's failure into that cell's JSON
  (``status: error``, as the reference's dry-run does) and fails the run.
"""
import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {str(ROOT)!r})
        for name in {list(_modules())!r}:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro.")
                     or m == "ml_dtypes")
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_module_list_covers_every_slice():
    """The import check above walks the package, so each new module is in
    it; pin the IVF, PQ, storage-ladder, checkpoint, sharded-serving, LM,
    training and shardings slices' modules there (the LM's MoE and
    recurrent mixers too)."""
    mods = set(_modules())
    assert {"repro_torch.core.clustering", "repro_torch.index.ivf",
            "repro_torch.index.slab", "repro_torch.kernels.ivf_score",
            "repro_torch.kernels.fused_score_topk", "repro_torch.index.pq",
            "repro_torch.kernels.pq_lut", "repro_torch.index.quant",
            "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
            "repro_torch.core.baselines", "repro_torch.launch.mesh",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.fault", "repro_torch.index.distributed",
            "repro_torch.serve.sharded", "repro_torch.serve.health",
            "repro_torch.serve.faultinject", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.model",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.gemma3_1b", "repro_torch.launch.serve",
            "repro_torch.models.moe", "repro_torch.models.recurrent",
            "repro_torch.data.tokens", "repro_torch.train",
            "repro_torch.train.optimizer", "repro_torch.train.loop",
            "repro_torch.distributed.compression", "repro_torch.launch.train",
            "repro_torch.launch.specs", "repro_torch.launch.cost_analysis",
            "repro_torch.launch.dryrun"} <= mods


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.core import fcvi
    from repro_torch.serve.engine import FCVIEngine

    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 16)).astype(np.float32)
    f = rng.normal(size=(64, 4)).astype(np.float32)
    for cfg in (fcvi.FCVIConfig(), fcvi.FCVIConfig(backend="ivf", nlist=4),
                fcvi.FCVIConfig(backend="pq", pq_ksub=16, pq_coarse=2),
                fcvi.FCVIConfig(storage_dtype="int8"),
                fcvi.FCVIConfig(backend="ivf", nlist=4,
                                storage_dtype="bfloat16")):
        with pytest.raises(RuntimeError, match="cuda"):
            fcvi.build(v, f, cfg)
        index = fcvi.build(v, f, cfg, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            fcvi.index_from_state(index.config, fcvi.index_state(index))
        with pytest.raises(RuntimeError, match="cuda"):
            FCVIEngine(index)


def test_engine_restore_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.core import baselines, fcvi
    from repro_torch.serve.engine import FCVIEngine

    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 16)).astype(np.float32)
    f = rng.normal(size=(64, 4)).astype(np.float32)
    FCVIEngine(fcvi.build(v, f, fcvi.FCVIConfig(), device="cpu"),
               device="cpu").save(str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        FCVIEngine.restore(str(tmp_path))
    assert FCVIEngine.restore(str(tmp_path), device="cpu").index.size == 64
    with pytest.raises(RuntimeError, match="cuda"):
        baselines.build_hybrid(v, f)


def test_lm_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import serve, train
    from repro_torch.models import model as lm

    cfg = reduced(get_config("gemma3-1b"))
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.params_from_jax({}, cfg)
    for arch in ("granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-125m",
                 "whisper-large-v3", "dbrx-132b"):
        other = reduced(get_config(arch))
        with pytest.raises(RuntimeError, match="cuda"):
            lm.init_params(0, other)
        with pytest.raises(RuntimeError, match="cuda"):
            lm.init_cache(other, 1, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cross_cache(reduced(get_config("whisper-large-v3")), 1, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--n", "64"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--steps", "1"])


def test_dryrun_cells_trace_on_meta_and_run_only_on_a_card():
    """The dry-run's cells are built on meta positions by design; asked to
    run for real they default to nothing and raise for a card that is not
    there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="cuda"):
        make_production_mesh()
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    cell = specs.build_cell(reduced(get_config("gemma3-1b")), "gemma3-1b",
                            "decode_32k", mesh)
    assert all(p.blocks.flat[0].is_meta for p in cell.inputs["params"]
               .values())
    with pytest.raises(RuntimeError, match="cuda"):
        specs.build_cell(reduced(get_config("gemma3-1b")), "gemma3-1b",
                         "decode_32k", mesh, device="cuda")
    small = dict(n=64, d=16, m=4, batch=4, k=2, kprime=4)
    assert specs.build_fcvi_cell(small, mesh).inputs["corpus_t"].blocks \
        .flat[0].is_meta
    with pytest.raises(RuntimeError, match="cuda"):
        specs.build_fcvi_cell(small, mesh, device="cuda")


def test_no_handler_falls_back():
    handlers = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ExceptHandler):
                handlers.append((path.name, ast.unparse(node.type)
                                 if node.type is not None else "<bare>"))
    assert sorted(handlers) == [
        ("ckpt.py", "(OSError, ValueError)"),
        ("ckpt.py", "BaseException"),
        ("ckpt.py", "CheckpointCorruptError"),
        ("ckpt.py", "_UNREADABLE"),
        ("dryrun.py", "Exception"),
        ("engine.py", "TransientShardError")], handlers
