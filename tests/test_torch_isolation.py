"""The port stands alone and never falls back quietly.

* Importing every ``repro_torch`` module, and ``chip_smoke.py``, leaves no
  ``jax`` and no ``repro``/``repro.*`` in ``sys.modules`` (checked in a fresh
  interpreter, since this test process imports both).
* The entry points default to ``device="cuda"`` and raise where there is no
  card; whether there is one is decided inside the test.
* No handler in the package catches an exception to fall back to the plain
  versions: the only ``except`` is the engine's retry on
  ``TransientShardError``.
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
                     or m == "repro" or m.startswith("repro."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_module_list_covers_every_slice():
    """The import check above walks the package, so each new module is in
    it; pin the IVF slice's modules there."""
    mods = set(_modules())
    assert {"repro_torch.core.clustering", "repro_torch.index.ivf",
            "repro_torch.index.slab", "repro_torch.kernels.ivf_score",
            "repro_torch.kernels.fused_score_topk"} <= mods


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from repro_torch.core import fcvi
    from repro_torch.serve.engine import FCVIEngine

    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 16)).astype(np.float32)
    f = rng.normal(size=(64, 4)).astype(np.float32)
    for cfg in (fcvi.FCVIConfig(), fcvi.FCVIConfig(backend="ivf", nlist=4)):
        with pytest.raises(RuntimeError, match="cuda"):
            fcvi.build(v, f, cfg)
    index = fcvi.build(v, f, fcvi.FCVIConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        fcvi.index_from_state(index.config, fcvi.index_state(index))
    with pytest.raises(RuntimeError, match="cuda"):
        FCVIEngine(index)


def test_no_handler_falls_back():
    handlers = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ExceptHandler):
                handlers.append((path.name, ast.unparse(node.type)
                                 if node.type is not None else "<bare>"))
    assert handlers == [("engine.py", "TransientShardError")], handlers
