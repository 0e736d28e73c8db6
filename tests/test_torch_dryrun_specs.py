"""The dry-run's input specs and cell facts in the port
(``repro_torch.launch.specs``, ``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.specs``, ``repro.launch.dryrun``) for all ten
archs, the four ``SHAPES`` and both production meshes, with no compile: the
reference's shapes come from ``jax.eval_shape``, its ``AxisRules`` from a
stand-in mesh (axis names and a device array's shape), the port's from
meta tensors.

The port keeps one cache a layer where the reference stacks each pattern
slot over periods (``scan``) and keeps the remainder apart (``rest``): a
stacked leaf's layer p of slot j is layer p * period + j, its spec without
the leading periods entry.
"""
import functools
import os
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DTYPES = {torch.int32: "int32", torch.float32: "float32",
          torch.bfloat16: "bfloat16"}


def _reference_dryrun():
    """``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import; keep the
    environment as it was (this process's devices are already fixed)."""
    keep = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as JD
    finally:
        if keep is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = keep
    return JD


JD = _reference_dryrun()


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _spec(s) -> tuple:
    return tuple(_entry(e) for e in s)


def _rules(arch, shape, mesh_key):
    """The cell's rules in both packages, as each ``build_cell`` sets
    them (the reference's from its own tables)."""
    shp, axes = MESHES[mesh_key]
    info = JSP.SHAPES[shape]
    port = SP._cell_rules(arch, info["kind"], info["batch"],
                          make_mesh(shp, axes, device="meta"), None)
    extra = {}
    if info["kind"] in ("prefill", "decode"):
        extra = dict(JSP.SERVE_EXTRA_RULES.get(arch, {}))
    if info["kind"] == "train":
        extra = dict(JSP.TRAIN_EXTRA_RULES.get(arch, {}))
    if info["kind"] == "decode" and info["batch"] == 1:
        extra.setdefault("batch", None)
        extra.setdefault("kv_seq", ("data", "model"))
    ref = JSP.arch_rules(_stand_in(shp, axes), arch, extra)
    assert {k: _entry(v) for k, v in port.rules.items()} == \
        {k: _entry(v) for k, v in ref.rules.items()}
    return port, ref


def _layers(cfg, ref_tree):
    """The reference's stacked per-slot tree as one entry a layer."""
    out = [None] * cfg.n_layers
    for j, slot in enumerate(ref_tree["scan"]):
        for p in range(cfg.n_periods):
            out[p * cfg.period + j] = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), slot)
    for i, c in enumerate(ref_tree["rest"]):
        out[cfg.n_periods * cfg.period + i] = c
    return out


def _spec_layers(cfg, ref_tree):
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    out = [None] * cfg.n_layers
    for j, slot in enumerate(ref_tree["scan"]):
        for p in range(cfg.n_periods):
            out[p * cfg.period + j] = jax.tree.map(
                lambda s: _spec(tuple(s)[1:]), slot, is_leaf=is_p)
    for i, c in enumerate(ref_tree["rest"]):
        out[cfg.n_periods * cfg.period + i] = jax.tree.map(
            lambda s: _spec(s), c, is_leaf=is_p)
    return out


def _sig(t):
    if isinstance(t, torch.Tensor):
        return (tuple(t.shape), DTYPES[t.dtype])
    return (tuple(t.shape), str(t.dtype))


CASES = [(a, s, m) for a in list_archs() for s in SP.SHAPES for m in MESHES]


@pytest.mark.parametrize("arch,shape,mesh_key", CASES)
def test_cell_inputs_and_specs_equal_the_reference(arch, shape, mesh_key):
    cfg, jcfg = get_config(arch), jget_config(arch)
    ok, reason = SP.cell_applicable(cfg, shape)
    assert (ok, reason) == JSP.cell_applicable(jcfg, shape)
    assert D.tokens_of(cfg, shape) == JD.tokens_of(jcfg, shape)
    if not ok:
        return
    info = SP.SHAPES[shape]
    seq, batch, kind = info["seq"], info["batch"], info["kind"]
    port_rules, ref_rules = _rules(arch, shape, mesh_key)
    if kind in ("train", "prefill"):
        pb = SP.train_batch_specs(cfg, seq, batch)
        jb = JSP.train_batch_specs(jcfg, seq, batch)
        assert {k: _sig(v) for k, v in pb.items()} == \
            {k: _sig(v) for k, v in jb.items()}
        assert {k: _spec(v) for k, v in SP.batch_pspecs(
            cfg, pb, port_rules).items()} == {k: _spec(v) for k, v in
                                             JSP.batch_pspecs(
                                                 jcfg, jb, ref_rules).items()}
        return
    token, cache = SP.decode_input_specs(cfg, seq, batch)
    jtoken, jcache = JSP.decode_input_specs(jcfg, seq, batch)
    assert _sig(token) == _sig(jtoken)
    ref_self = _layers(cfg, jcache["self"])
    assert [{k: _sig(v) for k, v in c.items()} for c in cache["self"]] == \
        [{k: _sig(v) for k, v in c.items()} for c in ref_self]
    specs = SP.cache_pspecs(cfg, port_rules, cfg.enc_dec)
    jspecs = JSP.cache_pspecs(jcfg, ref_rules, jcfg.enc_dec)
    assert [{k: _spec(v) for k, v in c.items()} for c in specs["self"]] == \
        _spec_layers(cfg, jspecs["self"])
    if cfg.enc_dec:
        ref_cross = _layers(cfg, jcache["cross"])
        assert [tuple(_sig(t) for t in kv) for kv in cache["cross"]] == \
            [tuple(_sig(t) for t in kv) for kv in ref_cross]
        assert [tuple(_spec(s) for s in kv) for kv in specs["cross"]] == \
            [tuple(_spec(s) for s in kv)
             for kv in _spec_layers(cfg, jspecs["cross"])]
    else:
        assert cache["cross"] is None and specs["cross"] is None


@functools.lru_cache(maxsize=None)
def _ref_param_sds(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("arch", list_archs())
def test_params_total_and_active_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    named = dict(M.Model(cfg, torch.device("meta")).named_parameters())
    sds = _ref_param_sds(arch)
    assert sum(int(np.prod(p.shape)) for p in named.values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(sds))
    assert D.active_params(cfg, named) == JD.active_params(jcfg, sds)


def test_dryrun_tables_agree():
    """The constants the two dry-runs share."""
    assert D.N_MICRO == JD.N_MICRO
    assert SP.SHAPES == JSP.SHAPES and SP.FCVI_SHAPES == JSP.FCVI_SHAPES
    assert SP.WHISPER_DEC_LEN == JSP.WHISPER_DEC_LEN
    for name in ("xlstm-dp256", "granite-repl-ff", "granite-repl-ff-m4",
                 "fcvi-bf16"):
        assert D.VARIANTS[name] == JD.VARIANTS[name]
