"""The model's shardings in the port (``repro_torch.distributed.sharding``,
``repro_torch.launch.specs``, ``models.model.param_specs``) against the
reference's (``repro.distributed.sharding``, ``repro.launch.specs``), and
the placement layer.

The reference's spec trees come from ``jax.eval_shape`` of its
``init_params`` at published widths (no allocation), on both production
meshes; its ``AxisRules`` and ``zero1_specs`` read only a mesh's axis
names and device shape, so a stand-in object serves for its 256- and
512-chip meshes. The port's trees run over its parameters by their
reference-tree paths (``to_jax_tree`` of meta tensors). Specs compare as
tuples (a ``PartitionSpec`` is one).
"""
import functools
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _stand_in(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _port_mesh(shape, axes):
    return make_mesh(shape, axes, device="meta")


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))


def _port_tree(arch):
    cfg = get_config(arch)
    named = dict(M.Model(cfg, torch.device("meta")).named_parameters())
    return M.to_jax_tree(named, cfg)


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is the
    axis."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _flat(tree) -> dict:
    """{path: spec} of a spec tree whose leaves are tuples."""
    out = {}

    def visit(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(path + (str(k),), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(path + (str(i),), v)
        else:
            out["/".join(path)] = tuple(_entry(e) for e in node)
    visit((), tree)
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_and_zero1_equal_the_reference(arch):
    """``arch_rules`` with the serve and the train extras,
    ``param_spec_tree`` and ``zero1_specs`` of all ten archs at published
    widths, on the 16 x 16 and 2 x 16 x 16 meshes: equal leaf for leaf;
    ``param_specs`` by name is the tree's entry without a scanned leaf's
    periods entry."""
    jshapes = _ref_shapes(arch)
    tree = _port_tree(arch)
    cfg = get_config(arch)
    for shape, axes in MESHES.values():
        jm, pm = _stand_in(shape, axes), _port_mesh(shape, axes)
        for extras in (None, JSP.SERVE_EXTRA_RULES, JSP.TRAIN_EXTRA_RULES):
            extra = None if extras is None else extras.get(arch)
            jr = JSP.arch_rules(jm, arch, extra)
            pr = SP.arch_rules(pm, arch, extra)
            assert pr.rules == jr.rules
            jspec = _flat(_tuples(JS.param_spec_tree(jshapes, jr)))
            pspec = _flat(S.param_spec_tree(tree, pr))
            assert pspec == jspec
            jz = _flat(_tuples(JSP.zero1_specs(
                jshapes, JS.param_spec_tree(jshapes, jr), jr)))
            pz = _flat(SP.zero1_specs(tree, S.param_spec_tree(tree, pr),
                                      pr))
            assert pz == jz
            assert any(a != b for a, b in zip(sorted(pz.items()),
                                              sorted(pspec.items())))
            named = M.param_specs(cfg, pr)
            for name, spec in named.items():
                path, scanned = M.reference_path(name, cfg)
                assert jspec[path] == ((None,) if scanned else ()) + tuple(
                    _entry(e) for e in spec)


def test_rules_and_shapes_equal_the_reference():
    for shape, axes in list(MESHES.values()) + [((2, 2, 2),
                                                 ("pod", "data", "model")),
                                                ((4, 2), ("data", "model"))]:
        jr = JS.AxisRules(_stand_in(shape, axes))
        pr = S.AxisRules(_port_mesh(shape, axes))
        assert pr.rules == jr.rules
        assert tuple(map(_entry, pr.spec("batch", None, "heads"))) == \
            tuple(jr.spec("batch", None, "heads"))
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES
    assert S.AxisRules(None).rules == JS.AxisRules(None).rules
    assert SP.SHAPES == JSP.SHAPES
    assert SP.ARCH_RULES == JSP.ARCH_RULES
    for arch in list_archs():
        for shape in SP.SHAPES:
            assert SP.cell_applicable(get_config(arch), shape) == \
                JSP.cell_applicable(jget_config(arch), shape)


def test_zero1_keeps_a_leaf_it_cannot_split():
    pm = _port_mesh((2, 4, 2), ("pod", "data", "model"))
    rules = S.AxisRules(pm)
    shapes = {"a": (6, 8), "b": (3, 5), "c": (8, 4)}
    base = {"a": (None, "model"), "b": (None, None), "c": (("pod", "data"),
                                                         None)}
    assert SP.zero1_specs(shapes, base, rules) == {
        "a": (None, "model"), "b": (None, None), "c": (("pod", "data"), None)}
    base["a"] = (None, None)
    assert SP.zero1_specs(shapes, base, rules)["a"] == (None, "data")
    assert SP.zero1_specs(shapes, base, S.AxisRules(
        pm, {"batch": None})) is base


# every kind of spec entry: replicated, one axis, a tuple of axes (both
# orders), several dims split, a scalar
PLACE_CASES = [
    ((8, 6), (None, None)),
    ((8, 6), ("data", None)),
    ((8, 6), (None, "model")),
    ((8, 6), (("pod", "data"), "model")),
    ((8, 6), (("data", "pod"), None)),
    ((4, 6, 8), ("model", None, ("pod", "data"))),
    ((16,), (("pod", "data", "model"),)),
    ((), ()),
]


@pytest.mark.parametrize("shape,spec", PLACE_CASES,
                         ids=[str(c[1]) for c in PLACE_CASES])
def test_place_and_join_round_trip_bit_for_bit(shape, spec):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    p = S.place(x, spec, mesh)
    assert torch.equal(S.join(p), x)
    assert S.join(p).view(torch.int32).equal(x.view(torch.int32))
    for pos, coords in S.positions(mesh):
        want = x[S.block_slices(mesh, p.spec, x.shape, coords)]
        assert torch.equal(p.blocks[pos], want)
    # replicas on one device share a tensor: one per distinct block
    n_blocks = 1
    for e in spec:
        for a in S.axes_of(e):
            n_blocks *= mesh.shape[a]
    assert len(p.unique()) == n_blocks
    assert p.nbytes() * n_blocks == x.numel() * x.element_size()


def test_place_rejects_what_does_not_split():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    x = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="does not split"):
        S.place(x, (("pod", "data"), None), mesh)
    with pytest.raises(ValueError, match="twice"):
        S.place(x, ("data", "data"), mesh)
    with pytest.raises(ValueError, match="not one of"):
        S.place(x, ("rows", None), mesh)
    with pytest.raises(ValueError, match="more entries"):
        S.place(x, (None, None, None), mesh)


def test_the_serving_entries_keep_their_rules():
    """A12's sharded engine reads ``corpus`` and ``ivf_lists``: the model's
    entries leave them as they were."""
    mesh = make_mesh((8, 1), ("data", "model"), device="cpu")
    rules = S.AxisRules(mesh)
    assert rules.rules["corpus"] == rules.rules["ivf_lists"] == ("data",)
    assert rules.spec("corpus", None) == (("data",), None)
