"""The training checkpoint's tree: the port's ``(params, AdamWState)``
(``repro_torch.launch.train.train_tree``) keyed as the reference's
``_flatten`` keys its own train state, for every arch
(``0|decoder|scan|0|mixer|wq``, ``1|.step``, ``1|.mu|...``: a NamedTuple's
fields key as ``.name``), and ``params_to_jax`` inverting
``params_from_jax``. The checkpoints themselves cross between the packages
in ``test_torch_train_ckpt.py``."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the card's machine has no JAX

from test_torch_support import one_thread  # noqa: F401,E402  (autouse)
from lm_train_support import case  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

ARCH = "gemma3-1b"
CHANGES = {"n_layers": 8}     # one scanned period of 6 and a rest of 2


@pytest.mark.parametrize("arch", list_archs())
def test_keys_and_shapes_equal_the_references_flatten(arch):
    _, params, cfg, _ = case(arch)
    want = {k: tuple(v.shape) for k, v in jckpt._flatten(
        (params, jopt.init(params))).items()}
    model = M.Model(cfg, device="meta")
    tree = train.train_tree(model, opt.init(dict(model.named_parameters())),
                            "meta")
    got = {k: tuple(v.shape) for k, v in ckpt._walk(tree)}
    assert got == want
    assert "1|.step" in got and "0|embed|embedding" in got


@pytest.mark.parametrize("arch", list_archs())
def test_params_to_jax_inverts_params_from_jax(arch):
    """The reference's tree back bit for bit (structure, keys, fp32 leaves;
    on ``"meta"`` the shapes); ``to_jax_tree`` / ``from_jax_tree`` invert
    each other on any leaves."""
    _, params, cfg, _ = case(arch, **(CHANGES if arch == ARCH else {}))
    model = M.params_from_jax(params, cfg, device="cpu")
    back = M.params_to_jax(model)
    want = jckpt._flatten(params)
    got = {k: v.numpy() for k, v in jckpt._flatten(back).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    meta = M.params_to_jax(model, "meta")
    assert {k: (v.device.type, tuple(v.shape)) for k, v in
            jckpt._flatten(meta).items()} == {k: ("meta", v.shape)
                                              for k, v in want.items()}
    named = dict(model.named_parameters())
    again = M.from_jax_tree(M.to_jax_tree(named, cfg), cfg)
    assert sorted(again) == sorted(named)
    assert all(torch.equal(again[k], named[k]) for k in named)
