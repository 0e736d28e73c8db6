"""``launch.dryrun``'s shortcuts held to the full trace, position by
position, at ``reduced()`` widths on a (2, 2) ("data", "model") mesh of
meta positions, deeper than ``depth_plan`` traces, remat on as in
production: gemma3-1b (local and global layers), recurrentgemma-2b
(recurrent and local) and whisper-large-v3 (encoder-decoder), each at
train 8 x 128 tokens in four microbatches, prefill 4 x 128 and decode
4 x 128 (entries added to ``SHAPES`` at run time).

A train cell traces one batch group and microbatches 0 and 1 for all the
groups and microbatches; a serving cell traces ``depth_plan``'s shallow
configs, its counts their weighted sum and its live peak
``replay_peak``'s. Each is held to the trace of every group, microbatch
and layer: dot and convolution FLOPs, op-boundary bytes and the live peak
of every position, and the collectives (bytes, counts, by axis), all
exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_mesh
from test_torch_support import one_thread  # noqa: F401

SHAPES = {"t_train": dict(kind="train", seq=128, batch=8),
          "t_prefill": dict(kind="prefill", seq=128, batch=4),
          "t_decode": dict(kind="decode", seq=128, batch=4)}


@pytest.fixture(scope="module", autouse=True)
def _shapes():
    SP.SHAPES.update(SHAPES)
    yield
    for k in SHAPES:
        SP.SHAPES.pop(k, None)


# deeper than ``depth_plan`` traces (it traces 2 or 3 layers; whisper one
# or two of each stack); a train cell, traced at its depth, at reduced()'s
DEEP = {"gemma3-1b": dict(n_layers=8),
        "recurrentgemma-2b": dict(n_layers=5),
        "whisper-large-v3": dict(n_layers=3, n_enc_layers=3)}
# whisper's 448 decoder tokens in attention blocks of 224, to keep it quick
CHUNKS = {"whisper-large-v3": dict(q_chunk=224, kv_chunk=224)}
SHORTCUTS = [(a, s) for a in DEEP for s in ("t_train", "t_prefill",
                                            "t_decode")]


@pytest.mark.parametrize("arch,shape", SHORTCUTS)
def test_shortcuts_hold_to_the_full_trace(arch, shape, one_thread):
    """``run_cell``'s shortcuts against the full trace, position by
    position: dot and convolution FLOPs, op-boundary bytes, the live peak
    and the collectives (bytes, counts, by axis). A train cell (four
    microbatches) traces one group and microbatches 0 and 1 for all; a
    serving cell traces ``depth_plan``'s shallow configs, its counts their
    weighted sum and its peak ``replay_peak``'s."""
    train = SP.SHAPES[shape]["kind"] == "train"
    cfg = dataclasses.replace(reduced(get_config(arch)), remat=True,
                              **CHUNKS.get(arch, {}),
                              **({} if train else DEEP[arch]))
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")

    def build(c):
        return SP.build_cell(c, arch, shape, mesh, n_micro=4 if train else 1)

    short = D.traced_counts(cfg, build, mesh, one_group=True,
                            exact_depth=train)
    full = D.traced_counts(cfg, build, mesh, one_group=False,
                           exact_depth=True)
    assert short["cell"].n_micro == (4 if train else 1)
    assert short["depth"] == ("exact" if train else "replayed")
    assert short["traces"] == (1 if train else len(D.depth_plan(cfg)))
    for key in ("flops", "conv_flops", "bytes", "peak"):
        assert np.array_equal(short[key], full[key]), (key, short[key],
                                                       full[key])
    assert short["collectives"] == full["collectives"]
