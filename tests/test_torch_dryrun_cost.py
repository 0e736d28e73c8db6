"""The port's cost accounting (``repro_torch.launch.cost_analysis``) on toy
programs: ``tests/test_hlo_analysis.py``'s cases against the port (an
8-step loop, a batched einsum, the roofline's dominant term under the
H100's constants), op-boundary bytes and the live peak against their hand
counts, and the attribution of work to mesh positions (marks, scopes, the
collectives' own arithmetic, a kernel's cost on meta)."""
import pytest
import torch

from repro_torch.distributed import sharding as S
from repro_torch.kernels import ops
from repro_torch.launch import cost_analysis as C
from repro_torch.launch.mesh import make_mesh


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_loop_flops_exact():
    """test_scan_flops_match_unrolled: 8 steps of tanh(x @ w) count 8 of
    the step's dot FLOPs exactly (eager code has no loop to undercount)."""
    w, x = _meta(128, 128), _meta(64, 128)
    with C.CostMode() as cm:
        for _ in range(8):
            x = torch.tanh(x @ w)
    assert cm.summary()["per_device_flops"] == 8 * 2 * 64 * 128 * 128
    assert cm.summary()["executed"]["flops"] == 8 * 2 * 64 * 128 * 128


def test_dot_flops_with_batch_dims():
    a, b = _meta(4, 32, 64), _meta(4, 64, 16)
    with C.CostMode() as cm:
        torch.einsum("bij,bjk->bik", a, b)
    assert cm.summary()["per_device_flops"] == 2 * 4 * 32 * 16 * 64


def test_conv_flops_apart():
    x, w = _meta(2, 8, 32), _meta(16, 8, 3)
    with C.CostMode() as cm:
        torch.nn.functional.conv1d(x, w)
    s = cm.summary()
    assert s["per_device_flops"] == 0
    assert s["per_device_conv_flops"] == 2 * 2 * 16 * 30 * 8 * 3


def test_op_boundary_bytes_hand_count_views_free():
    """Each op reads its operands and writes its result; views, reshapes
    and transposes are free."""
    x = _meta(16, 32)                           # 2048 B
    with C.CostMode() as cm:
        y = x + 1.0                             # 2048 in, 2048 out
        z = y.view(32, 16).t()[:, :8]           # views: free
        u = z * z                               # 2 x 512 in, 512 out
        v = u.to(torch.bfloat16)                # 512 in, 256 out
    del v
    assert cm.summary()["per_device_bytes"] == (2048 + 2048) + 3 * 512 \
        + 512 + 256


def test_live_peak_hand_count():
    """Storages made minus storages freed: the peak is the most live at
    once; a view adds nothing, a freed temporary comes off."""
    x = _meta(256)                              # 1 KiB, made before
    with C.CostMode() as cm:
        a = x * 2.0                             # +1024
        b = a.view(16, 16)                      # view: +0
        c = b + 1.0                             # +1024 -> 2048 live
        del a, b
        d = c * 3.0                             # a freed: 1024 + 1024
        e = torch.cat([c, d])                   # +2048 -> 4096 live
        del c, d, e
    s = cm.summary()
    assert s["peak_bytes"] == 4096 and s["executed"]["peak_bytes"] == 4096
    assert cm.exec_live == 0


def test_roofline_dominant():
    """test_roofline_dominant's cases under the H100's constants."""
    t = C.roofline_terms(C.PEAK_BF16_S, C.PEAK_BYTES_S * 2, {})
    assert t["dominant"] == "memory" and t["step_lower_bound_s"] == 2.0
    t2 = C.roofline_terms(C.PEAK_BF16_S * 3, C.PEAK_BYTES_S,
                          {"data": C.NVLINK_BYTES_S})
    assert t2["dominant"] == "compute"
    t3 = C.roofline_terms(1.0, 1.0, {"data": 2 * C.NVLINK_BYTES_S})
    assert t3["dominant"] == "collective" and t3["collective_s"] == 2.0


def test_link_rate_by_node():
    """An axis whose groups lie inside 8 consecutive positions rides
    NVLink; the production mesh's 16-wide axes cross nodes."""
    small = make_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    assert C.axis_rate(small, "pod") == C.NVLINK_BYTES_S
    prod = make_mesh((16, 16), ("data", "model"), device="meta")
    assert C.axis_rate(prod, "model") == C.IB_BYTES_S
    assert C.axis_rate(prod, "data") == C.IB_BYTES_S
    wide = make_mesh((32, 8), ("data", "model"), device="meta")
    assert C.axis_rate(wide, "model") == C.NVLINK_BYTES_S
    assert C.model_flops(10, 3, "train") == 180.0
    assert C.model_flops(10, 3, "prefill") == 60.0


def test_positions_marks_scope_and_collectives():
    """An op counts for the positions its operands are marked with; an op
    on unmarked values for the scope's; a collective's arithmetic for
    none, its outputs marked with each member's position."""
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    w = S.mark(_meta(8, 8), (1,))              # 256 B, position 1's
    x = _meta(4, 8)                             # 128 B, unmarked
    with C.CostMode(mesh) as cm:
        with S.scope([0, 1]):
            x @ w                               # position 1: 128+256+128
            x + x                               # 0 and 1: 3 x 128 each
            group = S.mesh_group(mesh, "model", {"data": 0})
            outs = group.all_gather([x, x], 0)  # quiet
        assert [S.marked(t) for t in outs] == [frozenset({0}),
                                               frozenset({1})]
        outs[0] * 2.0                           # position 0: 2 x 256
    assert cm.flops.tolist() == [0, 2 * 4 * 8 * 8, 0, 0]
    assert cm.bytes.tolist() == [3 * 128 + 2 * 256, 512 + 3 * 128, 0, 0]


def test_fill_charged_to_its_first_reader():
    """A fill made inside the trace belongs to the positions of the first
    op that reads it."""
    mesh = make_mesh((1, 2), ("data", "model"), device="meta")
    w = S.mark(_meta(8, 8), (1,))
    with C.CostMode(mesh) as cm:
        acc = torch.zeros(4, 8, device="meta")  # 128 B written, pending
        acc @ w
    assert cm.bytes.tolist() == [0, 128 + 128 + 256 + 128]
    assert cm.peak.tolist() == [0, 256]


def test_disjoint_operands_join_free():
    """Operands of disjoint positions meet only in a collective's own
    arithmetic: nothing is counted."""
    mesh = make_mesh((1, 2), ("data", "model"), device="meta")
    with C.CostMode(mesh) as cm:
        a, b = S.mark(_meta(8), (0,)), S.mark(_meta(8), (1,))
        a + b
    assert cm.bytes.tolist() == [0, 0] and cm.joins == 1


def test_merge_stage_counts_for_its_group():
    """The tree merge (``index.distributed._tree``) over sets marked with
    their blocks' positions: each stage's pool and top-k count for every
    member of the stage's group, as SPMD runs them after the stage's
    all-gather, and for no other position. On a (2, 2) mesh with 4 sets of
    (4, 8) (fp32 values, int32 ids) and k = 8, a stage is two 2-set
    concatenations (read 2 x 128 B, write 256 B, each), the stable sort
    (read 256 B, write 256 B of values and 512 B of int64 positions) and
    the ids' gather (read 256 + 256 B, write 128 B): 2,688 B, counted once
    a stage at each position."""
    from repro_torch.index.distributed import _tree
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    with C.CostMode(mesh) as cm:
        vals = [S.mark(_meta(4, 8), (s,)) for s in range(4)]
        ids = [S.mark(_meta(4, 8, dtype=torch.int32), (s,))
               for s in range(4)]
        v, i, _ = _tree(vals, ids, None, (2, 2), 8, inner=8)
    assert v.shape == (4, 8) and i.dtype == torch.int32
    assert S.marked(v) == frozenset(range(4))
    stage = 2 * 512 + (256 + 256 + 512) + (256 + 256 + 128)
    assert cm.bytes.tolist() == [2 * stage] * 4 and cm.joins == 0


def test_kernel_entry_on_meta():
    """``ops.score_topk`` on meta records B2's own work (2 q n d, the rows
    and norms read once, the outputs written), not the plain version's
    (q, n) score matrix; other entries raise on meta, and a kernel reached
    on meta outside a trace raises."""
    x, sq, q = _meta(1000, 64), _meta(1000), _meta(8, 64)
    with C.CostMode() as cm:
        vals, ids = ops.score_topk(x, sq, q, 10)
    assert vals.shape == (8, 10) and ids.dtype == torch.int32
    k = cm.summary()["kernels"]["score_topk"]
    assert k["calls"] == 1 and k["flops"] == 2 * 8 * 1000 * 64
    assert k["bytes"] == 1000 * 64 * 4 + 1000 * 4 + 8 * 64 * 4 + 8 * 10 * 8
    assert cm.summary()["per_device_flops"] == 2 * 8 * 1000 * 64
    with pytest.raises(RuntimeError, match="outside a cost trace"):
        ops.score_topk(x, sq, q, 10)
    with C.CostMode(), pytest.raises(NotImplementedError, match="no cost"):
        ops.rescore(_meta(8, 10, 64), _meta(8, 10, 4), _meta(8, 64),
                    _meta(8, 4), 0.5)


def test_cached_repeats_equal_first_run():
    """The metadata cache makes a repeated op's outputs without running it:
    the same shapes, strides and counts as the first."""
    a = _meta(4, 6).t()
    with C.CostMode() as cm:
        first = a * 2.0
        again = a * 2.0
    assert (first.shape, first.stride()) == (again.shape, again.stride())
    assert cm.hits == 1 and cm.bytes[0] == 2 * (96 + 96)
