"""The port's roofline (``repro_torch.roofline``) on the CPU: the analytic
floors against the JAX package's, the op counter's exact counts on small
known programs, and the kernels' bounds against the kernel table's.

The floors must give the reference's ``model_flops`` and ``min_bytes`` for
every (arch, shape) cell, exactly: only ``peak_flops`` (the card's rate)
differs.  The counter must count a matmul chain's FLOPs by the formula, a
10-step Python loop ten times, an ``index_add``'s adds, and a broadcast on
the virtual production mesh by its bytes.  The kernels' bounds at 132 SMs
and 1980 MHz, N = 8192 and B = 256 are the kernel table's (PERF.md):
``fw_round`` 1.0602 ms a round, ``minplus`` 1.0271 (the split round's full
update), ``minplus_argmin`` 2.0541 (the pred round's stage 3) and
``row_close_pred`` 8.2166 at r = 1024.
"""

import pytest
import torch

from repro.roofline.floors import cell_floors as jax_cell_floors
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import HW, RooflineReport, analyze_counted, collective_bytes
from repro_torch.roofline import kernels as rk
from repro_torch.roofline.floors import cell_floors, floor_time
from repro_torch.roofline.op_cost import OpCounter, report_kernel

CELLS = [(a, s) for a in ARCH_IDS for s in get_arch(a).cells]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch_id,shape_id", CELLS)
def test_floors_equal_the_reference(arch_id, shape_id):
    ours, ref = cell_floors(arch_id, shape_id), jax_cell_floors(arch_id, shape_id)
    assert ours["model_flops"] == ref["model_flops"]
    assert ours["min_bytes"] == ref["min_bytes"]
    want = HW.PEAK_FLOPS_MINPLUS if arch_id == "apsp" else HW.PEAK_FLOPS_BF16
    assert ours["peak_flops"] == want
    t = floor_time(ours, 256)
    assert t == max(ours["model_flops"] / 256 / want, ours["min_bytes"] / 256 / HW.HBM_BW)


def test_h100_constants():
    assert HW.PEAK_FLOPS_BF16 == 989.4e12 and HW.PEAK_FLOPS_FP32 == 66.9e12
    assert HW.LANE_RATE == 132 * 128 * 1980e6 and HW.PEAK_FLOPS_MINPLUS == HW.LANE_RATE
    assert HW.HBM_BW == 3.35e12 and HW.NVLINK_BW == 450e9 and HW.HBM_BYTES == 80e9


def test_matmul_chain_counts_exactly():
    a, b, c = _meta(64, 128), _meta(128, 32), _meta(32, 16, dtype=torch.float32)
    with OpCounter(track=[a, b, c]) as n:
        y = (a @ b) @ c
    assert y.shape == (64, 16)
    assert n.cost.dot_flops == 2 * 64 * 128 * 32 + 2 * 64 * 32 * 16
    assert dict(n.cost.dot_flops_by_dtype) == {"float32": n.cost.dot_flops}
    # each mm reads its operands and writes its result once
    assert n.cost.hbm_bytes == 4 * ((64 * 128 + 128 * 32 + 64 * 32) + (64 * 32 + 32 * 16 + 64 * 16))
    # the intermediate (64, 32) and the result were live at once; the result survives
    assert n.cost.peak_live_bytes == 4 * (64 * 32 + 64 * 16) and n.live_bytes == 4 * 64 * 16
    assert n.cost.elem_ops == 0 and n.cost.ops == 2


def test_bf16_products_price_on_the_tensor_cores():
    a, b = _meta(256, 256, dtype=torch.bfloat16), _meta(256, 256, dtype=torch.bfloat16)
    with OpCounter(track=[a, b]) as n:
        a @ b
    assert n.cost.compute_s() == 2 * 256 ** 3 / HW.PEAK_FLOPS_BF16


def test_a_python_loop_counts_every_iteration():
    x = _meta(1000)
    with OpCounter(track=[x]) as n:
        for _ in range(10):
            x = x + 1.0
    assert n.cost.ops == 10 and n.cost.elem_ops == 10 * 1000
    assert n.cost.hbm_bytes == 10 * 2 * 4 * 1000
    assert n.cost.peak_live_bytes == 2 * 4 * 1000      # the old and the new x


def test_index_add_counts_its_adds():
    src, idx = _meta(50, 8), _meta(50, dtype=torch.long)
    with OpCounter(track=[src, idx]) as n:
        out = torch.zeros(10, 8, device="meta").index_add(0, idx, src)
    assert out.shape == (10, 8)
    assert n.cost.elem_ops == 50 * 8 and n.cost.ops == 2
    # zeros writes (10, 8); index_add reads it, the ids and the source and writes (10, 8)
    assert n.cost.hbm_bytes == 4 * 80 + (4 * 80 + 8 * 50 + 4 * 400 + 4 * 80)


def test_views_and_allocations_move_no_bytes():
    x = _meta(32, 32)
    with OpCounter(track=[x]) as n:
        x.t()
        x.reshape(-1)[:8]
        x[None].expand(4, 32, 32)
        e = torch.empty(1 << 20, device="meta")
    assert n.cost.hbm_bytes == 0 and n.cost.elem_ops == 0
    # an allocation is live memory all the same; a view of an argument is not
    assert n.cost.peak_live_bytes == n.live_bytes == e.numel() * 4
    with OpCounter(track=[x]) as n:
        x.t().reshape(-1)                   # not viewable: a copy
    assert n.cost.hbm_bytes == 2 * 4 * 32 * 32


@pytest.mark.parametrize("multi_pod", [False, True])
def test_a_broadcast_on_the_virtual_mesh_records_its_bytes(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    assert mesh.groups is None and mesh.rank == 0 and mesh.device.type == "meta"
    assert mesh.size == (512 if multi_pod else 256)
    t = _meta(128, 64)
    with OpCounter(track=[t]) as n:
        mesh.broadcast(t, "model", 3)
        mesh.broadcast(t, ("data",), 0)
    assert dict(n.cost.coll_bytes) == {"broadcast": 2 * 128 * 64 * 4}
    assert collective_bytes([("broadcast", 5), ("all-reduce", 7), ("broadcast", 1)]) == {
        "broadcast": 6, "all-reduce": 7}


def test_a_one_rank_axis_sends_nothing():
    from repro_torch.launch.mesh import make_host_mesh

    t = _meta(16)
    with OpCounter(track=[t]) as n:
        make_host_mesh(device="meta").broadcast(t, "data", 0)
    assert dict(n.cost.coll_bytes) == {}


@pytest.mark.parametrize("kernel,work,want", [
    ("fw_round", rk.fw_round_work(1, 8192, 256), 1.0602),
    ("minplus", rk.minplus_work(1, 8192, 256, 8192, accumulate=True), 1.0271),
    ("minplus_argmin", rk.minplus_work(1, 8192, 256, 8192, mode="minplus_argmin",
                                       accumulate=True), 2.0541),
    ("row_close_pred", rk.row_close_work("row_close_pred", 1024, 8192), 8.2166),
])
def test_kernel_bounds_are_the_kernel_tables(kernel, work, want):
    ms, by = work.bound(rk.lane_rate(132, 1980))
    assert round(ms, 4) == want and by == "operations"
    assert rk.lane_rate() == rk.lane_rate(132, 1980) == HW.LANE_RATE


def test_kernel_work_counts_each_byte_once():
    n, b = 8192, 256
    assert rk.minplus_work(1, n, b, n, accumulate=True).bytes == 4 * (2 * n * b + 2 * n * n)
    assert rk.minplus_work(1, n, b, n, mode="minplus_argmin",
                           accumulate=True).bytes == 4 * (2 * n * b + 3 * n * n)
    assert rk.fw_block_work(1, b).bytes == 4 * 2 * b * b
    assert rk.fw_block_work(1, b, pred=True) == rk.Work(b ** 3, 4, 4 * 4 * b * b)
    assert rk.fw_round_work(2, n, b, 2).bytes == 2 * 2 * n * n * 2
    assert rk.row_close_work("row_close", 16, n).bytes == 4 * (n * n + 16 + 16 * n)
    assert rk.spd_hop_work(64, n).bytes == 4 * (n * n + 2 * 64 * n)
    assert rk.rank_k_pass_work(4, n, 16, True) == rk.Work(4 * n * n * 16, 4, 4 * n * n * 16)


def test_reported_kernels_sum_into_the_cost():
    w = rk.minplus_work(1, 64, 32, 48)
    with OpCounter() as n:
        report_kernel("minplus", w, shape="1x64x32x48", plan={"xt_pitch": 64})
        report_kernel("minplus", w, shape="1x64x32x48", plan={"xt_pitch": 64})
    k = n.cost.kernels["minplus"]
    assert k["launches"] == 2 and k["candidates"] == 2 * 64 * 32 * 48
    assert k["bound_ms"] == 2 * w.bound()[0] and k["shapes"] == {"1x64x32x48": 2}
    assert n.cost.kernel_ops == 2 * 2 * 64 * 32 * 48 and n.cost.hbm_bytes == 2 * w.bytes
    report_kernel("minplus", w)          # no counter runs: nothing happens


def test_report_terms():
    class Cost:
        flops, hbm_bytes, coll_bytes = 2e12, 3.35e9, {"broadcast": 450e6}
        dot_flops, dot_flops_by_dtype, elem_ops, kernel_ops, ops = 2e12, {"bfloat16": 2e12}, 0, 0, 1

        def compute_s(self):
            return self.dot_flops / HW.PEAK_FLOPS_BF16

    rep = analyze_counted("x", Cost(), 4e12, 4)
    assert isinstance(rep, RooflineReport)
    assert rep.t_compute == pytest.approx(2e12 / HW.PEAK_FLOPS_BF16)
    assert rep.t_memory == pytest.approx(1e-3) and rep.t_collective == pytest.approx(1e-3)
    assert rep.bottleneck == "compute" and rep.useful_flops_ratio == pytest.approx(0.5)
    row = rep.row()
    assert row["cell"] == "x" and row["dot_flops_by_dtype"] == {"bfloat16": 2e12}


def test_bounds_equal_the_smokes_former_arithmetic():
    """``chip_smoke.py`` computed these bounds inline before it imported
    ``roofline.kernels``: the same values, bit for bit, at the smoke's
    shapes (the kernels line must not change)."""
    lane = 132 * 128 * 1980.0 * 1e6
    n, b, hbm = 8192, 256, 3.35e12
    cand = n * n * b + n * b * b + b ** 3
    w = rk.fw_round_work(1, n, b, 4)
    assert w.ops_ms(rk.lane_rate(132, 1980.0)) == 2 * cand / lane * 1e3
    assert w.bytes_ms() == 2 * n * n * 4 / hbm * 1e3
    for w, per, c, nbytes in [
            (rk.minplus_work(1, n, b, n, accumulate=True), 2, n * n * b, 4 * (2 * n * b + 2 * n * n)),
            (rk.minplus_work(1, n, b, n, mode="minplus_argmin", accumulate=True), 4, n * n * b,
             4 * (2 * n * b + 3 * n * n)),
            (rk.fw_block_work(1, b), 2, b ** 3, 4 * 2 * b * b),
            (rk.fw_block_work(1, b, pred=True), 4, b ** 3, 4 * 4 * b * b),
            (rk.spd_hop_work(64, n), 2, 64 * n * n, 4 * (n * n + 2 * 64 * n)),
            (rk.minplus_work(1, 4096, 2048, 4096, accumulate=True), 2, 4096 * 2048 * 4096,
             4 * (2 * 4096 * 2048 + 2 * 4096 * 4096))]:
        assert w.ops_ms(lane) == per * c / lane * 1e3 and w.bytes_ms() == nbytes / hbm * 1e3
    for mode, per, out_words in [("row_close", 2, 1), ("row_close_argmin", 4, 2),
                                 ("row_close_pred", 4, 3)]:
        for r in (16, 64, 1024, 2048):
            w = rk.row_close_work(mode, r, n)
            assert w.ops_ms(lane) == per * r * n * n / lane * 1e3
            assert w.bytes_ms() == 4 * (n * n + r + r * n * out_words) / hbm * 1e3
    for pred in (False, True):
        w = rk.rank_k_pass_work(4, n, 16, pred)
        assert w.ops_ms(lane) == 4 * n * n * 16 * (4 if pred else 2) / lane * 1e3
        assert w.bytes_ms() == 4 * n * n * 4 * 2 * (2 if pred else 1) / hbm * 1e3
