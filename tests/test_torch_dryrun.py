"""The port's dry run (``repro_torch.launch.builders`` and ``dryrun``) on
the CPU, against the JAX package's builders and against real runs.

* For every runnable cell the port's ``build_cell`` on a 1 x 1 mesh gives
  the JAX ``build_cell``'s argument shapes, dtypes and ``model_flops`` on
  ``make_host_mesh()`` (the trees flatten in the same order).
* A rank's argument bytes on the virtual 16 x 16 and (2, 16, 16) meshes
  equal the spec arithmetic: each leaf's bytes over the product of the
  mesh axes its spec names.
* A kernel called on ``meta`` tensors returns empty results of the right
  shapes, reports its plan and work, and leaves the launch counters alone;
  a distributed solve traced on ``meta`` predicts exactly the kernel calls
  that the same solve makes on the CPU.
* The trace of a small cell predicts a real CPU step's FLOPs
  (``FlopCounterMode``) and argument bytes exactly.
* ``python -m repro_torch.launch.dryrun`` for every APSP cell and for one LM
  and one GNN cell ends with no FAILED and allocates nothing (a small
  peak RSS).
"""

import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.builders import build_cell as jax_build_cell
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.builders import build_cell
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.roofline.op_cost import OpCounter
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
RUNNABLE = [(a, s) for a in ARCH_IDS for s, c in get_arch(a).cells.items()
            if not c.skip_reason]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch_id,shape_id", RUNNABLE)
def test_build_cell_matches_the_reference(arch_id, shape_id):
    ours = build_cell(get_arch(arch_id), get_arch(arch_id).cells[shape_id],
                      make_host_mesh(device="meta"))
    from repro.configs import get_arch as jax_get_arch

    jarch = jax_get_arch(arch_id)
    ref = jax_build_cell(jarch, jarch.cells[shape_id], jax_host_mesh())
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in leaves(ours.args)]
    want = [(tuple(t.shape), np.dtype(t.dtype).name) for t in jax.tree_util.tree_leaves(ref.args)]
    assert got == want
    assert all(t.is_meta for t in leaves(ours.args))
    assert ours.model_flops == ref.model_flops
    assert ours.name == ref.name and ours.donate_argnums == ref.donate_argnums


def _spec_bytes(tree, shardings, mesh) -> int:
    """Each leaf's bytes over the product of the mesh axes its spec names."""
    sizes = mesh.shape
    total = 0

    def add(sh, sub):
        nonlocal total
        for leaf in leaves(sub):
            parts = 1
            for e in sh.spec:
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    parts *= sizes[a]
            total += leaf.numel() * leaf.element_size() // parts

    tree_map(add, shardings, tree)
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch_id,shape_id", [
    ("apsp", "blocked_16k"), ("apsp", "square_4k"), ("qwen2-1.5b", "train_4k"),
    ("llama3-405b", "decode_32k"), ("deepseek-v2-236b", "prefill_32k"),
    ("gcn-cora", "ogb_products"), ("nequip", "molecule"), ("mind", "retrieval_cand"),
    ("mind", "train_batch"),
])
def test_rank_bytes_are_the_spec_arithmetic(arch_id, shape_id, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    dr = build_cell(get_arch(arch_id), get_arch(arch_id).cells[shape_id], mesh)
    got = dryrun.rank_bytes(dr.args, dr.in_shardings)
    assert got == _spec_bytes(dr.args, dr.in_shardings, mesh)
    full = sum(t.numel() * t.element_size() for t in leaves(dr.args))
    assert 0 < got < full
    if arch_id == "apsp":
        n = get_arch(arch_id).cells[shape_id].settings["n"]
        assert got == 4 * n * n // mesh.size


def test_a_meta_kernel_call_reports_and_launches_nothing():
    from repro_torch.kernels import ops

    mods = {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in ("minplus", "fw_block", "fw_round", "row_close")}
    before = (dict(mods["minplus"].launches), dict(mods["fw_block"].launches),
              mods["fw_round"].rounds, dict(mods["row_close"].launches))
    i32 = torch.int32
    with OpCounter() as n:
        z = ops.minplus(_meta(64, 32), _meta(32, 48), _meta(64, 48))
        za, ka = ops.minplus_argmin(_meta(3, 64, 32), _meta(3, 32, 48))
        zp, pp = ops.minplus_pred(_meta(64, 32), _meta(32, 48), _meta(64, 32, dtype=i32),
                                  _meta(32, 48, dtype=i32))
        t = ops.fw_block(_meta(3, 16, 16))
        tg, pg = ops.fw_block_pred(_meta(1, 512, 512), _meta(1, 512, 512, dtype=i32))
        d = ops.fw_round(_meta(64, 64), 16, block_size=16)
        dr, pr = ops.row_restricted_close(_meta(64, 64), _meta(5, dtype=i32),
                                          pred=_meta(64, 64, dtype=i32))
    assert z.shape == (64, 48) and za.shape == ka.shape == (3, 64, 48) and ka.dtype == i32
    assert zp.shape == pp.shape == (64, 48) and pp.dtype == i32
    assert t.shape == (3, 16, 16) and tg.shape == pg.shape == (1, 512, 512)
    assert d.shape == (64, 64) and dr.shape == pr.shape == (64, 64)
    assert all(x.is_meta for x in (z, za, ka, zp, pp, t, tg, pg, d, dr, pr))
    k = n.cost.kernels
    assert {name: v["launches"] for name, v in k.items()} == {
        "minplus": 1, "minplus_argmin": 1, "minplus_pred": 1, "fw_block": 1,
        "fw_block_pred": 1, "fw_round": 1, "row_close_pred": 1}
    assert k["minplus_argmin"]["candidates"] == 3 * 64 * 32 * 48
    assert k["fw_block"]["plans"] == {repr(tuple(mods["fw_block"].closure_launch(16))): 1}
    assert k["fw_block_pred"]["plans"] == {"(0, 0, 512, 0)": 1}      # the grid closure
    plan = mods["row_close"].launch_plan(5, 64, True, 132)
    assert k["row_close_pred"]["plans"] == {repr(tuple(plan)): 1}
    assert "scratch" in next(iter(k["fw_round"]["plans"]))
    after = (dict(mods["minplus"].launches), dict(mods["fw_block"].launches),
             mods["fw_round"].rounds, dict(mods["row_close"].launches))
    assert after == before


@pytest.mark.parametrize("method", ["squaring", "fw", "rkleene"])
def test_meta_solve_predicts_the_cpu_solves_kernel_calls(method, monkeypatch):
    """The distributed solvers on a 1 x 1 mesh: the kernels the meta trace
    reports are exactly the ``ops`` calls the same solve makes on the CPU,
    shape for shape."""
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import ops

    n, b = 64, 16
    h = torch.from_numpy(np.random.default_rng(0).uniform(1, 9, (n, n)).astype(np.float32))
    kw = dict(row_axes=("data",), col_axes=("model",))
    fn = {"squaring": lambda h, m: dist_mod.squaring_distributed(h, mesh=m, **kw),
          "fw": lambda h, m: dist_mod.fw_distributed(h, mesh=m, block_size=b, **kw),
          "rkleene": lambda h, m: dist_mod.rkleene_distributed(h, mesh=m, leaf=32,
                                                               block_size=b, **kw)}[method]
    with OpCounter() as c:
        fn(_meta(n, n), make_host_mesh(device="meta"))
    want = {k: v["shapes"] for k, v in c.cost.kernels.items()}

    seen = {}
    real_mp, real_fb = ops.minplus, ops.fw_block

    def minplus(x, y, a=None, **k):
        key = f"1x{x.shape[0]}x{x.shape[1]}x{y.shape[1]}" + (" accumulate" if a is not None
                                                             else "")
        seen.setdefault("minplus", {}).setdefault(key, 0)
        seen["minplus"][key] += 1
        return real_mp(x, y, a, **k)

    def fw_block(d, **k):
        key = f"T={d.shape[0] if d.ndim == 3 else 1} B={d.shape[-1]}"
        seen.setdefault("fw_block", {}).setdefault(key, 0)
        seen["fw_block"][key] += 1
        return real_fb(d, **k)

    monkeypatch.setattr(ops, "minplus", minplus)
    monkeypatch.setattr(ops, "fw_block", fw_block)
    out = fn(h, make_host_mesh(device="cpu"))
    assert seen == want and out.shape == (n, n)


def test_prediction_matches_a_real_cpu_step():
    """``gcn-cora:full_graph_sm`` on a 1 x 1 mesh: the trace's dot FLOPs
    equal ``FlopCounterMode`` on the real CPU step, the argument bytes the
    real tensors', and the outputs' shapes the real outputs'."""
    arch = get_arch("gcn-cora")
    dr = build_cell(arch, arch.cells["full_graph_sm"], make_host_mesh(device="meta"))
    pred = dryrun.predict(dr, make_host_mesh(device="meta"))
    args = dr.concrete("cpu", seed=0)
    real = sum(t.numel() * t.element_size() for t in leaves(args))
    assert round(pred["memory"]["args_gb"] * 1e9) == real
    with FlopCounterMode(display=False) as fc:
        out = dr.fn(*args)
    assert pred["roofline"]["dot_flops"] == fc.get_total_flops()
    assert pred["out_shapes"] == [list(t.shape) for t in leaves(out)
                                  if isinstance(t, torch.Tensor)]
    assert np.isfinite(float(out[1]["loss"]))
    assert pred["memory"]["alias_gb"] > 0          # the parameters, updated in place


def test_run_cell_record(tmp_path):
    rec = dryrun.run_cell("apsp", "blocked_16k", False, out_dir=tmp_path, verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == [16, 16] and rec["n_chips"] == 256
    saved = json.loads((tmp_path / "apsp__blocked_16k__pod16x16.json").read_text())
    assert saved["cell"] == "apsp:blocked_16k@pod16x16"
    # rank 0 owns two of the 32 pivot blocks: 32 closures, 32 updates, 2 + 2 panels
    assert rec["kernels"]["fw_block"]["launches"] == 32
    assert rec["kernels"]["minplus"]["launches"] == 36
    assert rec["memory"]["args_gb"] == 4 * 16384 ** 2 / 256 / 1e9 and rec["memory"]["fits"]
    assert rec["collectives"]["broadcast"] > 0
    assert rec["floor"]["floor_s"] > 0 and rec["roofline"]["bottleneck"] == "compute"
    skip = dryrun.run_cell("yi-9b", "long_500k", True, out_dir=tmp_path, verbose=False)
    assert skip["status"] == "skipped"
    assert skip["reason"] == get_arch("yi-9b").cells["long_500k"].skip_reason


@pytest.mark.parametrize("argv", [
    ["--arch", "apsp", "--mesh", "single"],
    ["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--mesh", "both"],
    ["--arch", "gcn-cora", "--shape", "ogb_products", "--mesh", "single"],
])
def test_cli_finishes_and_allocates_nothing(argv, tmp_path):
    code = (
        "import resource, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.launch import dryrun\n"
        f"rc = dryrun.main({argv + ['--out-dir', str(tmp_path)]!r})\n"
        "print('maxrss_mb', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024)\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert "FAILED" in lines[-2] and " 0 FAILED" in lines[-2] and "[FAIL]" not in out.stdout
    assert float(lines[-1].split()[1]) < 1500      # MB: nothing at the cells' size
    assert len(list(tmp_path.glob("*.json"))) >= 1
