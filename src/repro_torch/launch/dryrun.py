"""Multi-pod dry run of the port: trace every (arch x shape x mesh) cell on
``meta`` tensors, ported from ``repro.launch.dryrun``.

For each runnable cell, on the virtual 16 x 16 single-pod mesh and the
(2, 16, 16) multi-pod mesh (``launch.mesh.make_production_mesh(device=
"meta")``: no process groups, rank 0's view), ``builders.build_cell`` makes
the step with abstract state, and the step runs once on ``meta`` tensors
under ``roofline.op_cost.OpCounter``.  Nothing is allocated and no kernel
launches (``kernels.ops`` routes ``meta`` tensors to the kernels' wrappers,
which report their launch plans and work).  PyTorch has no SPMD compiler,
so a record holds:

  * memory a rank: argument bytes from the shardings (``Sharding.
    local_nbytes`` on every leaf, exact), output bytes, the peak of the live
    bytes the step creates (temp), and the outputs that alias an argument
    (a train step updates its parameters in place, a decode step its
    cache); ``total_gb`` = args + out + temp - alias, as the reference
    sums XLA's memory analysis, and ``fits`` reads it against the card's
    80 GB;
  * the roofline (``roofline.analyze_counted``) of the counted FLOPs, HBM
    bytes and collective bytes, and the analytic floor
    (``roofline.floors``);
  * each hand-written kernel's launches, work and bound.

The LM, GNN, NequIP and MIND steps run in the data-parallel view
(``builders``' docstring): full-width parameters, the rank's block of the
batch; their collective bytes are the f32 gradient all-reduce that a
data-parallel step adds (the port's ``make_train_step`` sends none).  The
APSP cells run the distributed solvers on the rank's block and record the
bytes of every ``Mesh.broadcast``.

Records land in ``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json``.

Usage:
    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh both
    python -m repro_torch.launch.dryrun --arch apsp --mesh single --jobs 4
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch.builders import DryRunnable, build_cell
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.roofline import HW, analyze_counted
from repro_torch.roofline.floors import cell_floors, floor_time
from repro_torch.roofline.op_cost import OpCounter
from repro_torch.tree import leaves, tree_map

__all__ = ["run_cell", "trace", "rank_bytes", "main", "OUT_DIR"]

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"

VIEW_DP = ("data-parallel view: full-width parameters and state, the rank's block of the "
           "batch; collectives: the f32 gradient all-reduce a data-parallel step adds")
VIEW_RANK = "rank 0's program on its block; collectives: every Mesh.broadcast"


def rank_bytes(tree, shardings) -> int:
    """Bytes a rank holds of ``tree``'s leaves laid out by ``shardings`` (a
    sharding applies to every leaf below it, as a JAX prefix does)."""
    total = 0

    def add(sh, sub):
        nonlocal total
        total += sum(sh.local_nbytes(l.shape, l.dtype) for l in leaves(sub))

    tree_map(add, shardings, tree)
    return total


def _local(tree, shardings):
    """``tree`` with every leaf cut to a rank's block (a new meta tensor)."""
    return tree_map(lambda sh, sub: tree_map(
        lambda l: torch.empty(sh.local_shape(l.shape), dtype=l.dtype, device="meta"), sub),
        shardings, tree)


def trace(dr: DryRunnable):
    """Run ``dr`` once on its trace arguments under an :class:`OpCounter`:
    (counter, outputs, trace arguments)."""
    targs = tuple(_local(a, sh) if cut else a
                  for a, sh, cut in zip(dr.args, dr.in_shardings, dr.trace_local))
    grad = contextlib.nullcontext() if dr.train else torch.no_grad()
    with grad, OpCounter(track=leaves(targs)) as counter:
        out = dr.fn(*targs)
    return counter, out, targs


def memory(dr: DryRunnable, counter: OpCounter, out, targs) -> dict:
    """Bytes a rank holds: arguments (from the shardings), outputs, temp
    (the step's peak live bytes less its new outputs) and the outputs
    that alias an argument; and the bytes of the trace's own arguments."""
    seen, new_out, alias = set(), 0, 0
    for t in leaves(out):
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        if counter.is_arg(t):
            alias += t.numel() * t.element_size()
        else:
            new_out += st.nbytes()
    return {"args": rank_bytes(dr.args, dr.in_shardings),
            "trace_args": sum(t.numel() * t.element_size() for t in leaves(targs)),
            "out": new_out + alias,
            "temp": max(0, counter.cost.peak_live_bytes - new_out),
            "alias": alias}


def _batch_split(dr: DryRunnable) -> bool:
    """Whether a train step's batch is split over more than one rank."""
    batch = dr.args[1]
    return rank_bytes(batch, dr.in_shardings[1]) < sum(
        l.numel() * l.element_size() for l in leaves(batch))


def predict(dr: DryRunnable, mesh: Mesh) -> dict:
    """Trace ``dr`` on ``mesh`` and return the record's measured parts."""
    t0 = time.time()
    counter, out, targs = trace(dr)
    trace_s = time.time() - t0
    cost = counter.cost
    if dr.train and _batch_split(dr):
        n_params = sum(p.numel() for p in leaves(dr.args[0].params))
        cost.collectives.append(("all-reduce (data-parallel gradients)", 4 * n_params))
    mem = memory(dr, counter, out, targs)
    rep = analyze_counted(dr.name, cost, dr.model_flops, mesh.size)
    return {"trace_s": trace_s, "memory": _mem_dict(mem), "roofline": rep.row(),
            "collectives": dict(cost.coll_bytes), "kernels": cost.kernels,
            "out_shapes": [list(t.shape) for t in leaves(out) if isinstance(t, torch.Tensor)]}


def run_cell(arch_id: str, shape_id: str, multi_pod: bool, *, save: bool = True,
             verbose: bool = True, skip_existing: bool = False,
             mesh: Optional[Mesh] = None, out_dir: Optional[Path] = None) -> dict:
    """The dry run of one cell on the virtual production mesh (or ``mesh``,
    a meta mesh such as ``make_host_mesh(device="meta")``)."""
    arch = get_arch(arch_id)
    cell = arch.cells[shape_id]
    if mesh is None:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        mesh_name = "x".join(str(s) for s in mesh.shape.values())
    tag = f"{arch_id}:{shape_id}@{mesh_name}"
    out_dir = Path(out_dir) if out_dir is not None else OUT_DIR

    if skip_existing:
        path = out_dir / f"{arch_id}__{shape_id}__{mesh_name}.json"
        if path.exists():
            old = json.loads(path.read_text())
            if old.get("status") in ("ok", "skipped"):
                if verbose:
                    print(f"[cached] {tag}: {old['status']}")
                return old

    if cell.skip_reason:
        rec = {"cell": tag, "status": "skipped", "reason": cell.skip_reason}
        if verbose:
            print(f"[skip] {tag}: {cell.skip_reason}")
        _save(rec, arch_id, shape_id, mesh_name, save, out_dir)
        return rec

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    n_chips = mesh.size
    t0 = time.time()
    try:
        dr = build_cell(arch, cell, mesh)
        t_build = time.time() - t0
        pred = predict(dr, mesh)
        floors = cell_floors(arch_id, shape_id)
        rec = {
            "cell": tag,
            "status": "ok",
            "note": dr.note,
            "view": VIEW_RANK if arch.family == "apsp" else VIEW_DP,
            "mesh": list(mesh.shape.values()),
            "n_chips": n_chips,
            "build_s": round(t_build, 2),
            "trace_s": round(pred.pop("trace_s"), 2),
            **pred,
            "floor": {**floors, "floor_s": floor_time(floors, n_chips)},
            "device": "meta (no card): counted, not measured",
        }
        if verbose:
            gb = rec["memory"]["total_gb"]
            r = rec["roofline"]
            print(
                f"[ok]   {tag}  mem/dev={gb:.2f}GB  "
                f"T(comp/mem/coll)=({r['t_compute_s']:.3e}/"
                f"{r['t_memory_s']:.3e}/{r['t_collective_s']:.3e})s  "
                f"bottleneck={r['bottleneck']}  "
                f"useful={r['useful_flops_ratio']:.2f}  "
                f"roofline={r['roofline_fraction']:.2f}"
            )
    except Exception as e:  # a failure here is a bug in the system
        rec = {"cell": tag, "status": "FAILED", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        if verbose:
            print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}")
    _save(rec, arch_id, shape_id, mesh_name, save, out_dir)
    return rec


def _mem_dict(mem: dict) -> dict:
    total = mem["args"] + mem["out"] + mem["temp"] - mem["alias"]
    return {
        "args_gb": mem["args"] / 1e9,
        "out_gb": mem["out"] / 1e9,
        "temp_gb": mem["temp"] / 1e9,
        "alias_gb": mem["alias"] / 1e9,
        "total_gb": total / 1e9,
        "trace_args_gb": mem["trace_args"] / 1e9,
        "fits": total <= HW.HBM_BYTES,
        "bytes": {**mem, "total": total},
    }


def _save(rec: dict, arch_id, shape_id, mesh_name, save: bool, out_dir: Path):
    if not save:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch_id}__{shape_id}__{mesh_name}.json"
    path.write_text(json.dumps(rec, indent=2, default=str))


def _run_one(job) -> dict:
    arch_id, shape_id, multi_pod, skip_existing, out_dir = job
    return run_cell(arch_id, shape_id, multi_pod, skip_existing=skip_existing,
                    out_dir=out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape id (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    ap.add_argument("--out-dir", default=None, help=f"records' directory (default {OUT_DIR})")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out_dir) if args.out_dir else OUT_DIR
    jobs = [(aid, sid, mp, args.skip_existing, out_dir)
            for aid in archs
            for sid in ([args.shape] if args.shape else list(get_arch(aid).cells))
            for mp in meshes]
    # The train steps trace longest: start them first.
    jobs.sort(key=lambda j: get_arch(j[0]).cells[j[1]].kind != "lm_train")

    t0 = time.time()
    if args.jobs > 1:
        with ProcessPoolExecutor(args.jobs, mp_context=get_context("spawn")) as pool:
            recs = list(pool.map(_run_one, jobs))
    else:
        recs = [_run_one(j) for j in jobs]
    n_ok = sum(r["status"] == "ok" for r in recs)
    n_skip = sum(r["status"] == "skipped" for r in recs)
    n_fail = sum(r["status"] == "FAILED" for r in recs)
    print(f"\ndry-run done: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED "
          f"({time.time() - t0:.1f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
