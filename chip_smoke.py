#!/usr/bin/env python3
"""Prove that the PyTorch port runs its main path on an NVIDIA GPU.

Run from the repo root on a host with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
kernel against its plain PyTorch version on the card, and drives each path
of ``repro_torch.solve`` with its launch counts set to 0 just before and
read just after:

* the main path (fused blocked Floyd-Warshall, all defaults; ``fw_round``)
  at N = 8192 and N = 8191, checked against the plain solve and scipy's
  Dijkstra;
* ``with_pred=True`` (``fw_block_pred``, ``minplus_pred``: the witness
  kernel with the predecessor rule in its epilogue) at N = 8192 and 8191:
  the same distances, the plain pred solve's predecessors, a valid
  predecessor tree, and paths whose cost is Dijkstra's;
* ``round_mode="split"`` without and with predecessors (``fw_block``,
  ``minplus``; ``fw_block_pred``, ``minplus_pred``) at N = 8192, the pred
  one against the plain pred solve, and both pred rounds against the plain
  pred solve on the card at N = 2048 as well;
* every path again at B = 512 and 1024 (tiles above 256 nodes close on the
  grid closure), dist equal to the B = 256 solve's and pred trees valid at
  N = 8192, the pred rounds against the plain pred solve at N = 2048, and
  the main solve at N = 16384, B = 512 against its B = 256 solve.

It then drives the dynamic engine, ``repro_torch.DynamicAPSP``, at
N = 8192 with and without predecessors through a stream of edge-update
batches that takes the rank-k path (``minplus``, ``minplus_argmin``), the
row-restricted re-close (``row_close`` and ``row_close_pred``, at r <= 64,
where k is split across CTAs, and at r >= 1024) and, on twin engines, the
warm re-solve; after every update ``dist`` equals a cold solve, the pred
tree is valid and its paths cost Dijkstra's distances, and every row-close
launch is replayed through its plain version (and the witness mode,
``row_close_argmin``, on each pred launch's inputs).  The row pass is
timed in its three modes at r = 16, 64, 1024 and 2048 beside its bounds,
and one pass with preds is traced: it launches ``row_close_pred`` only
and holds no gather or where row.

Phase 7 runs the paper's own evaluation: its 1000-graph corpus
(``paper_corpus(seed=0)``, V ~ U[4, 1000]) through ``repro_torch.solve_batch``
bucketed by size (``blocked_fw`` without and with predecessors,
``squaring``, ``rkleene``) and as one (1000, 1000, 1000) stack
(``blocked_fw`` without and with predecessors), each graph equal to its own
card solve, bucketed equal to single stack, every 100th graph equal to
scipy's Dijkstra and every pred tree valid; then each method at full width
(``squaring`` at N = 4096, ``rkleene`` at N = 16384 with base 64 and 256,
``squaring_3d`` at N = 1024, ``classic`` at N = 2048) against the blocked
solve with its exact launch counts, a ragged G = 8 stack of every method
under every semiring against the per-graph solves and the CPU, the kernels
on the slice's shapes (R-Kleene quadrant views with offsets, squaring with
aliased operands, a G = 64 round) against their plain versions, and traces
of one squaring and one R-Kleene solve.

Phase 8 drives the serving tier (``repro_torch.launch``), with the port's
autotune cache pointed at a fresh file before phase 1: ``tune_fw_round``
at n_max = 1024 writes a ``cuda`` entry (the tuned solve equal to the
default one), then ``serve_apsp`` serves 32 ragged graphs of up to 1024
nodes, 16 a cycle, by squaring, blocked FW with and without predecessors
and R-Kleene (graphs/s each); ``serve_apsp_dynamic`` serves 24 requests
on four N = 8192 slots without chaos, plain and with predecessors (no
retry, quarantine, poisoned answer or drift; every batched drain of the
pool defers nothing for a failure, reports its whole group and launches
one product a pass; ms per submit+drain and per query), and the chaos
drills at N = 2048, sync (NaN, crash, poison, a 50 ms deadline) and
async + durable (backend loss, cache storm, crash-restore); then
``apply_updates_batched`` on four N = 8192 engines equals four twins
updated one by one, one launch a pass, timed against them beside its byte
bound, with the commit's host work (snapshot, health probe); and engine
checkpoints at N = 8192 with predecessors, f32 and bf16, restored and
replayed bit-exact, with their save and load ms and size on disk.

Phase 9 drives the GNN training path: ``repro_torch.spd_features`` on
the smoke's N = 8192 graph (64 landmarks) and on a Cora-shaped graph
(``synthetic_graph`` at 2708 nodes and 10556 edges, 8 landmarks), each
bit-equal to the same loop on the plain version and to the capped rows of
``repro_torch.solve``, with one ``minplus`` launch a hop; then
``gcn-cora``, ``gin-tu`` and ``pna`` at their published widths on that
graph with the 8 SPD features appended, 20 train steps each on the card
(the first 3 against the CPU within rtol 1e-4, ms a step, peak memory);
then ``python -m repro_torch.launch.train --arch gcn-cora`` for 6 steps
and resumed to 9 from its checkpoint.  Float32 products run with TF32 off.

Phase 10 drives NequIP and the distributed solvers: ``nequip`` at its
published config on the reference's molecule cell (128 molecules of 30
atoms and 64 edges a batch), 20 train steps on the card (the first 3
against the CPU within rtol 1e-4, ms a step, busy share, peak memory),
one batch's energy and forces against the CPU, rotation invariance on
the card, and ``python -m repro_torch.launch.train --arch nequip`` for 6
steps and resumed to 9; then ``repro_torch.core.distributed.
apsp_distributed`` on the N = 8192 graph (B = 512, R-Kleene leaf 4096):
``squaring``, ``fw`` and ``rkleene`` on a (2, 2) mesh and ``fw`` on the
(2, 1, 2) multi-pod mesh, four gloo ranks on the one card, and ``fw`` on
a 1x1 mesh under NCCL, each bit-equal to the single-card solve with each
rank's ``minplus`` and ``fw_block`` launches equal to the plan, timed
(gloo-staged collectives on one card, not a multi-GPU figure).

Phase 11 drives the LM and MIND substrate, after freeing what the
earlier phases hold, with random weights drawn on the card: (a)
``qwen2-1.5b`` at its published config serving 32 prompts of 1024 tokens
through ``prefill`` and 128 greedy ``decode_step``s (prefill ms, ms a
step, tokens/s, a traced step's busy share and copy kernels, peak
memory), decode against teacher-forced ``forward`` in float32 within 1e-3
of the largest logit, bf16's gap and top-1 agreement as figures, and the
model cut to 2 layers on the card against the port on the CPU within
1e-4; (b) its training at 4 x 4096 tokens, 4 microbatches, AdamW, remat
"full" (ms a step, tokens/s, busy share, peak), and 3 steps of the
2-layer cut against the CPU within rtol 1e-4; (c) ``deepseek-v2-236b`` at
its published widths cut to 2 layers (dense first layer, one MoE layer):
8 prompts of 512 tokens, 32 absorbed decode steps on the (2, B, T, 512) +
(2, B, T, 64) cache, the share of (token, expert) slots dropped in
prefill, and decode against forward in float32 with the capacity raised
until nothing drops; (d) MIND at its published config on ``serve_p99``,
``serve_bulk``, ``retrieval_cand`` and a train batch of 16384 (users/s,
retrieval ms, ms a step), interests, top-10 ids and 3 train steps against
the CPU; (e) the serve and train CLIs at smoke configs (the deepseek
trainer resumed from its checkpoint); (f) the int8 compressed train step
on four gloo ranks on the card on a (2, 2, 1) mesh against the plain
step, the parameters bit-equal across ranks.  No kernel of this repo lies
on that path: the launch counters must not move.

Phase 12 holds the port's dry run (``repro_torch.launch.dryrun``) against
the card: (a) every (arch x shape) cell on the virtual 16 x 16 and
(2, 16, 16) meshes, traced on ``meta`` tensors in the background at the
lowest priority from phase 1 on, ends ``ok`` or ``skipped`` with its
config's reason, none ``FAILED`` (GB a rank, bottleneck and floor
printed); (b) ``apsp:square_4k``, ``apsp:blocked_16k``,
``gcn-cora:full_graph_sm``, ``nequip:molecule``, ``mind:serve_p99``,
``mind:retrieval_cand`` and, if predicted to fit with 10% to spare,
``gcn-cora:ogb_products`` run one real step on a 1 x 1 mesh from arguments
drawn on the card: each kernel's launches equal the prediction and the
counters, its reported work prices (``repro_torch.roofline.kernels``) to
the predicted bound, the argument bytes equal the prediction, and the
dot FLOPs (against ``FlopCounterMode``) and the peak memory (against
``max_memory_allocated``) are printed as ratios.  The kernels line's
bounds come from ``repro_torch.roofline.kernels``.

Every launch check reads the port's launch counters (``kernels/
_counts.py``), never ``torch.profiler``, which can lose a grid of a trace
(PERF.md §7); the profiler's count of each kernel's grids is printed
beside the counters', and a grid's ms is read from a trace only where the
profiler saw at least one grid of it and no more than were launched.
``python3 chip_smoke.py --profiler-study`` measures the lost grids.

It traces a solve of each path with ``torch.profiler`` (the pred traces
must hold no gather row: the pred rule runs in ``minplus_pred``'s
epilogue), holds every kernel against its plain version once more at the
main path's shapes (and ``minplus`` / ``minplus_argmin`` at the rank-k
shapes), times it there and prints
one JSON line of kernel numbers: ``fw_round`` with its four grids' ms a
round, and the three cluster closures (``fw_closure``, ``fw_block``,
``fw_block_pred``) with their ms a step and the cluster size that their
launches on each path recorded on the card (checked against the plan).
The last line of its output is ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero; without a CUDA device, or without the repo's
``src/`` beside it, it exits non-zero before printing any result.

``python3 chip_smoke.py --times ROOT`` only times, as phase 4 does
(``timings``, ``product_times``): ``fw_round`` a round and a grid,
``fw_block`` and ``fw_block_pred`` a tile (a wrapper call, and the
kernel's device time in a traced solve), the product kernels at the
rounds' shapes (a wrapper call, and each grid's device time), the pred
solve's device rows, ``minplus.cu``'s ptxas report, the four solve
paths at N = 8192, and the row pass (``row_close_times``), for the package
under ``ROOT/src`` (this tree, or another commit unpacked with ``git
archive``), and prints them as one JSON line.
Run it on two trees in turns, in one run on one card, to compare them.
"""

from __future__ import annotations

import ctypes
import functools
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEMIRING_NAMES = ("tropical", "bottleneck", "reliability", "boolean")
# Tile sizes that exercise the cluster closure's layout (8 CTAs a tile):
# B < 8 (CTAs that own no rows), B not a multiple of 8, one row a CTA, and
# full width.
CLOSURE_B = (1, 5, 8, 9, 31, 32, 33, 100, 255, 256)
SOLVE_PATHS = {"main N=8192": {}, "with_pred N=8192": {"with_pred": True},
               "split N=8192": {"round_mode": "split"},
               "split with_pred N=8192": {"round_mode": "split", "with_pred": True}}
# The paths whose traced grids the kernels line reads (fw_round's grids,
# fw_block_pred, fw_block), and the split pred path, whose trace must hold
# no gather row either.
TRACED_PATHS = ("main N=8192", "with_pred N=8192", "split N=8192", "split with_pred N=8192")
# Tiles above the cluster closure's 256 nodes (the grid closure): the
# reference's own cells use 512 and 1024.
LARGE_B = (512, 1024)


class SmokeFailure(RuntimeError):
    pass


T_START = time.perf_counter()


def elapsed(label: str) -> None:
    """Print the seconds since the script started, at a phase's start."""
    print(f"[{time.perf_counter() - T_START:.1f} s] {label}", flush=True)


def kernel_module(name: str):
    """The port's kernel submodule ``repro_torch.kernels.<name>``.  By module
    path: ``repro_torch.kernels.fw_round`` (and ``.fw_block``, ``.minplus``)
    is the ops function of that name, as in ``repro.kernels``, in trees that
    bind ``repro.kernels``' names, and the submodule in older ones."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, NaN in the same places."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the entries finite in both."""
    a, b = a.float(), b.float()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


ZERO_ONE = {"tropical": (np.inf, 0.0), "bottleneck": (-np.inf, np.inf),
            "reliability": (0.0, 1.0), "boolean": (0.0, 1.0)}


def draw(rng: np.random.Generator, shape, name: str, ties: bool = False,
         density: float = 0.4) -> np.ndarray:
    """Random matrix of ``shape`` in the semiring's domain: ~``density``
    edges, the zero elsewhere.  ``ties`` draws from a few values, so many
    candidates of an element are equal."""
    if name == "reliability":
        vals = rng.choice([0.25, 0.5, 1.0], size=shape) if ties else rng.uniform(0.05, 0.999, size=shape)
    elif name == "boolean":
        vals = np.ones(shape)
    else:
        vals = rng.integers(1, 4, size=shape) if ties else rng.uniform(1, 100, size=shape)
    return np.where(rng.uniform(size=shape) < density, vals, ZERO_ONE[name][0]).astype(np.float32)


def in_domain(rng: np.random.Generator, n: int, name: str) -> np.ndarray:
    """Random (n, n) matrix in the semiring's domain: ~40% edges, the zero
    elsewhere off the diagonal, the one on it."""
    out = draw(rng, (n, n), name)
    np.fill_diagonal(out, ZERO_ONE[name][1])
    return out


def operand(rng: np.random.Generator, shape, name: str, ties: bool = False,
            density: float = 0.4) -> torch.Tensor:
    """``draw`` on the card."""
    return torch.from_numpy(draw(rng, shape, name, ties, density)).cuda()


def cuda_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(cuda_ms(fn) for _ in range(reps))


def launch_counts():
    """The port's launch counters by kernel (``fw_round``: its rounds, four
    grids each), added up by each wrapper where it launches."""
    return {"fw_round": kernel_module("fw_round").rounds,
            **{k: v for name in ("minplus", "fw_block", "row_close")
               for k, v in kernel_module(name).launches.items()}}


def lost_launches(prof):
    """The launch calls (runtime or driver API) of a finished trace whose
    grid the profiler did not record, each with its place among the
    trace's launch calls and its ms from the window's start and to its
    end; and the count of launch calls."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    t0 = min(e.start_ns() for e in evs)
    t1 = max(e.start_ns() + e.duration_ns() for e in evs)
    seen = {i for e in evs if e.device_type() == DeviceType.CUDA
            for i in (e.correlation_id(), e.linked_correlation_id()) if i}
    calls = sorted((e for e in evs if e.device_type() == DeviceType.CPU
                    and e.name().startswith("cu") and "aunch" in e.name()),
                   key=lambda e: e.start_ns())
    lost = [{"call": e.name(), "index": i, "of": len(calls),
             "ms_from_start": (e.start_ns() - t0) / 1e6,
             "ms_to_end": (t1 - e.start_ns() - e.duration_ns()) / 1e6}
            for i, e in enumerate(calls)
            if not ({e.correlation_id(), e.linked_correlation_id()} & seen)]
    return lost, len(calls)


TRACE_ATTEMPTS = 3


def device_breakdown(label: str, run):
    """Trace ``run`` with torch.profiler; print and return the device rows
    (kernels, memcpy, memset) summed by name, the busy ms, the window and
    the launches the port's counters saw during ``run`` (the profiler can
    lose a grid, PERF.md §7: the counters are what launch checks read).
    A trace in which the profiler recorded no device activity at all is
    taken again, up to ``TRACE_ATTEMPTS`` times (``run`` runs once more
    each time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        before = launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        after = launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        events = list(prof.events())
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        if device:
            break
        # The profiler loses the first records of a trace (PERF.md §7): a
        # window of a few launches can lose them all.  Trace it again.
        print(f"{label}: the profiler recorded no device activity (attempt {attempt} of "
              f"{TRACE_ATTEMPTS}, launches by the counters {json.dumps(launched)})")
    check(bool(device), f"{label}: the profiler recorded no device activity in "
          f"{TRACE_ATTEMPTS} traces")
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) / 1e3
    busy = sum(e.time_range.end - e.time_range.start for e in device) / 1e3
    per_kernel = {}
    for e in device:
        ms, count = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, count + 1)
    print(f"device breakdown of {label} (torch.profiler, traced window {window:.3f} ms, "
          f"device busy {busy:.3f} ms = {100 * busy / window:.1f}%):")
    for name, (ms, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.3f} ms  x{count:<4d} {name[:110]}")
    print(f"  launches by the port's counters: {json.dumps(launched)}")
    lost, n_calls = lost_launches(prof)
    if lost:
        print(f"  launch calls whose grid the profiler did not record: {len(lost)} of "
              f"{n_calls}, places {[c['index'] for c in lost]}, "
              f"{min(c['ms_from_start'] for c in lost):.3f}-"
              f"{max(c['ms_from_start'] for c in lost):.3f} ms after the window opened")
    return per_kernel, busy, window, launched


def grid_count(per_kernel, kernel: str) -> int:
    """Grids ``repro_torch::<kernel><...>`` that the profiler recorded in a
    trace: a printed figure, never a launch count."""
    return sum(c for name, (_, c) in per_kernel.items() if f"repro_torch::{kernel}<" in name)


def traced_grid_ms(label: str, per_kernel, launched: int, kernel: str) -> float:
    """Device ms a grid of ``kernel`` in a trace whose run launched it
    ``launched`` times (by the counters): the profiler must have seen at
    least one grid of it and no more than were launched.  Prints the
    profiler's count beside the counters' and the gap."""
    seen = grid_count(per_kernel, kernel)
    check(1 <= seen <= launched, f"{label}: the profiler recorded {seen} {kernel} grids of "
          f"{launched} launched")
    if seen != launched:
        print(f"{label}: the profiler recorded {seen} of {launched} {kernel} grids "
              f"(gap {launched - seen}); its ms a grid is the mean of those")
    return grid_ms(per_kernel, kernel)


def grid_ms(per_kernel, kernel: str) -> float:
    """Device ms a launch of the CUDA grid ``repro_torch::<kernel><...>`` in a trace."""
    rows = [(ms, c) for name, (ms, c) in per_kernel.items() if f"repro_torch::{kernel}<" in name]
    return sum(ms for ms, _ in rows) / max(1, sum(c for _, c in rows))


def device_ms(fn, reps: int = 10) -> float:
    """Device ms of the grids one call of ``fn`` launches: CUDA events around
    the call, recorded while a spin kernel (``torch.cuda._sleep``, about a
    millisecond) still holds the card, so that the host's time to enqueue
    the call is hidden; median of ``reps`` after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def product_times(h: torch.Tensor, b: int = 256):
    """The product kernels at the blocked-FW shapes of an (N, N) state on
    the card, pivot block at N/2: ``minplus`` (split round: full update,
    row and column panels), ``minplus_argmin`` (pred round's stages 3 and 2)
    and, in trees that have it, ``minplus_pred`` (the same stages with the
    pred epilogue, stage 2 on strided panels as the round passes them).
    Each shape: a wrapper call's ms (CUDA events, median of 10) and the
    device ms of the grids it launches (``device_ms``)."""
    from repro_torch.core import init_pred

    mp = kernel_module("minplus")
    n, o = h.shape[0], h.shape[0] // 2
    col, row = h[:, o:o + b].contiguous(), h[o:o + b, :].contiguous()
    piv = h[o:o + b, o:o + b].contiguous()
    p = init_pred(h)
    pcol, prow, ppiv = p[:, o:o + b], p[o:o + b, :], p[o:o + b, o:o + b].contiguous()
    shapes = {
        f"minplus full update {n}x{b} x {b}x{n} accumulate": lambda: mp.minplus_cuda(col, row, h),
        f"minplus row panel {b}x{b} x {b}x{n}": lambda: mp.minplus_cuda(piv, row),
        f"minplus column panel {n}x{b} x {b}x{b}": lambda: mp.minplus_cuda(col, piv),
        f"minplus_argmin stage 3 {n}x{b} x {b}x{n} accumulate":
            lambda: mp.minplus_argmin_cuda(col, row, h),
        f"minplus_argmin stage 2 {n}x{b} x {b}x{b} accumulate":
            lambda: mp.minplus_argmin_cuda(col, piv, col),
    }
    if hasattr(mp, "minplus_pred_cuda"):
        shapes[f"minplus_pred stage 3 {n}x{b} x {b}x{n} accumulate"] = lambda: mp.minplus_pred_cuda(
            col, row, pcol, prow, h, p, k_offset=o)
        shapes[f"minplus_pred stage 2 {n}x{b} x {b}x{b} accumulate"] = lambda: mp.minplus_pred_cuda(
            h[:, o:o + b], piv, pcol, ppiv, h[:, o:o + b], pcol, k_offset=o, j_offset=o)
    return {label: {"ms": median_ms(fn, reps=10), "device_ms": device_ms(fn)}
            for label, fn in shapes.items()}


# Row lists of the row-close pass that are timed: two short lists (the
# split-k grid) and two long ones (the engine's n/8 and n/4 buckets).
ROW_CLOSE_R = (16, 64, 1024, 2048)
ROW_CLOSE_MODES = ("row_close", "row_close_argmin", "row_close_pred")


def row_close_times(h: torch.Tensor):
    """The row-close pass on the (N, N) matrix h on the card, for r in
    ``ROW_CLOSE_R`` distinct sorted row ids (drawn from a seed, as the
    engine lists its affected rows): the device ms (``device_ms``) of each
    mode's wrapper (``row_close_pred`` in trees that have it), and of the
    whole pass ``ops.row_restricted_close`` without and with preds (the
    panel, the pred rule and the write-back), which every tree has.  A
    wrapper call's device ms holds the host's time between its row check,
    which synchronises, and its launch; in trees whose wrapper can hand out
    its launch (``_prepare``), each mode's grids are also timed alone
    ("<mode> kernel")."""
    from repro_torch.core import init_pred
    from repro_torch.kernels import ops

    rc = kernel_module("row_close")
    n = h.shape[0]
    p = init_pred(h)
    perm = np.random.default_rng(5).permutation(n)
    out = {}
    for r in ROW_CLOSE_R:
        rows = torch.from_numpy(np.sort(perm[:r]).astype(np.int32)).cuda()
        calls = {"row_close": lambda: rc.row_close_cuda(h, rows),
                 "row_close_argmin": lambda: rc.row_close_cuda(h, rows, track=True),
                 "pass": lambda: ops.row_restricted_close(h, rows),
                 "pass with preds": lambda: ops.row_restricted_close(h, rows, pred=p)}
        if hasattr(rc, "row_close_pred_cuda"):
            calls["row_close_pred"] = lambda: rc.row_close_pred_cuda(h, rows, p)
        if hasattr(rc, "_prepare"):
            for mode in ROW_CLOSE_MODES:
                launch = rc._prepare(mode, h, rows, p if mode == "row_close_pred" else None,
                                     "tropical")[0]
                calls[f"{mode} kernel"] = lambda launch=launch: check(
                    launch() == 0, "a timed row_close launch failed")
        out[r] = {name: device_ms(fn) for name, fn in calls.items()}
    return out


def bounds():
    """``repro_torch.roofline.kernels``: each kernel's work and least time
    on the card (importable once the repo's ``src/`` is on the path)."""
    from repro_torch.roofline import kernels

    return kernels


SASS_FUNC = re.compile(r"Function : (\S+)")
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


@functools.lru_cache(maxsize=None)
def sass_text(lib: str) -> str:
    """``cuobjdump -sass`` of a built library, dumped once a library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout


def sass_loops(build, name: str, kernel: str, op: str = "FADD"):
    """The loops of one kernel in the SASS of ``csrc/<name>.cu``'s library
    (``cuobjdump -sass``; ``build`` is ``repro_torch.kernels._build``), one
    for each backward branch, hottest first: by the count of ``op``
    instructions in the body, then innermost first.  ``kernel`` is a
    ``ptxas_report`` key such as ``fw_update<0,float>``.  Each loop gives
    its address range, its length in instructions, its ``op`` count and a
    histogram of its opcodes (with modifiers)."""
    lib, _ = build.paths(name)
    text = sass_text(str(lib))
    body, current = [], None
    for line in text.splitlines():
        m = SASS_FUNC.search(line)
        if m:
            current = build.kernel_key(m.group(1))
            continue
        if current == kernel:
            m = SASS_LINE.search(line)
            if m:
                body.append((int(m.group(1), 16), m.group(3), m.group(4)))
    check(bool(body), f"no SASS for {kernel} in {lib}")
    loops = []
    for i, (addr, opcode, args) in enumerate(body):
        t = re.search(r"0x([0-9a-f]+)", args) if opcode.startswith("BRA") else None
        if t is None or int(t.group(1), 16) >= addr:
            continue
        start = next(j for j, b in enumerate(body) if b[0] >= int(t.group(1), 16))
        ops = [b[1] for b in body[start:i + 1]]
        hist = {}
        for o in ops:
            hist[o] = hist.get(o, 0) + 1
        loops.append({"start": body[start][0], "end": addr, "instructions": len(ops),
                      op: sum(o.split(".")[0] == op for o in ops),
                      "histogram": dict(sorted(hist.items(), key=lambda kv: -kv[1]))})
    check(bool(loops), f"{kernel} has no loop")
    return sorted(loops, key=lambda lp: (-lp[op], lp["instructions"]))


def clusters_seen(build):
    """The cluster size, in CTAs, that each closure's latest launch ran on,
    as the kernel read it from ``%cluster_nctarank`` and recorded it on the
    card (``cluster_ctas_seen`` in ``csrc/fw_closure.cuh``); reading sets
    the records back to 0, and 0 means no launch since the last read."""
    torch.cuda.synchronize()
    fb_read = build.load("fw_block").fw_block_cluster_ctas
    fb_read.argtypes = [ctypes.c_int]
    seen = {"fw_closure": build.load("fw_round").fw_round_cluster_ctas(),
            "fw_block": fb_read(0), "fw_block_pred": fb_read(1)}
    check(all(v >= 0 for v in seen.values()), f"reading the closures' cluster sizes failed: {seen}")
    return seen


def timings(repro_torch, h: torch.Tensor, label: str = ""):
    """What ``main()`` and ``--times`` both measure of the package imported
    as ``repro_torch`` on the (N, N) graph ``h`` on the card, B = 256:
    ``fw_round_cuda`` a round (every round of three passes, CUDA events), a
    ``torch.profiler`` trace of one warm solve of each path that the
    kernels line reads (``TRACED_PATHS``, ``device_breakdown``) and each
    path's median solve ms.  It uses only the wrappers and ``solve``, whose interface every
    tree of the port shares."""
    from repro_torch.core.semiring import pad_to_multiple

    fr = kernel_module("fw_round")
    n, b = h.shape[0], 256
    d = pad_to_multiple(h, b).clone()
    round_ms = []
    for _ in range(3):
        d.copy_(h)
        for t in range(n // b):
            round_ms.append(cuda_ms(lambda: fr.fw_round_cuda(d, t * b, block_size=b)))
    traces = {}
    for path in TRACED_PATHS:
        options = SOLVE_PATHS[path]
        repro_torch.solve(h, **options)
        torch.cuda.synchronize()
        traces[path] = device_breakdown(f"one solve, {path}{label}",
                                        lambda: repro_torch.solve(h, **options))
    solve_ms = {path: median_ms(lambda o_=o_: repro_torch.solve(h, **o_))
                for path, o_ in SOLVE_PATHS.items()}
    return {"round_ms": round_ms, "traces": traces, "solve_ms": solve_ms}


def times(root: Path) -> int:
    """``--times ROOT``: the kernel and solve times of the package under
    ``ROOT/src`` at N = 8192, B = 256 (``timings``, ``product_times``,
    ``fw_block`` / ``fw_block_pred`` a wrapper call on the pivot tile at
    N/2, and ``row_close_times``), as one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root.resolve() / "src"))
    import repro_torch
    from repro_torch.core import init_pred
    from repro_torch.kernels import _build

    fb = kernel_module("fw_block")
    card = nvidia_smi("name,power.limit")
    _build.build(_build.sources())
    n, b = 8192, 256
    h = torch.from_numpy(repro_torch.generate_np(np.random.default_rng(0), n, rho=2.0).h).cuda()
    got = timings(repro_torch, h, f" ({root})")
    main_rows, busy, window = got["traces"]["main N=8192"][:3]
    o = n // 2
    piv = h[o:o + b, o:o + b].contiguous()[None]
    ppiv = init_pred(h)[o:o + b, o:o + b].contiguous()[None]
    print(json.dumps({
        "root": str(root), "card": card, "package": repro_torch.__file__,
        "fw_round_ms": statistics.median(got["round_ms"]),
        "grid_ms": {k: grid_ms(main_rows, k)
                    for k in ("fw_closure", "fw_panels", "fw_colpanel", "fw_update")},
        "device_busy_share": busy / window,
        "tile_ms": {"fw_block": median_ms(lambda: fb.fw_block_cuda(piv), reps=10),
                    "fw_block_pred": median_ms(lambda: fb.fw_block_pred_cuda(piv, ppiv), reps=10)},
        "tile_device_ms": {
            "fw_block": grid_ms(got["traces"]["split N=8192"][0], "fw_block"),
            "fw_block_pred": grid_ms(got["traces"]["with_pred N=8192"][0], "fw_block_pred")},
        "solve_ms": got["solve_ms"],
        "products": product_times(h),
        "pred_solve_rows": {name[:90]: v
                            for name, v in got["traces"]["with_pred N=8192"][0].items()},
        "ptxas_minplus": _build.ptxas_report("minplus"),
        "row_close": row_close_times(h),
        "ptxas_row_close": _build.ptxas_report("row_close"),
    }))
    return 0


def profiler_study(out: Path) -> int:
    """``--profiler-study [OUT]``: why ``torch.profiler`` loses grids of the port's
    kernels (PERF.md §7).  Traces windows that launch the port's kernels
    (through the ctypes wrappers, each C entry point launching with the
    CUDA runtime that nvcc links into its library) and PyTorch's own, five
    times each: one ``fw_block`` tile; one ``torch`` add; 32 pairs of both;
    and twenty times each: one squaring solve at N = 4096 (12 ``minplus``)
    and one pred solve at N = 8192 (32 ``fw_block_pred``, 64
    ``minplus_pred``).  Each window runs plain, with a PyTorch kernel
    first, with the run started 0.02 s after the window opens, and with a
    0.2 s sleep after the last synchronise before the profiler stops.  For each trace it counts, against the launch
    counters, the grids recorded, the launch calls recorded, and the
    launch calls whose grid is missing (``lost_launches``: their place in
    the window); the events of each first trace go to the JSON file ``out``
    (by default ``build/profiler_study.json``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.kernels import _build

    card = nvidia_smi("name,power.limit")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build(_build.sources())
    fb = kernel_module("fw_block")
    rng = np.random.default_rng(0)
    tile = torch.from_numpy(in_domain(rng, 256, "tropical")).cuda()[None]
    x = torch.zeros(1 << 20, device="cuda")
    h4 = torch.from_numpy(repro_torch.generate_np(np.random.default_rng(0), 4096, rho=2.0).h).cuda()
    h8 = torch.from_numpy(repro_torch.generate_np(np.random.default_rng(0), 8192, rho=2.0).h).cuda()

    def pairs():
        for _ in range(32):
            fb.fw_block_cuda(tile)
            x.add_(1.0)

    runs = {"one fw_block": lambda: fb.fw_block_cuda(tile),
            "one torch add": lambda: x.add_(1.0),
            "32 x (fw_block, torch add)": pairs,
            "squaring N=4096": lambda: repro_torch.solve(h4, method="squaring"),
            "with_pred N=8192": lambda: repro_torch.solve(h8, with_pred=True)}
    modes = {"plain": (False, 0.0, 0.0), "torch kernel first": (True, 0.0, 0.0),
             "0.02 s settle after the window opens": (False, 0.02, 0.0),
             "sleep 0.2 s before stop": (False, 0.0, 0.2)}
    raw, summary = {}, {}
    for run_label, run in runs.items():
        run()
        torch.cuda.synchronize()
        for mode, (first, settle, sleep) in modes.items():
            rows = []
            for rep in range(20 if "N=" in run_label else 5):
                before = launch_counts()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    if first:
                        x.add_(1.0)
                    if settle:
                        time.sleep(settle)
                    run()
                    torch.cuda.synchronize()
                    if sleep:
                        time.sleep(sleep)
                after = launch_counts()
                launched = sum(after[k] - before[k] for k in after)
                evs = prof.profiler.kineto_results.events()
                t0 = min(e.start_ns() for e in evs)
                t1 = max(e.start_ns() + e.duration_ns() for e in evs)
                grids = [e for e in evs if e.device_type() == DeviceType.CUDA
                         and not e.name().startswith(("Memcpy", "Memset"))]
                ours = [e for e in grids if "repro_torch::" in e.name()]
                lost, n_calls = lost_launches(prof)
                rows.append({"launched_by_counters": launched,
                             "grids_recorded": len(grids), "ours_recorded": len(ours),
                             "launch_calls_recorded": n_calls, "calls_without_grid": lost,
                             "window_ms": (t1 - t0) / 1e6})
                if rep == 0:
                    raw[f"{run_label} | {mode}"] = [
                        (str(e.device_type()), e.name()[:80], (e.start_ns() - t0) / 1e3,
                         e.duration_ns() / 1e3, e.correlation_id(), e.linked_correlation_id())
                        for e in sorted(evs, key=lambda e: e.start_ns())]
            summary[f"{run_label} | {mode}"] = rows
            print(f"profiler study {run_label} | {mode}: "
                  + json.dumps([{k: r[k] for k in ("launched_by_counters", "ours_recorded",
                                                   "grids_recorded", "launch_calls_recorded")}
                                | {"calls_without_grid": len(r["calls_without_grid"])}
                                for r in rows]))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card, "summary": summary, "events": raw}))
    print(json.dumps({"profiler_study": {k: [(r["launched_by_counters"], r["ours_recorded"],
                                              len(r["calls_without_grid"])) for r in v]
                                         for k, v in summary.items()}}))
    return 0


def tree_worsening(rng: np.random.Generator, eng, k: int, cap: int):
    """Up to k edges of ``eng``'s recorded shortest-path trees (the last hops
    ``pred[i, j] -> j`` of sampled reachable pairs), each made 100-300
    dearer: a worsening batch for the row-restricted re-close.  An edge is
    taken only while the sources whose tree ends in it (``pred[:, v] == u``,
    the rows the engine will re-close) stay at most ``cap`` in all (below
    the engine's ``row_threshold`` of n / 2).
    (``generate_edge_updates`` worsens random pairs, and at 1% density
    almost every random pair is a missing edge, so its "worsenings" are
    inserts.)"""
    n = eng.n
    pairs = rng.integers(0, n, (32 * k, 2))
    last = eng.pred[torch.from_numpy(pairs[:, 0]).cuda(),
                    torch.from_numpy(pairs[:, 1]).cuda()].cpu().numpy()
    rows = torch.zeros(n, dtype=torch.bool, device=eng.pred.device)
    edges = []
    for (i, j), p in zip(pairs, last):
        if len(edges) == k:
            break
        if i == j or p < 0 or (int(p), int(j)) in edges:
            continue
        grown = rows | (eng.pred[:, int(j)] == int(p))
        if int(grown.sum()) <= cap:
            rows = grown
            edges.append((int(p), int(j)))
    check(bool(edges), "dynamic: found no tree edge to worsen")
    u = np.array([e[0] for e in edges], np.int32)
    v = np.array([e[1] for e in edges], np.int32)
    h = eng.h
    return u, v, (h[u, v] + rng.integers(100, 300, len(u))).astype(np.float32)


def drive_dynamic(dev, card: str, n: int = 8192):
    """Phase 6: the dynamic engine at N = ``n``.  Returns the launches of
    each kernel in the checked stream, a summary of update times by path,
    and the largest |error| of a ``row_close`` launch against its plain
    version."""
    import scipy.sparse
    from scipy.sparse.csgraph import dijkstra

    import repro_torch
    from repro_torch.core import path_cost, reconstruct_path, validate_tree
    fb, fr = kernel_module("fw_block"), kernel_module("fw_round")
    mp, rc = kernel_module("minplus"), kernel_module("row_close")

    g = repro_torch.generate_np(np.random.default_rng(0), n, rho=2.0 * 8192 / n)
    rng = np.random.default_rng(3)

    def engines():
        t0 = time.perf_counter()
        made = {"pred": repro_torch.DynamicAPSP(g.h, with_pred=True),
                "plain": repro_torch.DynamicAPSP(g.h),
                "pred warm twin": repro_torch.DynamicAPSP(g.h, with_pred=True, row_threshold=0.0),
                "plain warm twin": repro_torch.DynamicAPSP(g.h, row_threshold=0.0)}
        torch.cuda.synchronize()
        print(f"dynamic: four engines at N={n} built in {time.perf_counter() - t0:.1f} s")
        return made

    # Every row_close launch of the checked stream (any of its three modes)
    # is kept on its exact inputs and outputs, and replayed through the plain
    # version after the update.  The recorders call the wrappers, which
    # count the launches.
    recorded = []
    launch_row_close, launch_row_close_pred = rc.row_close_cuda, rc.row_close_pred_cuda

    def recorder(d, rows, *, track=False, semiring="tropical"):
        z, ks = launch_row_close(d, rows, track=track, semiring=semiring)
        recorded.append(("row_close_argmin" if track else "row_close", d.clone(), rows.clone(),
                         None, semiring, z.clone(), None if ks is None else ks.clone()))
        return z, ks

    def pred_recorder(d, rows, pred, *, semiring="tropical"):
        z, pz = launch_row_close_pred(d, rows, pred, semiring=semiring)
        recorded.append(("row_close_pred", d.clone(), rows.clone(), pred.clone(), semiring,
                         z.clone(), pz.clone()))
        return z, pz

    def counts():
        return {"fw_round": fr.rounds, **mp.launches, **fb.launches, **rc.launches}

    def zero_counts():
        fr.rounds = 0
        mp.launches.update(dict.fromkeys(mp.launches, 0))
        fb.launches.update(fw_block=0, fw_block_pred=0)
        rc.launches.update(dict.fromkeys(rc.launches, 0))

    def replay(step, label, mode, d, rows, pred, sr, z, out):
        """A recorded launch against its plain version; a pred launch also
        against the witness mode on the same inputs (a launch made only to
        compare, after the path's counts were read) through
        pred_from_kstar.  Returns the largest |error| of the values."""
        if mode == "row_close_pred":
            want_z, want_k = rc.row_close_torch(d, rows, track=True, semiring=sr)
            ppanel = pred.index_select(0, rows.long())
            want_o = mp.pred_from_kstar(want_k, ppanel, pred, fallback=ppanel)
            zk, ks = launch_row_close(d, rows, track=True, semiring=sr)
            check(same(zk, want_z) and torch.equal(ks, want_k),
                  f"dynamic step {step} {label}: row_close_argmin differs from the plain "
                  "version on a pred launch's inputs")
            held[("row_close_argmin", rows.numel() <= 64)] += 1
        else:
            want_z, want_o = rc.row_close_torch(d, rows, track=mode != "row_close", semiring=sr)
        check(same(z, want_z) and (out is None or torch.equal(out, want_o)),
              f"dynamic step {step} {label}: a {mode} launch differs from the plain version "
              "on its own inputs")
        held[(mode, rows.numel() <= 64)] += 1
        return abs_err(z, want_z)

    # (mode, r <= 64): launches held against the plain version; the
    # witness mode is held on the pred launches' inputs.
    held = {(m, short): 0 for m in rc.launches for short in (True, False)}
    rows_seen = {m: [] for m in rc.launches}

    eng = engines()
    twins_until = 2          # the twins take the first two batches only
    batches = []
    launches = {}
    replayed = 0
    err = 0.0
    rc.row_close_cuda, rc.row_close_pred_cuda = recorder, pred_recorder
    try:
        for step in range(7):
            # Worsenings of tree edges: up to n/8 affected rows (step 1),
            # n/4 (step 4, r above 1024), and at most 64 (step 6, the
            # short-row grid that splits k).
            if step in (1, 4, 6):
                batch = tree_worsening(rng, eng["pred"], 4 if step == 6 else 16,
                                       {1: n // 8, 4: n // 4, 6: 64}[step])
            elif step == 3:
                uw, vw, ww = tree_worsening(rng, eng["pred"], 8, n // 8)
                ud, vd, wd = repro_torch.generate_edge_updates(rng, eng["pred"].h, 8)
                batch = (np.r_[uw, ud], np.r_[vw, vd], np.r_[ww, wd])
            else:
                batch = repro_torch.generate_edge_updates(rng, eng["pred"].h, 16,
                                                          worsen_frac=0.5 if step < 5 else 0.0)
            batches.append(batch)
            for label, e in eng.items():
                if "twin" in label and step >= twins_until:
                    continue
                zero_counts()
                info = e.update(*batch)
                torch.cuda.synchronize()
                for kind, c in counts().items():
                    launches[kind] = launches.get(kind, 0) + c
                for mode, d, rows, pred, sr, z, out in recorded:
                    err = max(err, replay(step, label, mode, d, rows, pred, sr, z, out))
                    rows_seen[mode].append(rows.numel())
                    replayed += 1
                recorded.clear()
                cold = repro_torch.solve(e.h).dist
                check(torch.equal(e.dist, cold),
                      f"dynamic step {step} {label}: dist differs from a cold solve")
                del cold
                note = ""
                if e.pred is not None:
                    check(tree_holds(torch.as_tensor(e.h).to(e.dist.device), e.dist, e.pred),
                          f"dynamic step {step} {label}: invalid predecessor tree")
                    h = e.h
                    off = np.isfinite(h) & ~np.eye(n, dtype=bool)
                    graph = scipy.sparse.csr_matrix((h[off], np.nonzero(off)), shape=(n, n))
                    src = rng.choice(n, 4, replace=False)
                    dj = dijkstra(graph, directed=True, indices=src)
                    walked = 0
                    for row, s_ in enumerate(src):
                        for t_ in rng.integers(0, n, 8):
                            path = (e.path(int(s_), int(t_), max_len=32) if walked < 2
                                    else reconstruct_path(e.pred, int(s_), int(t_)))
                            if not np.isfinite(dj[row, t_]):
                                check(path is None, f"dynamic step {step}: a path to an "
                                      "unreachable node")
                                continue
                            check(path is not None and path[0] == s_ and path[-1] == t_
                                  and path_cost(h, path) == dj[row, t_],
                                  f"dynamic step {step} {label}: path {s_}->{t_} does not "
                                  "cost Dijkstra's distance")
                            walked += 1
                    note = f"; valid tree, {walked} paths cost Dijkstra's distance"
                print(f"dynamic step {step} {label}: {json.dumps(info)}; dist equal to a "
                      f"cold solve{note}")
                if "twin" in label:
                    twin_of = eng[label.replace(" warm twin", "")]
                    check(torch.equal(e.dist, twin_of.dist),
                          f"dynamic step {step}: {label} differs from its row-path engine")
    finally:
        rc.row_close_cuda, rc.row_close_pred_cuda = launch_row_close, launch_row_close_pred
    stats = {label: e.stats for label, e in eng.items()}
    print(f"dynamic stats: {json.dumps(stats)}")
    total = {k: sum(st[k] for st in stats.values()) for k in ("rank_k", "row_resolve",
                                                              "warm_resolve", "row_iters")}
    check(total["rank_k"] >= 1 and total["row_resolve"] >= 1 and total["warm_resolve"] >= 1
          and total["row_iters"] >= 1, f"dynamic: a path was not taken: {total}")
    row_launches = {m: launches[m] for m in rc.launches}
    check(sum(row_launches.values()) == replayed,
          f"dynamic: row_close launches {row_launches}, replayed {replayed}")
    # The plain engine's row pass launches row_close, the pred engine's
    # row_close_pred, each at r <= 64 and at r >= 1024; nothing on the path
    # launches row_close_argmin, which is held on the pred launches' inputs.
    for mode in ("row_close", "row_close_pred"):
        check(min(rows_seen[mode], default=n) <= 64 and max(rows_seen[mode], default=0) >= 1024,
              f"dynamic: {mode} ran at r = {sorted(set(rows_seen[mode]))}, not at both "
              "r <= 64 and r >= 1024")
    check(row_launches["row_close_argmin"] == 0,
          f"dynamic: the engine launched row_close_argmin: {row_launches}")
    check(all(held.values()), f"dynamic: a mode was not held at both sizes: {held}")
    check(launches["minplus"] > 0 and launches["minplus_argmin"] > 0,
          f"dynamic: the rank-k kernels did not run: {launches}")
    print(f"dynamic: launches in the checked stream {json.dumps(launches)}; every "
          f"row_close launch ({replayed}) equal to the plain version on its inputs; rows a "
          f"pass {json.dumps({m: sorted(set(v)) for m, v in rows_seen.items()})}; held "
          f"(mode, r <= 64): {json.dumps({f'{m} {s_}': c for (m, s_), c in held.items()})}")
    final = {label: (e.dist, e.pred) for label, e in eng.items()}
    del eng

    # The timed stream: fresh engines, the same batches, CUDA events around
    # each update.
    eng = engines()
    by_path = {}
    for step, batch in enumerate(batches):
        for label, e in eng.items():
            if "twin" in label and step >= twins_until:
                continue
            torch.cuda.synchronize()
            info = {}
            ms = cuda_ms(lambda: info.update(e.update(*batch)))
            by_path.setdefault(f"{label}: {info['path']}", []).append(ms)
    for label, e in eng.items():
        check(torch.equal(e.dist, final[label][0]) and
              (e.pred is None or torch.equal(e.pred, final[label][1])),
              f"dynamic: the timed {label} engine differs from the checked one")
    del eng, final
    summary = {k: {"ms": v, "median_ms": statistics.median(v)} for k, v in by_path.items()}
    print(f"dynamic update ms at N={n} on {card}: {json.dumps(summary)}")

    # The device breakdown of the first two updates of the pred engine and
    # its warm twin, on fresh engines (the rows of the trace name where an
    # update's time goes; the busy share says how far the host holds the
    # card back).
    traced = {"pred": repro_torch.DynamicAPSP(g.h, with_pred=True),
              "pred warm twin": repro_torch.DynamicAPSP(g.h, with_pred=True,
                                                        row_threshold=0.0)}
    for step in range(twins_until):
        for label, e in traced.items():
            info = {}
            rows_, busy, window, launched = device_breakdown(
                f"update {step} of the {label} engine",
                lambda: info.update(e.update(*batches[step])))
            summary[f"traced {label} step {step}: {info['path']}"] = {
                "device_busy_ms": busy, "window_ms": window, "busy_share": busy / window}
            if info["path"] == "row_resolve":
                # The pred rule runs in row_close_pred's epilogue: the row
                # update holds no gather row and no witness launch.
                gathers = [name for name in rows_ if "gather" in name.lower()]
                check(not gathers and not launched.get("row_close_argmin"),
                      f"update {step} of the {label} engine: gather rows {gathers}, "
                      f"launches {launched}")
                check(launched.get("row_close_pred") == info["iters"],
                      f"update {step} of the {label} engine: {launched} for "
                      f"{info['iters']} passes")
                print(f"update {step} of the {label} engine: no gather row, no "
                      f"row_close_argmin launch; row_close_pred launched {info['iters']} "
                      f"times, one a pass (counters); the profiler recorded "
                      f"{grid_count(rows_, 'row_close_pred')} of its grids")
    del traced

    return launches, summary, err


METHOD_NAMES = ("squaring", "squaring_3d", "classic", "blocked_fw", "rkleene")
# Phase 7's shapes: the reference's square_4k cell for squaring (its plain
# pred squaring at 2048), the rkleene_16k cell's N on one card, the paper's
# own N = 1024 ceiling for the 3D tensor, classic at 2048, an R-Kleene
# quadrant split of a 2000-node state, and a G = 64 batch of N = 1024.
PAPER_N = {"squaring": 4096, "squaring plain pred": 2048, "squaring_3d": 1024, "classic": 2048,
           "quadrants": 2000, "batch": (64, 1024)}
# The ragged stack every method solves under every semiring.
RAGGED = (4, 256, 17, 100, 33, 200, 7, 64)


def rkleene_launches(n: int, base: int, pred: bool):
    """(products, leaves) of one R-Kleene solve of n nodes: six products and
    two halves a level above ``base``, on the grid the solver pads to."""
    rk = importlib.import_module("repro_torch.core.rkleene")

    def count(m):
        if m <= base:
            return 0, 1
        half = m // 2 if pred else rk.split_point(m, base)
        p1, l1 = count(half)
        p2, l2 = count(m - half)
        return 6 + p1 + p2, l1 + l2

    return count(rk.pow2_size(n, base) if pred else rk.padded_size(n, base))


def tree_holds(h: torch.Tensor, dist: torch.Tensor, pred: torch.Tensor) -> bool:
    """``validate_tree``'s invariant, tropical, on the card: every reachable
    dist[i, j] (i != j) is dist[i, p] + h[p, j] for p = pred[i, j], within
    the same tolerance.  The host's ``validate_tree`` takes 5.6 s at N =
    8192, so the smoke calls it once (phase 3b) and this everywhere else."""
    n = h.shape[0]
    reach = torch.isfinite(dist) & ~torch.eye(n, dtype=torch.bool, device=dist.device)
    if bool((pred[reach] < 0).any()):
        return False
    p = pred.clamp(min=0).long()
    rhs = torch.gather(dist, 1, p) + h[p, torch.arange(n, device=h.device)[None, :]]
    return bool(torch.allclose(dist[reach], rhs[reach], rtol=1e-5, atol=1e-5))


def drive_paper(card: str, h16: torch.Tensor, blocked16_ms: float):
    """Phase 7: the paper's evaluation on the card.  (a) Its 1000-graph
    corpus (``paper_corpus(seed=0)``) through ``solve_batch`` bucketed
    (``blocked_fw`` without and with preds, ``squaring``, ``rkleene``) and
    as one stack (``blocked_fw`` without and with preds): each graph equal
    to its own card solve, bucketed equal to single stack, every 100th
    graph equal to scipy's Dijkstra, every pred tree valid.  (b) Each
    method at full width on one graph, with its launch counts, and a ragged
    G = 8 stack of every method under every semiring against the per-graph
    solves and the CPU.  (c) The kernels on the slice's new shapes against
    their plain versions.  (d) Traces of one squaring and one R-Kleene
    solve.  ``h16`` is the N = 16384 graph on the card, ``blocked16_ms``
    its blocked solve's ms at B = 256.  Returns (launches by path, largest
    |error| by kernel, times)."""
    import scipy.sparse
    from scipy.sparse.csgraph import dijkstra

    import repro_torch
    from repro_torch.core import init_pred, validate_tree
    rk = importlib.import_module("repro_torch.core.rkleene")
    from repro_torch.core.semiring import ceil_log2
    fb, fr, mp = kernel_module("fw_block"), kernel_module("fw_round"), kernel_module("minplus")

    t_phase = time.perf_counter()
    launches, times = {}, {}
    errs = dict.fromkeys(("fw_round", "minplus", "minplus_pred", "fw_block", "fw_block_pred"),
                         0.0)

    def counted(label, fn, expect=None):
        """``fn()`` with every count set to 0 just before and read just
        after; checked against ``expect`` where given."""
        fr.rounds = 0
        mp.launches.update(dict.fromkeys(mp.launches, 0))
        fb.launches.update(fw_block=0, fw_block_pred=0)
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in {"fw_round": fr.rounds, **mp.launches, **fb.launches}.items()
               if v}
        if expect is not None:
            check(got == expect, f"{label}: launches {got}, expected {expect}")
        launches[label] = got
        return out

    # (a) The paper's corpus: 1000 graphs, V ~ U[4, 1000], rho ~ U[0, 100].
    t0 = time.perf_counter()
    corpus = repro_torch.paper_corpus(seed=0)
    hs = [torch.from_numpy(g.h).cuda() for g in corpus]
    sizes = [g.n_nodes for g in corpus]
    print(f"paper corpus: {len(hs)} graphs, V {min(sizes)}-{max(sizes)}, "
          f"{sum(g.n_edges for g in corpus)} edges, made and uploaded in "
          f"{time.perf_counter() - t0:.1f} s")
    per_graph = counted("corpus per-graph solve", lambda: [repro_torch.solve(h).dist for h in hs])
    times["corpus per-graph solve loop"] = cuda_ms(lambda: [repro_torch.solve(h) for h in hs])
    runs = {  # label: (options, the kernels it launches)
        "bucketed blocked_fw": ({"bucket_by_size": True}, {"fw_round"}),
        "bucketed blocked_fw with_pred": ({"bucket_by_size": True, "with_pred": True},
                                          {"fw_block_pred", "minplus_pred"}),
        "bucketed squaring": ({"bucket_by_size": True, "method": "squaring"}, {"minplus"}),
        "bucketed rkleene": ({"bucket_by_size": True, "method": "rkleene"},
                             {"minplus", "fw_block"}),
        "single stack blocked_fw": ({}, {"fw_round"}),
        "single stack blocked_fw with_pred": ({"with_pred": True},
                                              {"fw_block_pred", "minplus_pred"}),
    }
    bucketed = {}
    tree_s = 0.0
    for label, (options, kinds) in runs.items():
        res = counted(f"corpus {label}", lambda: repro_torch.solve_batch(hs, **options))
        check(set(launches[f"corpus {label}"]) == kinds,
              f"corpus {label}: launched {launches[f'corpus {label}']}, expected {kinds}")
        check(res.dist.is_cuda and res.dist.shape == (len(hs), max(sizes), max(sizes)),
              f"corpus {label}: result {res.dist.device} {tuple(res.dist.shape)}")
        for i, want in enumerate(per_graph):
            check(torch.equal(res.unpadded(i).dist, want),
                  f"corpus {label}: graph {i} (V={sizes[i]}) differs from its own solve")
        if res.pred is not None and label.startswith("bucketed"):
            t0 = time.perf_counter()
            for i, g in enumerate(corpus):
                u = res.unpadded(i)
                check(tree_holds(torch.from_numpy(g.h).to(u.dist.device), u.dist, u.pred),
                      f"corpus graph {i}: invalid pred tree")
            tree_s = time.perf_counter() - t0
        if label.startswith("bucketed blocked_fw"):
            bucketed[label] = res
        elif label.startswith("single stack"):
            twin = bucketed.pop(label.replace("single stack", "bucketed"))
            check(torch.equal(twin.dist, res.dist) and
                  (res.pred is None or torch.equal(twin.pred, res.pred)),
                  f"corpus {label}: differs from the bucketed solve")
            del twin
        del res
        times[f"corpus {label}"] = cuda_ms(lambda: repro_torch.solve_batch(hs, **options))
        print(f"corpus {label}: every graph equal to its own card solve; "
              f"{times[f'corpus {label}']:.1f} ms (CUDA events, one call); launches "
              f"{launches[f'corpus {label}']}")
    for i in range(0, len(corpus), 100):
        g = corpus[i]
        off = np.isfinite(g.h) & ~np.eye(g.n_nodes, dtype=bool)
        graph = scipy.sparse.csr_matrix((g.h[off], np.nonzero(off)), shape=g.h.shape)
        check(np.array_equal(per_graph[i].cpu().numpy().astype(np.float64),
                             dijkstra(graph, directed=True)),
              f"corpus graph {i}: differs from scipy's Dijkstra")
    del per_graph, hs
    print(f"corpus: bucketed equal to single stack (dist and pred); every pred tree valid "
          f"(on the card, {tree_s:.1f} s); graphs 0, 100, ..., 900 equal to Dijkstra; ms on "
          f"{card}: {json.dumps(times)}")

    # (b) Each method at full width on one graph of the paper's generator.
    def graph_of(n):
        return torch.from_numpy(
            repro_torch.generate_np(np.random.default_rng(0), n, rho=2.0).h).cuda()

    n_sq = PAPER_N["squaring"]
    h_sq, h_pl = graph_of(n_sq), graph_of(PAPER_N["squaring plain pred"])
    blocked_sq = repro_torch.solve(h_sq).dist
    iters = ceil_log2(n_sq)
    got = counted(f"squaring N={n_sq}", lambda: repro_torch.solve(h_sq, method="squaring"),
                  {"minplus": iters})
    check(same(got.dist, blocked_sq), f"squaring N={n_sq}: dist differs from the blocked solve's")
    got = counted(f"squaring with_pred N={n_sq}",
                  lambda: repro_torch.solve(h_sq, method="squaring", with_pred=True),
                  {"minplus_pred": iters})
    check(same(got.dist, blocked_sq) and tree_holds(h_sq, got.dist, got.pred),
          f"squaring with_pred N={n_sq}: dist differs or the tree is invalid")
    del got, blocked_sq
    for options in ({}, {"with_pred": True}):
        label = "squaring" + (" with_pred" if options else "") + f" N={n_sq}"
        times[label] = median_ms(lambda: repro_torch.solve(h_sq, method="squaring", **options))
    got = repro_torch.solve(h_pl, method="squaring", with_pred=True)
    d, p = h_pl, init_pred(h_pl)
    for _ in range(ceil_log2(h_pl.shape[0])):
        d, p = mp.minplus_pred_torch(d, d, p, p, d, p)
    check(same(got.dist, d) and torch.equal(got.pred, p),
          f"squaring with_pred N={h_pl.shape[0]}: differs from the plain pred squaring")
    del got, d, p
    print(f"squaring N={n_sq}: {iters} minplus ({iters} minplus_pred with preds), dist equal "
          f"to the blocked solve's, tree valid; with preds at N={h_pl.shape[0]} equal to the "
          f"plain pred squaring on the card; {times[f'squaring N={n_sq}']:.2f} / "
          f"{times[f'squaring with_pred N={n_sq}']:.2f} ms (median of 3)")

    n16 = h16.shape[0]
    blocked16 = repro_torch.solve(h16).dist
    for base, pred in ((64, False), (256, False), (64, True)):
        products, leaves = rkleene_launches(n16, base, pred)
        label = f"rkleene{' with_pred' if pred else ''} N={n16} base={base}"
        expect = {k: v for k, v in zip(("minplus_pred", "fw_block_pred") if pred
                                       else ("minplus", "fw_block"), (products, leaves)) if v}
        got = counted(label, lambda: repro_torch.solve(h16, method="rkleene", base=base,
                                                       with_pred=pred), expect)
        check(same(got.dist, blocked16) and (not pred or tree_holds(h16, got.dist, got.pred)),
              f"{label}: dist differs from the blocked solve's or the tree is invalid")
        del got
        times[label] = median_ms(lambda: repro_torch.solve(h16, method="rkleene", base=base,
                                                           with_pred=pred))
        print(f"{label}: {products} {'minplus_pred' if pred else 'minplus'} and {leaves} "
              f"{'fw_block_pred' if pred else 'fw_block'} launches, dist equal to the blocked "
              f"solve's{', tree valid' if pred else ''}; {times[label]:.1f} ms (median of 3; "
              f"blocked B=256 {blocked16_ms:.1f})")
    del blocked16
    times[f"blocked_fw N={n16} B=256 (phase 3c)"] = blocked16_ms

    for method in ("squaring_3d", "classic"):
        h_ = graph_of(PAPER_N[method])
        label = f"{method} N={h_.shape[0]}"
        got = counted(label, lambda: repro_torch.solve(h_, method=method), {})
        check(same(got.dist, repro_torch.solve(h_).dist), f"{label}: dist differs")
        del got
        times[label] = median_ms(lambda: repro_torch.solve(h_, method=method))
        print(f"{label}: no kernel launch, dist equal to the blocked solve's; "
              f"{times[label]:.1f} ms (median of 3)")

    # Under reliability (×, inexact) squaring's padded edge sets its
    # iteration count, and an extra squaring may round a product one ulp
    # higher: the JAX package's own batch and per-graph squaring differ so.
    # There the per-graph check takes the reference's tolerance (rtol and
    # atol 1e-5) and a valid tree; everywhere else it is exact.
    rng = np.random.default_rng(7)
    inexact = 0
    for name in SEMIRING_NAMES:
        mats = [in_domain(rng, n, name) for n in RAGGED]
        for method in METHOD_NAMES:
            kw = {"with_pred": method != "squaring_3d", "semiring": name}
            res = repro_torch.solve_batch(mats, method=method, **kw)
            cpu = repro_torch.solve_batch(mats, method=method, device="cpu", **kw)
            check(same(res.dist.cpu(), cpu.dist) and
                  (res.pred is None or torch.equal(res.pred.cpu(), cpu.pred)),
                  f"ragged {method} {name}: card differs from the CPU")
            for i, m in enumerate(mats):
                one = repro_torch.solve(m, method=method, **kw)
                u = res.unpadded(i)
                if same(u.dist, one.dist):
                    ok = u.pred is None or torch.equal(u.pred, one.pred)
                else:
                    inexact += 1
                    ok = (name == "reliability" and method.startswith("squaring") and
                          torch.allclose(u.dist, one.dist, rtol=1e-5, atol=1e-5) and
                          (u.pred is None or validate_tree(m, u.dist, u.pred, name)))
                check(ok, f"ragged {method} {name}: graph {i} differs from its own solve")
    print(f"ragged G={len(RAGGED)} (sizes {min(RAGGED)}-{max(RAGGED)}), five methods x four "
          f"semirings: equal to the same calls on the CPU; equal to the per-graph card "
          f"solves but for {inexact} reliability squaring graphs, within rtol 1e-5 with "
          f"valid trees")

    # (c) The kernels on the slice's new shapes against their plain versions.
    def hold(kind, label, cuda_fn, plain_fn, *args, **kw):
        got, want = cuda_fn(*args, **kw), plain_fn(*args, **kw)
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        check(same(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])),
              f"{kind} {label}: kernel differs from the plain version")
        errs[kind] = max(errs[kind], abs_err(got[0], want[0]))
        print(f"{kind} {label}: equal")

    for base in (64, 6):   # base 6: quadrants not 16-byte aligned (the copy path)
        n = rk.padded_size(PAPER_N["quadrants"], base)
        d = torch.from_numpy(in_domain(rng, n, "tropical")).cuda()
        p = init_pred(d)
        m = rk.split_point(n, base)
        a_, b_, c_, dd = d[:m, :m].contiguous(), d[:m, m:], d[m:, :m], d[m:, m:]
        hold("minplus", f"R-Kleene quadrant {n - m}x{m} x {m}x{n - m} accumulate base={base}",
             mp.minplus_cuda, mp.minplus_torch, c_, b_, dd)
        hold("minplus", f"R-Kleene quadrant {m}x{m} x {m}x{n - m} base={base}",
             mp.minplus_cuda, mp.minplus_torch, a_, b_)
        hold("minplus_pred", f"R-Kleene pred quadrant base={base} k_offset={m} j_offset=0",
             mp.minplus_pred_cuda, mp.minplus_pred_torch, dd, c_, p[m:, m:], p[m:, :m], c_,
             p[m:, :m], k_offset=m, j_offset=0)
        hold("minplus_pred", f"R-Kleene pred quadrant base={base} k_offset=0 j_offset={m}",
             mp.minplus_pred_cuda, mp.minplus_pred_torch, a_, b_, p[:m, :m], p[:m, m:], b_,
             p[:m, m:], k_offset=0, j_offset=m)
    hold("minplus", f"squaring N={n_sq}, x = y = a", mp.minplus_cuda, mp.minplus_torch,
         h_sq, h_sq, h_sq)
    p_pl = init_pred(h_pl)
    hold("minplus_pred", f"squaring N={h_pl.shape[0]}, x = y = a, px = py = pa",
         mp.minplus_pred_cuda, mp.minplus_pred_torch, h_pl, h_pl, p_pl, p_pl, h_pl, p_pl)
    g_, n_ = PAPER_N["batch"]
    b_ = min(256, n_ // 2)
    stack = torch.from_numpy(np.stack([in_domain(rng, n_, "tropical") for _ in range(g_)])).cuda()
    for o in (0, n_ // 2):
        got = fr.fw_round_cuda(stack.clone(), o, block_size=b_)
        want = fr.fw_round_torch(stack, o, block_size=b_)
        check(same(got, want), f"fw_round G={g_} N={n_} pivot {o // b_}: differs from the plain")
        errs["fw_round"] = max(errs["fw_round"], abs_err(got, want))
        print(f"fw_round G={g_} N={n_} B={b_} pivot {o // b_}: equal")
    del got, want
    tiles = stack[:, b_:2 * b_, b_:2 * b_].contiguous()
    ptiles = init_pred(stack)[:, b_:2 * b_, b_:2 * b_].contiguous()
    hold("fw_block", f"T={g_} B={b_} (the batch split round's pivots)", fb.fw_block_cuda,
         fb.fw_block_torch, tiles)
    hold("fw_block_pred", f"T={g_} B={b_} (the batch pred rounds' pivots)",
         fb.fw_block_pred_cuda, fb.fw_block_pred_torch, tiles, ptiles)
    del stack, tiles, ptiles

    # (d) Traces of one squaring and one R-Kleene solve.  The profiler may
    # drop grids of a traced solve (PERF.md §7), so each trace reports the
    # `minplus` grids it recorded beside the launches the counters saw; the
    # busy share of a trace that dropped some is a lower bound.
    traces = {}
    for label, fn in ((f"squaring N={n_sq}", lambda: repro_torch.solve(h_sq, method="squaring")),
                      (f"rkleene N={n16} base=64",
                       lambda: repro_torch.solve(h16, method="rkleene"))):
        rows_, busy, window, launched = device_breakdown(f"one solve, {label}", fn)
        check(launched == launches[label], f"traced {label}: launches {launched}, the "
              f"checked solve's {launches[label]}")
        traces[label] = {"busy_share": busy / window, "device_busy_ms": busy, "window_ms": window,
                         "minplus_grids_recorded": grid_count(rows_, "minplus"),
                         "minplus_launches": launched.get("minplus", 0),
                         "minplus_ms_a_grid": traced_grid_ms(
                             f"traced {label}", rows_, launched.get("minplus", 0), "minplus")}
        print(f"trace of {label}: {json.dumps(traces[label])}")
    times["traces"] = traces
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 7 on {card}: {times['phase_s']:.1f} s; {json.dumps(times)}")
    return launches, errs, times


# Phase 8's request counts: the smoke's time limit cuts these, never n.
SERVE_REQUESTS = {"8a": 32, "8b": 24, "8c": 64}
SERVE_METHODS = (("squaring", "squaring", False), ("blocked_fw", "blocked_fw", False),
                 ("blocked_fw --with-pred", "blocked_fw", True), ("rkleene", "rkleene", False))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def drive_serving(card: str, scratch: Path, lane_rate: float):
    """Phase 8: the serving tier on the card.  (a) ``serve_apsp`` at the
    paper's n_max = 1024 for squaring, blocked FW with and without preds
    and R-Kleene, after ``tune_fw_round(1024)`` has written a ``cuda``
    entry (the tuned solve equal to the default one).  (b)
    ``serve_apsp_dynamic`` on four N = 8192 slots without chaos, plain and
    with preds: no retry, quarantine, poisoned answer or drift, every
    batched drain of the pool held to its contract (no group deferred for a
    failure, ``batched == G``, one launch a pass).  (c) The chaos drills at
    N = 2048, sync and async + durable.  (d) ``apply_updates_batched`` on
    four N = 8192 engines against twins updated one by one, one launch a
    pass, timed against the sequential drains beside its byte bound.  (e)
    Engine checkpoints at N = 8192 with preds, f32 and bf16, restored and
    replayed bit-exact.  Returns (launches by path, largest |error| by
    kernel, times, entries for the kernels line)."""
    import repro_torch
    from repro_torch.checkpoint import load_engine_checkpoint, save_engine_checkpoint
    from repro_torch.core import (DynamicAPSP, UpdateJournal, apply_updates_batched,
                                  generate_edge_updates, generate_np)
    from repro_torch.kernels import autotune, ops
    from repro_torch.launch import serve
    dyn = importlib.import_module("repro_torch.core.dynamic")
    pool_mod = importlib.import_module("repro_torch.launch.pool")
    fb, fr, mp, rc = (kernel_module("fw_block"), kernel_module("fw_round"),
                      kernel_module("minplus"), kernel_module("row_close"))

    t_phase = time.perf_counter()
    launches, times, extra = {}, {}, {}
    errs = {"minplus": 0.0, "minplus_argmin": 0.0}

    def reset():
        fr.rounds = 0
        for counts_ in (mp.launches, fb.launches, rc.launches):
            counts_.update(dict.fromkeys(counts_, 0))

    def read():
        torch.cuda.synchronize()
        return {k: v for k, v in {"fw_round": fr.rounds, **mp.launches, **fb.launches,
                                  **rc.launches}.items() if v}

    # (a) serve_apsp at n_max = 1024, the round shape tuned first.
    n_max = 1024
    t0 = time.perf_counter()
    tuned = autotune.tune_fw_round(n_max, device="cuda")
    key = autotune.key_for_fw_round("cuda", torch.float32, n_max)
    check(tuned["source"] == "measured" and key in autotune.load_entries(),
          f"tune_fw_round({n_max}) wrote no {key} entry: {tuned}")
    b_t, rm_t = tuned["params"]["block_size"], tuned["params"]["round_mode"]
    h = generate_np(np.random.default_rng(8), n_max).h
    default = repro_torch.solve(h, block_size=256, round_mode="fused").dist
    check(torch.equal(repro_torch.solve(h, block_size=b_t, round_mode=rm_t).dist, default),
          f"the solve at the tuned (B={b_t}, {rm_t}) differs from the default solve")
    check(autotune.lookup_fw_round("cuda", torch.float32, n_max) == tuned["params"]
          and torch.equal(repro_torch.solve(h).dist, default),
          "the solve with no block size does not read the tuned entry")
    times["tune_fw_round n=1024 s"] = time.perf_counter() - t0
    print(f"phase 8a: tune_fw_round({n_max}) on {card}: {json.dumps(tuned)}; the tuned "
          f"solve equals the default (B=256, fused) bit for bit")
    expect = {"squaring": {"minplus"}, "rkleene": {"minplus", "fw_block"},
              "blocked_fw --with-pred": {"minplus_pred", "fw_block_pred"},
              "blocked_fw": {"fw_round"} if rm_t == "fused" else {"fw_block", "minplus"}}
    for label, method, pred in SERVE_METHODS:
        got = {}
        reset()
        rc_ = serve.serve_apsp(SERVE_REQUESTS["8a"], batch=16, n_max=n_max, method=method,
                               with_pred=pred, summary_out=got)
        lbl = f"serve_apsp {label} n_max={n_max}"
        launches[lbl] = read()
        check(rc_ == 0, f"{lbl} returned {rc_}")
        check(set(launches[lbl]) == expect[label],
              f"{lbl} launched {launches[lbl]}, expected the kernels {expect[label]}")
        times[lbl] = got
        print(f"phase 8a {lbl} on {card}: {got['graphs_per_s']:.1f} graphs/s end to end, "
              f"{got['steady_graphs_per_s']:.1f} steady, first cycle {got['first_cycle_s']:.2f} s; "
              f"launches {launches[lbl]}")

    # (b) serve_apsp_dynamic on four N = 8192 slots, no chaos.  Every batched
    # drain of the pool is held to its contract: nothing deferred but what
    # the classifier defers (a failed group would be), each rank-k member
    # reports its whole group, and the pass count is the launch count.
    drains = []
    real_batched = pool_mod.apply_updates_batched

    def held(engines, batches):
        check(all(e.dist.is_cuda for e in engines), "a CPU tensor on the card's batched drain")
        kinds = [dyn.DynamicAPSP._classify_batch(e, b_) for e, b_ in zip(engines, batches)]
        kb = {i: dyn._bucket_k(int(p_[0].size)) for i, (k_, p_) in enumerate(kinds)
              if k_ == "rank_k"}
        fam = "minplus" if engines[0].pred is None else "minplus_argmin"
        before = mp.launches[fam]
        infos, deferred = real_batched(engines, batches)
        torch.cuda.synchronize()
        check(set(deferred) == {i for i, (k_, _) in enumerate(kinds) if k_ == "defer"},
              f"the batched drain deferred {deferred} beyond the classifier's: a group failed")
        passes = {}
        for i, b_ in kb.items():
            g_ = sum(1 for c_ in kb.values() if c_ == b_)
            check(infos[i]["batched"] == g_, f"batched drain info {infos[i]}, group of {g_}")
            passes[b_] = infos[i]["passes"]
        check(mp.launches[fam] - before == sum(passes.values()),
              f"the batched drain launched {mp.launches[fam] - before} {fam}, "
              f"passes {passes}")
        drains.append({"engines": len(engines), "groups": passes, "deferred": deferred})
        return infos, deferred

    pool_mod.apply_updates_batched = held
    try:
        for pred in (False, True):
            lbl = f"serve_apsp_dynamic N=8192 {'with_pred' if pred else 'plain'}"
            out = {}
            drains.clear()
            reset()
            rc_ = serve.serve_apsp_dynamic(SERVE_REQUESTS["8b"], n_max=8192, graphs=4,
                                           mutate_rate=0.5, mutate_k=8, verify_every=16,
                                           seed=0, with_pred=pred, backlog_watermark=3,
                                           summary_out=out)
            launches[lbl] = read()
            s_ = out["summary"]
            check(rc_ == 0, f"{lbl} returned {rc_}")
            bad = {k_: v for k_, v in (("retries", s_["slots"]["retries"]),
                                      ("quarantines", s_["slots"]["quarantines"]),
                                      ("updates_failed", s_["pool"]["updates_failed"]),
                                      ("poisoned_served", s_["pool"]["poisoned_served"]),
                                      ("verify_drift", s_["pool"]["verify_drift"])) if v}
            check(not bad and out["verify_drift"] == 0, f"{lbl}: {bad}")
            check(drains, f"{lbl}: the pool ran no batched drain")
            stats = out["engine_stats"]
            row_iters = sum(st["row_iters"] for st in stats.values())
            mode = "row_close_pred" if pred else "row_close"
            check(launches[lbl].get(mode, 0) == row_iters
                  and not launches[lbl].get("row_close_argmin"),
                  f"{lbl}: {launches[lbl]} against {row_iters} row passes")
            fam = "minplus_argmin" if pred else "minplus"
            if sum(st["rank_k"] for st in stats.values()):
                check(launches[lbl].get(fam, 0) > 0, f"{lbl}: rank-k updates but no {fam}")
            times[lbl] = {k_: out[k_] for k_ in ("ms_per_submit_drain", "ms_per_query",
                                                  "seconds", "warm_s", "n_updates",
                                                  "n_queries")}
            times[lbl].update(batched_drains=len(drains), drain_batched=s_["pool"]["drain_batched"],
                              verify_ok=s_["pool"]["verify_ok"],
                              paths={k_: sum(st[k_] for st in stats.values())
                                     for k_ in ("rank_k", "row_resolve", "warm_resolve",
                                                "full_resolve", "noop")})
            print(f"phase 8b {lbl} on {card}: {json.dumps(times[lbl])}; launches "
                  f"{launches[lbl]}; batched drains {json.dumps(drains)}")
    finally:
        pool_mod.apply_updates_batched = real_batched

    # (c) The chaos drills at N = 2048: zero poisoned answers, every slot
    # back to healthy (serve's own exit code), faults that fired.
    for lbl, kw in (
        ("sync nan/crash/poison, deadline 50 ms",
         dict(fault_spec="nan:0.1,crash:0.08:3,poison:0.05", deadline_ms=50.0)),
        ("async durable, backend_loss/cache_storm/crash_restore",
         dict(fault_spec="backend_loss:0.3:6,cache_storm:0.2:8,crash_restore:0.25",
              async_updates=True, durability_dir=str(scratch / "durable"),
              checkpoint_every=4)),
    ):
        out = {}
        reset()
        rc_ = serve.serve_apsp_dynamic(SERVE_REQUESTS["8c"], n_max=2048, graphs=4,
                                       mutate_rate=0.5, mutate_k=8, verify_every=16, seed=0,
                                       summary_out=out, **kw)
        lbl = f"serve_apsp_dynamic N=2048 chaos {lbl}"
        launches[lbl] = read()
        s_ = out["summary"]
        fired = sum(s_["faults_injected"].values())
        check(rc_ == 0 and s_["pool"]["poisoned_served"] == 0 and fired > 0,
              f"{lbl}: rc {rc_}, poisoned {s_['pool']['poisoned_served']}, faults {fired}")
        check(s_.get("executor", {}).get("drain_errors", 0) == 0, f"{lbl}: executor errors")
        times[lbl] = {"ms_per_submit_drain": out["ms_per_submit_drain"],
                      "ms_per_query": out["ms_per_query"], "seconds": out["seconds"],
                      "faults": s_["faults_injected"], "recoveries": s_["recoveries"],
                      "crash_restores": s_["pool"]["crash_restores"],
                      "deadline_misses": s_["pool"]["deadline_misses"]}
        print(f"phase 8c {lbl} on {card}: {json.dumps(times[lbl])}")
    shutil.rmtree(scratch / "durable", ignore_errors=True)

    # (d) The batched drain: four N = 8192 engines, a decrease batch of k = 16
    # each, against twins updated one by one.
    n, g = 8192, 4
    hs = [generate_np(np.random.default_rng(80 + i), n).h for i in range(g)]
    # inserted or lowered edges of cost 1: decreases that move the state
    # (the generator's own weights seldom beat a solved distance here)
    batches = [generate_edge_updates(np.random.default_rng(90 + i), hs[i], 16)[:2]
               + (np.ones(16, np.float32),) for i in range(g)]
    base = {pred: [DynamicAPSP(h_, with_pred=pred) for h_ in hs] for pred in (False, True)}

    def fresh(pred):
        return [DynamicAPSP(e.h, with_pred=pred, state={
            "dist": e.dist.clone(), "pred": None if e.pred is None else e.pred.clone(),
            "version": e.version}) for e in base[pred]]

    # the kernels at the pass's shape, against their plain versions
    kb = dyn._bucket_k(16)
    d_st = torch.stack([e.dist for e in base[True]])
    u_ = torch.from_numpy(np.stack([np.resize(b_[0], kb) for b_ in batches])).long().cuda()
    v_ = torch.from_numpy(np.stack([np.resize(b_[1], kb) for b_ in batches])).long().cuda()
    w_ = torch.from_numpy(np.stack([np.resize(b_[2], kb) for b_ in batches])).cuda()
    x_ = torch.gather(d_st, 2, u_[:, None, :].expand(g, n, kb)) + w_[:, None, :]
    y_ = torch.gather(d_st, 1, v_[:, :, None].expand(g, kb, n))
    for kind, (cuda_fn, plain_fn) in (("minplus", (mp.minplus_cuda, mp.minplus_torch)),
                                      ("minplus_argmin", (mp.minplus_argmin_cuda,
                                                          mp.minplus_argmin_torch))):
        got, want = cuda_fn(x_, y_, d_st), plain_fn(x_, y_, d_st)
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        check(same(got[0], want[0]) and all(torch.equal(a_, b_) for a_, b_ in
                                            zip(got[1:], want[1:])),
              f"{kind} at the batched rank-k shape G={g} N={n} K={kb} differs from plain")
        errs[kind] = max(errs[kind], abs_err(got[0], want[0]))
        print(f"{kind} at the batched rank-k shape G={g} N={n} K={kb}: equal to the plain "
              f"version")
    del x_, y_, d_st

    for pred in (True, False):
        fam = "minplus_argmin" if pred else "minplus"
        engines, twins = fresh(pred), fresh(pred)
        reset()
        infos, deferred = apply_updates_batched(engines, batches)
        got = read()
        passes = infos[0]["passes"]
        check(deferred == [] and all(i_["batched"] == g and i_["passes"] == passes
                                     for i_ in infos),
              f"batched drain infos {infos}, deferred {deferred}")
        check(got == {fam: passes}, f"batched drain launched {got}, {passes} passes")
        own = []
        for e, t_, b_ in zip(engines, twins, batches):
            ti = t_.update(*b_)
            own.append(ti["passes"])
            check(torch.equal(e.dist, t_.dist) and e.version == t_.version
                  and (not pred or torch.equal(e.pred, t_.pred)),
                  "a batched engine differs from its twin updated with update")
            check({k_: v for k_, v in e.stats.items() if k_ != "rank_k_passes"}
                  == {k_: v for k_, v in t_.stats.items() if k_ != "rank_k_passes"}
                  and e.stats["rank_k_passes"] == passes >= t_.stats["rank_k_passes"],
                  f"batched stats {e.stats} against the twin's {t_.stats}")
        del engines, twins
        lbl = f"batched drain G={g} N={n} k=16 {'with_pred' if pred else 'plain'}"

        def batched_run():
            set_ = fresh(pred)
            torch.cuda.synchronize()
            ms_ = cuda_ms(lambda: apply_updates_batched(set_, batches))
            return ms_

        def sequential_run():
            set_ = fresh(pred)
            torch.cuda.synchronize()
            return cuda_ms(lambda: [e.update(*b_) for e, b_ in zip(set_, batches)])

        bat = statistics.median(batched_run() for _ in range(3))
        seq = statistics.median(sequential_run() for _ in range(3))
        d_st = torch.stack([e.dist for e in base[pred]])
        p_st = torch.stack([e.pred for e in base[pred]]) if pred else None
        pass_ms = median_ms(lambda: ops.rank_k_update(d_st, u_, v_, w_, pred=p_st), reps=10)
        one_ms = median_ms(lambda: ops.rank_k_update(d_st[0], u_[0], v_[0], w_[0],
                                                      pred=None if p_st is None else p_st[0]),
                           reps=10)
        del d_st, p_st
        # a pass reads the state and writes the new one (preds too)
        w = bounds().rank_k_pass_work(g, n, kb, pred)
        bound, ops_bound = w.bytes_ms(), w.ops_ms(lane_rate)
        times[lbl] = {"batched_ms": bat, "sequential_ms": seq, "passes": passes,
                      "twin_passes": own, "pass_ms": pass_ms, "one_graph_pass_ms": one_ms,
                      "pass_bound_ms": max(bound, ops_bound),
                      "pass_bound_by": "bytes" if bound >= ops_bound else "operations",
                      "drain_bound_ms": passes * max(bound, ops_bound)}
        extra.setdefault(fam, {})[f"batched rank-k pass G={g} N={n} K={kb}"] = {
            "ms": pass_ms, "bound_ms": max(bound, ops_bound),
            "bound_by": times[lbl]["pass_bound_by"], "one_graph_ms": one_ms}
        print(f"phase 8d {lbl} on {card}: equal to the twins; {json.dumps(times[lbl])}")

    # The commit's host work at N = 8192 (the snapshot and the health probe
    # the pool runs after every committed drain).
    e0 = base[True][0]
    rng_p = np.random.default_rng(0)
    for name_, fn_ in (("snapshot", e0.snapshot),
                       ("health_probe", lambda: e0.health_probe(64, rng_p))):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn_()
            ts.append((time.perf_counter() - t0) * 1e3)
        times[f"commit host {name_} ms N={n} with_pred"] = statistics.median(ts)
    print(f"phase 8d commit host time at N={n} with preds on {card}: snapshot "
          f"{times[f'commit host snapshot ms N={n} with_pred']:.1f} ms, health probe "
          f"{times[f'commit host health_probe ms N={n} with_pred']:.1f} ms")
    del base

    # (e) Engine checkpoints at N = 8192 with preds: save, go on updating
    # with a journal, load, restore, replay: bit-equal to the engine that
    # never stopped.
    for dtype in (torch.float32, torch.bfloat16):
        name_ = str(dtype).replace("torch.", "")
        ck_dir = scratch / f"ck-{name_}"
        eng = DynamicAPSP(hs[0], with_pred=True, dtype=dtype)
        eng.journal = UpdateJournal(str(scratch / f"ck-{name_}.wal"))
        t0 = time.perf_counter()
        path = save_engine_checkpoint(str(ck_dir), eng)
        save_ms = (time.perf_counter() - t0) * 1e3
        rng_u = np.random.default_rng(3)
        for wf in (0.0, 0.25, 0.0):
            eng.update(*generate_edge_updates(rng_u, eng.h, 8, worsen_frac=wf))
        t0 = time.perf_counter()
        st = load_engine_checkpoint(str(ck_dir))
        load_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        restored = DynamicAPSP(st["h"], with_pred=True, dtype=dtype, state=st)
        torch.cuda.synchronize()
        install_ms = (time.perf_counter() - t0) * 1e3
        replayed = eng.journal.replay_onto(restored, min_version=st["version"])
        check(replayed >= 3 and restored.version == eng.version
              and torch.equal(restored.dist, eng.dist) and torch.equal(restored.pred, eng.pred)
              and np.array_equal(restored.h, eng.h) and restored.dist.dtype == dtype,
              f"the {name_} checkpoint + journal replay differs from the engine that ran on")
        eng.journal.close()
        lbl = f"engine checkpoint N={n} with_pred {name_}"
        times[lbl] = {"save_ms": save_ms, "load_ms": load_ms, "install_ms": install_ms,
                      "bytes_on_disk": dir_bytes(path), "replayed": replayed}
        print(f"phase 8e {lbl} on {card}: restored + {replayed} journal records equal the "
              f"engine that ran on, bit for bit; {json.dumps(times[lbl])}")
        del eng, restored
        shutil.rmtree(ck_dir, ignore_errors=True)

    times["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 8 on {card}: {times['phase_s']:.1f} s; {json.dumps(times)}")
    return launches, errs, times, extra


# Phase 9's cells: spd_features on the smoke's N = 8192 graph (64
# landmarks) and on the Cora-shaped graph of 9b (8 landmarks, the example's
# cap), and the three published GNN configs on that graph.
SPD_CELLS = {"N=8192 L=64": (64, 1e4), "N=2708 L=8": (8, 50.0)}
GNN_ARCHS = ("gcn-cora", "gin-tu", "pna")
CORA = dict(n_nodes=2708, n_edges=10556, d_feat=1433)   # GNN_SHAPES' full_graph_sm
TRAIN_STEPS, CPU_STEPS, STEP_RTOL = 20, 3, 1e-4


def spd_plain(h: torch.Tensor, lm: torch.Tensor, cap: float):
    """spd_features' loop with every hop on the plain version
    (``minplus_torch``), on h's device: (features, hops)."""
    mp = kernel_module("minplus")
    d = h[lm].contiguous()
    hops = 0
    for _ in range(h.shape[0] - 1):
        z = mp.minplus_torch(d, h, d)
        hops += 1
        changed = bool((z < d).any())
        d = z
        if not changed:
            break
    return torch.minimum(d, torch.tensor(cap, device=h.device)).T, hops


def drive_training(card: str, scratch: Path, h8192: torch.Tensor, lane_rate: float):
    """Phase 9: the GNN training path on the card.  (a) ``spd_features`` on
    the smoke's N = 8192 graph with 64 landmarks and on the Cora-shaped
    graph of (b) with 8: bit-equal to the same loop on ``minplus_torch`` and
    to the capped rows of ``repro_torch.solve``, one ``minplus`` launch a
    hop; ms a call (CUDA events, median of 3) and a hop against its bound.
    (b) ``gcn-cora``, ``gin-tu`` and ``pna`` at their published widths on
    the Cora-shaped graph with the 8 standardised SPD features appended
    (d_feat = 1441): 20 steps on the card (loss finite, the median of the
    last five lower than step 1's, ``state.step`` 20), the first 3 against the port on
    the CPU from the same initial state (loss and grad norm within rtol
    1e-4), ms a step (CUDA events, median of steps 5-20), peak memory, one
    step traced.  (c) ``python -m repro_torch.launch.train --arch gcn-cora``
    6 steps, then 9 from its checkpoint.  Returns (launches by path, times,
    entries for the kernels line)."""
    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_graph
    from repro_torch.models.gnn import init_gnn, loss_gnn
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_path, tree_map

    mp = kernel_module("minplus")
    # Full float32 products: the card against the CPU needs them, and the
    # trainer sets the same.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    launches, times, extra = {}, {}, {"minplus": {}}

    # (a) spd_features.  The Cora-shaped graph's cost matrix: 1 on each edge
    # (src -> dst, the messages' direction), 0 on the diagonal, inf elsewhere.
    g0 = synthetic_graph(**CORA, n_classes=7, seed=0)
    cost = np.full((CORA["n_nodes"],) * 2, np.inf, np.float32)
    cost[g0["edge_index"][0], g0["edge_index"][1]] = 1.0
    np.fill_diagonal(cost, 0.0)
    graphs = {"N=8192 L=64": h8192, "N=2708 L=8": torch.from_numpy(cost).cuda()}
    spd = {}
    for lbl, (n_lm, cap) in SPD_CELLS.items():
        h = graphs[lbl]
        n = h.shape[0]
        lm = torch.from_numpy(np.linspace(0, n - 1, n_lm).astype(np.int64))
        mp.launches.update(dict.fromkeys(mp.launches, 0))
        f = repro_torch.spd_features(h, lm, cap=cap)
        torch.cuda.synchronize()
        got = {k: v for k, v in mp.launches.items() if v}
        hops = got.get("minplus", 0)
        check(got == {"minplus": hops} and hops >= 1,
              f"spd {lbl}: launches {got}, expected minplus only")
        launches[f"spd {lbl}"] = got
        plain, plain_hops = spd_plain(h, lm.cuda(), cap)
        check(plain_hops == hops and same(f, plain),
              f"spd {lbl}: {hops} hops differ from the plain loop's ({plain_hops} hops)")
        ref = repro_torch.solve(h).dist
        want = torch.minimum(ref[lm.cuda()], torch.tensor(cap, device=h.device)).T
        check(same(f, want), f"spd {lbl}: differs from the capped rows of the solve")
        ms = median_ms(lambda: repro_torch.spd_features(h, lm, cap=cap), reps=3)
        d0 = h[lm.cuda()].contiguous()
        hop_ms = median_ms(lambda: mp.minplus_cuda(d0, h, d0), reps=10)
        w = bounds().spd_hop_work(n_lm, n)
        ops_hop, bytes_hop = w.ops_ms(lane_rate), w.bytes_ms()
        bound_hop = max(ops_hop, bytes_hop)
        times[f"spd {lbl}"] = {
            "ms": ms, "hops": hops, "ms_per_hop": ms / hops, "minplus_launch_ms": hop_ms,
            "bound_ms_per_hop": bound_hop,
            "bound_by": "operations" if ops_hop >= bytes_hop else "bytes"}
        extra["minplus"][f"spd_features {lbl} ({n_lm}x{n} x {n}x{n} accumulate, a hop)"] = {
            "ms": hop_ms, "bound_ms": bound_hop}
        spd[lbl] = f
        print(f"phase 9a spd_features {lbl} cap={cap:g} on {card}: equal to the plain loop "
              f"and to the solve's capped rows; {hops} hops = {hops} minplus launches; "
              f"{ms:.3f} ms a call (median of 3), {ms / hops:.4f} ms a hop, one launch "
              f"{hop_ms:.4f} ms (median of 10), bound {bound_hop:.4f} ms a hop by "
              f"{times[f'spd {lbl}']['bound_by']}")

    # (b) The published configs on the Cora-shaped graph with the SPD
    # features standardised and appended, as examples/gnn_node_classification.py does.
    f = spd["N=2708 L=8"].cpu().numpy()
    f = (f - f.mean()) / (f.std() + 1e-6)
    for arch_id in GNN_ARCHS:
        arch = get_arch(arch_id)
        cfg = arch.make_config(d_feat=CORA["d_feat"] + f.shape[1])
        g = synthetic_graph(**CORA, n_classes=cfg.n_classes, seed=0)
        g["node_feat"] = np.concatenate([g["node_feat"], f], axis=1)
        opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 20, 10_000))
        step_fn = make_train_step(lambda p, b, cfg=cfg: loss_gnn(p, b, cfg), opt)
        params = init_gnn(torch.Generator().manual_seed(0), cfg, device="cpu")
        # The training's own peak: what the earlier phases left allocated
        # is taken off, so the peak counts this config's parameters,
        # optimizer state, graph and the steps' activations.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        copy = lambda p, dev: p.detach().to(dev, copy=True).requires_grad_()
        states = {dev: init_train_state(tree_map(lambda p: copy(p, dev), params), opt)
                  for dev in ("cpu", "cuda")}
        batches = {dev: {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
                   for dev in ("cpu", "cuda")}
        metrics, events = [], []
        for _ in range(TRAIN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            states["cuda"], m = step_fn(states["cuda"], batches["cuda"])
            end.record()
            metrics.append(m)
            events.append((start, end))
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in events]
        peak = torch.cuda.max_memory_allocated() - base
        losses = [float(m["loss"]) for m in metrics]
        # The median of the last five steps, not step 20 alone: gin-tu's
        # trajectory at its published lr swings by 10x from step to step
        # (two CPU runs of these 20 steps ended at 0.955 and 0.798 from 2.88).
        late = statistics.median(losses[-5:])
        check(all(math.isfinite(x) for x in losses) and late < losses[0],
              f"{arch_id}: losses {losses} not finite or not lower at the end")
        check(int(states["cuda"].step) == TRAIN_STEPS, f"{arch_id}: step {states['cuda'].step}")
        cpu = []
        for _ in range(CPU_STEPS):
            states["cpu"], m = step_fn(states["cpu"], batches["cpu"])
            cpu.append(m)
        worst = 0.0
        for i in range(CPU_STEPS):
            for k in ("loss", "grad_norm"):
                a, b = float(metrics[i][k]), float(cpu[i][k])
                worst = max(worst, abs(a - b) / abs(b))
                check(abs(a - b) <= STEP_RTOL * abs(b),
                      f"{arch_id} step {i + 1} {k}: card {a} against CPU {b}")
        _, busy, window, _ = device_breakdown(f"one {arch_id} train step, N=2708",
                                           lambda: step_fn(states["cuda"], batches["cuda"]))
        n_params = sum(v.numel() for _, v in flatten_with_path(params))
        times[arch_id] = {
            "ms_per_step": statistics.median(step_ms[4:]), "first_step_ms": step_ms[0],
            "loss_first": losses[0], "loss_last": losses[-1], "loss_median_last5": late,
            "max_rel_err_first_steps": worst, "peak_mib": peak / 2 ** 20,
            "device_busy_share": busy / window, "params": n_params}
        print(f"phase 9b {arch_id} (d_feat {cfg.d_feat}, {n_params} params) on {card}: "
              f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; the first "
              f"{CPU_STEPS} equal the CPU's within rtol {STEP_RTOL} (worst {worst:.2e}); "
              f"{times[arch_id]['ms_per_step']:.3f} ms a step (median of steps 5-{TRAIN_STEPS}), "
              f"first step {step_ms[0]:.1f} ms, peak {peak / 2 ** 20:.1f} MiB, device busy "
              f"{100 * busy / window:.1f}% of a traced step")

    # (c) python -m repro_torch.launch.train on the card, then resumed from its checkpoint.
    ck = scratch / "train_ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for steps in (6, 9):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gcn-cora",
             "--steps", str(steps), "--ckpt-dir", str(ck), "--ckpt-every", "3",
             "--log-every", "3"],
            capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
        check(r.returncode == 0, f"launch.train --steps {steps}: rc {r.returncode}\n"
              f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        check(f"[done] {steps} steps" in r.stdout, f"launch.train --steps {steps}: {r.stdout}")
        check((steps == 9) == ("[resume] restored step 6" in r.stdout),
              f"launch.train --steps {steps}: resume line wrong:\n{r.stdout}")
        times[f"launch.train steps={steps} s"] = time.perf_counter() - t0
        print(f"phase 9c python -m repro_torch.launch.train --arch gcn-cora --steps {steps} "
              f"on {card}: rc 0 in {times[f'launch.train steps={steps} s']:.1f} s; "
              + " | ".join(r.stdout.strip().splitlines()))
    shutil.rmtree(ck, ignore_errors=True)

    times["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 9 on {card}: {times['phase_s']:.1f} s; {json.dumps(times)}")
    return launches, times, extra


# Phase 10's cells: NequIP's published config on the reference's molecule
# cell (GNN_SHAPES' "molecule": 128 molecules of 30 atoms and 64 edges a
# batch), and the distributed solvers on the smoke's N = 8192 graph at the
# reference's pivot tile (B = 512) and R-Kleene leaf (4096).
MOLECULE = dict(batch=128, n_atoms=30, n_edges=64)
DIST_MESHES = {"2x2": ((2, 2), ("data", "model"), False),
               "2x1x2": ((2, 1, 2), ("pod", "data", "model"), True),
               "1x1": ((1, 1), ("data", "model"), False)}
DIST_GLOO_JOBS = (("2x2", "squaring"), ("2x2", "fw"), ("2x2", "rkleene"), ("2x1x2", "fw"))
DIST_NCCL_JOBS = (("1x1", "fw"),)
DIST_B, DIST_LEAF = 512, 4096


def distributed_plan(method: str, n: int, nr: int, nc: int):
    """``minplus`` and ``fw_block`` launches of one rank in one distributed
    solve of n nodes on an nr x nc grid (every rank launches the same):
    squaring ceil(log2 N) SUMMA products of lcm(nr, nc) panels; blocked FW
    per pivot one closure, the update, and a panel product for each panel
    the rank owns (N / nr / B row pivots and N / nc / B column pivots);
    R-Kleene six SUMMA products and two halves a level above its leaf."""
    panels = math.lcm(nr, nc)
    if method == "squaring":
        n_ = -(-n // panels) * panels
        return {"minplus": max(1, math.ceil(math.log2(n_))) * panels}
    mult = DIST_B * panels
    n_ = -(-n // mult) * mult

    def blocked(m):
        if method == "rkleene" and m > DIST_LEAF:
            sub = blocked(m // 2)
            return {"minplus": 6 * panels + 2 * sub["minplus"], "fw_block": 2 * sub["fw_block"]}
        b = min(DIST_B, m // nr, m // nc)
        return {"minplus": m // b + m // nr // b + m // nc // b, "fw_block": m // b}

    return blocked(n_)


def distributed_rank(h_path: str, want_path: str, jobs, *, device: str):
    """Phase 10b on one rank: each (mesh, method) of ``jobs`` solved by
    ``apsp_distributed`` on the graph at ``h_path``, held bit for bit
    against the single-card solve at ``want_path``, its launches read from
    the counters; then solved again, timed (host clock between barriers)."""
    import torch.distributed as dist

    from repro_torch.core.distributed import apsp_distributed
    from repro_torch.launch.mesh import make_mesh

    h = torch.from_numpy(np.load(h_path))
    want = torch.from_numpy(np.load(want_path)).to(device)
    meshes, out = {}, {}
    for label, method in jobs:
        shape, axes, multi_pod = DIST_MESHES[label]
        if label not in meshes:
            meshes[label] = make_mesh(shape, axes, device=device)

        def solve():
            return apsp_distributed(h, mesh=meshes[label], method=method,
                                    multi_pod=multi_pod, block_size=DIST_B)

        before = launch_counts()
        got = solve()
        torch.cuda.synchronize()
        after = launch_counts()
        equal = same(got, want)
        err = 0.0 if equal else abs_err(got, want)
        del got
        dist.barrier()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        dist.barrier()
        out[f"{label} {method}"] = {
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            "equal": equal, "max_abs_err": err, "ms": 1e3 * (time.perf_counter() - t0),
            "device": str(torch.device(device)), "backend": dist.get_backend()}
    return out


def molecule_graph(b: dict) -> dict:
    """A batch of molecules (B, n, ...) as one disjoint graph, for
    ``nequip_energy_forces``."""
    bsz, n = b["positions"].shape[:2]
    off = torch.arange(bsz, device=b["positions"].device)[:, None, None] * n
    return {"positions": b["positions"].reshape(-1, 3), "species": b["species"].reshape(-1),
            "edge_index": (b["edge_index"].long() + off).permute(1, 0, 2).reshape(2, -1),
            "edge_mask": b["edge_mask"].reshape(-1), "node_mask": b["node_mask"].reshape(-1)}


def drive_nequip(card: str, scratch: Path):
    """Phase 10a: NequIP at its published config on the molecule cell.  20
    train steps on the card (energy-only MSE, the trainer's loss; loss
    finite, ``state.step`` 20), the first 3 against the port on the CPU
    from the same initial state (loss and grad norm within rtol 1e-4); the
    energy and forces of one batch against the CPU (rtol 1e-4 of the
    largest magnitude); rotation and translation invariance of each
    molecule's energy on the card (1e-3, as the reference's test); ms a
    step (CUDA events, median of steps 5-20), own peak memory, one step
    traced; no launch of a kernel of this repo (the reference's message
    passing is XLA, the port's PyTorch); then ``python -m
    repro_torch.launch.train --arch nequip`` 6 steps and 9 from its
    checkpoint.  Returns the times."""
    from repro_torch.configs import get_arch
    from repro_torch.data import molecule_batch_stream
    from repro_torch.launch.train import nequip_loss
    from repro_torch.models.nequip import init_nequip, nequip_energy_batch, nequip_energy_forces
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    arch = get_arch("nequip")
    cfg = arch.make_config()
    stream = molecule_batch_stream(**MOLECULE, n_species=cfg.n_species, seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in next(stream).items() if k != "step"}
               for _ in range(TRAIN_STEPS)]
    on = {dev: [{k: v.to(dev) for k, v in b.items()} for b in batches] for dev in ("cpu", "cuda")}
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 20, 10_000))
    step_fn = make_train_step(lambda p, b: nequip_loss(p, b, cfg), opt)
    params = init_nequip(torch.Generator().manual_seed(0), cfg, device="cpu")
    n_params = sum(v.numel() for _, v in flatten_with_path(params))
    copy = lambda p, dev: p.detach().to(dev, copy=True).requires_grad_()
    times = {"params": n_params}

    # Energy and forces of the first batch, card against CPU, and the
    # energies' invariance under a rotation and a translation on the card.
    cuda_params = tree_map(lambda p: copy(p, "cuda"), params)
    e_c, f_c = nequip_energy_forces(cuda_params, molecule_graph(on["cuda"][0]), cfg)
    e_h, f_h = nequip_energy_forces(params, molecule_graph(on["cpu"][0]), cfg)
    e_err = abs(float(e_c) - float(e_h)) / max(abs(float(e_h)), 1e-6)
    f_err = float((f_c.cpu() - f_h).abs().max()) / float(f_h.abs().max())
    check(e_err <= STEP_RTOL and f_err <= STEP_RTOL,
          f"nequip energy / forces on the card against the CPU: relative errors {e_err}, {f_err}")
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    b0 = on["cuda"][0]
    moved = dict(b0, positions=b0["positions"] @ torch.from_numpy(q.T.astype(np.float32)).cuda()
                 + torch.from_numpy((rng.normal(size=(1, 1, 3)) * 5).astype(np.float32)).cuda())
    with torch.no_grad():
        e0 = nequip_energy_batch(cuda_params, b0, cfg)
        e1 = nequip_energy_batch(cuda_params, moved, cfg)
    rot_err = float((e1 - e0).abs().max())
    check(rot_err <= 1e-3 * max(1.0, float(e0.abs().max())),
          f"nequip energies change by {rot_err} under a rotation and translation on the card")
    del cuda_params

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    states = {dev: init_train_state(tree_map(lambda p: copy(p, dev), params), opt)
              for dev in ("cpu", "cuda")}
    before = launch_counts()
    metrics, events = [], []
    for i in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        states["cuda"], m = step_fn(states["cuda"], on["cuda"][i])
        end.record()
        metrics.append(m)
        events.append((start, end))
    torch.cuda.synchronize()
    after = launch_counts()
    check(after == before, f"nequip steps launched kernels of this repo: {before} -> {after}")
    step_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated() - base
    losses = [float(m["loss"]) for m in metrics]
    check(all(math.isfinite(x) for x in losses) and int(states["cuda"].step) == TRAIN_STEPS,
          f"nequip: losses {losses}, step {int(states['cuda'].step)}")
    worst = 0.0
    for i in range(CPU_STEPS):
        states["cpu"], m = step_fn(states["cpu"], on["cpu"][i])
        for k in ("loss", "grad_norm"):
            a, b = float(metrics[i][k]), float(m[k])
            worst = max(worst, abs(a - b) / abs(b))
            check(abs(a - b) <= STEP_RTOL * abs(b),
                  f"nequip step {i + 1} {k}: card {a} against CPU {b}")
    _, busy, window, _ = device_breakdown(
        "one nequip train step, molecule cell",
        lambda: step_fn(states["cuda"], on["cuda"][TRAIN_STEPS - 1]))
    times.update({
        "ms_per_step": statistics.median(step_ms[4:]), "first_step_ms": step_ms[0],
        "loss_first": losses[0], "loss_last": losses[-1], "max_rel_err_first_steps": worst,
        "energy_rel_err": e_err, "forces_rel_err": f_err, "rotation_abs_err": rot_err,
        "peak_mib": peak / 2 ** 20, "device_busy_share": busy / window})
    print(f"phase 10a nequip (published: {cfg.n_layers} layers, d_hidden {cfg.d_hidden}, "
          f"{n_params} params) on the molecule cell (128 x 30 atoms, 64 edges each) on {card}: "
          f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; the first "
          f"{CPU_STEPS} equal the CPU's within rtol {STEP_RTOL} (worst {worst:.2e}); energy and "
          f"forces of one batch within {max(e_err, f_err):.2e} of the CPU; rotated energies "
          f"within {rot_err:.2e}; {times['ms_per_step']:.3f} ms a step (median of steps "
          f"5-{TRAIN_STEPS}), first step {step_ms[0]:.1f} ms, peak {peak / 2 ** 20:.1f} MiB, "
          f"device busy {100 * busy / window:.1f}% of a traced step; no kernel of this repo")
    del states, on

    ck = scratch / "nequip_ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for steps in (6, 9):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "nequip",
             "--steps", str(steps), "--ckpt-dir", str(ck), "--ckpt-every", "3",
             "--log-every", "3"],
            capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
        check(r.returncode == 0 and f"[done] {steps} steps" in r.stdout,
              f"launch.train --arch nequip --steps {steps}: rc {r.returncode}\n"
              f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        check((steps == 9) == ("[resume] restored step 6" in r.stdout),
              f"launch.train --arch nequip --steps {steps}: resume line wrong:\n{r.stdout}")
        times[f"launch.train steps={steps} s"] = time.perf_counter() - t0
        print(f"phase 10a python -m repro_torch.launch.train --arch nequip --steps {steps} on "
              f"{card}: rc 0 in {times[f'launch.train steps={steps} s']:.1f} s; "
              + " | ".join(r.stdout.strip().splitlines()))
    shutil.rmtree(ck, ignore_errors=True)
    times["phase_s"] = time.perf_counter() - t_phase
    return times


def drive_distributed(card: str, scratch: Path, h_np: np.ndarray, want: torch.Tensor,
                      lane_rate: float, hold):
    """Phase 10b: ``apsp_distributed`` on the smoke's N = 8192 graph, B = 512,
    R-Kleene leaf 4096: squaring, fw and rkleene on a (2, 2) mesh and fw on
    the (2, 1, 2) multi-pod mesh, four gloo ranks on this one card (gloo
    stages each broadcast through the host), and fw on a 1x1 mesh under
    NCCL at world size 1; each result bit-equal to the single-card solve
    ``want``, each rank's ``minplus`` and ``fw_block`` launches equal to
    ``distributed_plan``.  First ``minplus`` and ``fw_block`` are held
    against their plain versions at the slice's shapes (``hold``: a SUMMA
    panel product, the FW panels and update, the B = 512 pivot closure).
    Returns (launches by path, times, entries for the kernels line)."""
    from repro_torch.launch.apsp_run import run_ranks

    t_phase = time.perf_counter()
    mp, fb = kernel_module("minplus"), kernel_module("fw_block")
    n, b = h_np.shape[0], DIST_B
    rng = np.random.default_rng(10)
    half, panel = n // 2, n // 4
    x = operand(rng, (half, panel), "tropical")
    y = operand(rng, (panel, half), "tropical")
    a = operand(rng, (half, half), "tropical", density=0.2)
    piv = torch.from_numpy(in_domain(rng, b, "tropical")).cuda()
    rk = bounds()
    shapes = {   # label: (kernel, args, work)
        f"SUMMA panel {half}x{panel} x {panel}x{half} accumulate (squaring, 2x2)":
            ("minplus", (x, y, a), rk.minplus_work(1, half, panel, half, accumulate=True)),
        f"fw_distributed update {half}x{b} x {b}x{half} accumulate (2x2)":
            ("minplus", (x[:, :b], y[:b], a), rk.minplus_work(1, half, b, half, accumulate=True)),
        f"fw_distributed row panel {b}x{b} x {b}x{half}":
            ("minplus", (piv, y[:b]), rk.minplus_work(1, b, b, half)),
        f"fw_distributed column panel {half}x{b} x {b}x{b}":
            ("minplus", (x[:, :b], piv), rk.minplus_work(1, half, b, b)),
        f"fw_distributed pivot closure T=1 B={b}":
            ("fw_block", (piv[None],), rk.fw_block_work(1, b)),
    }
    extra = {"minplus": {}, "fw_block": {}}
    for label, (kind, args, w) in shapes.items():
        hold(kind, f"{label} (phase 10b's shape)", *args)
        cuda_fn = mp.minplus_cuda if kind == "minplus" else fb.fw_block_cuda
        ms = median_ms(lambda: cuda_fn(*args), reps=10)
        bound = max(w.ops_ms(lane_rate), w.bytes_ms())
        extra[kind][f"10b {label}"] = {"ms": ms, "bound_ms": bound}
    del x, y, a, piv

    h_path, want_path = scratch / "dist_h.npy", scratch / "dist_want.npy"
    np.save(h_path, h_np)
    np.save(want_path, want.cpu().numpy())
    runs = {}
    for backend, world, jobs in (("gloo", 4, DIST_GLOO_JOBS), ("nccl", 1, DIST_NCCL_JOBS)):
        t0 = time.perf_counter()
        per_rank = run_ranks(distributed_rank, world, (str(h_path), str(want_path), jobs),
                             device="cuda", backend=backend, timeout=300)
        print(f"phase 10b: {world} {backend} rank(s) on {card} ran {[' '.join(j) for j in jobs]} "
              f"in {time.perf_counter() - t0:.1f} s (process start included)")
        for label, method in jobs:
            shape = DIST_MESHES[label][0]
            nr, nc = math.prod(shape[:-1]), shape[-1]
            plan = distributed_plan(method, n, nr, nc)
            key = f"{label} {method}"
            for rank, out in enumerate(per_rank):
                got = out[key]
                check(got["equal"], f"10b {key} on rank {rank} ({backend}): differs from the "
                      f"single-card solve by {got['max_abs_err']}")
                check(got["launches"] == plan, f"10b {key} on rank {rank} ({backend}): "
                      f"launches {got['launches']}, plan {plan}")
            ms = [out[key]["ms"] for out in per_rank]
            runs[f"{key} {backend}"] = {"ms": max(ms), "ms_by_rank": ms,
                                        "launches_per_rank": plan}
            how = ("gloo-staged collectives on one card, not a multi-GPU figure"
                   if backend == "gloo" else "one rank: each broadcast an NCCL call to itself")
            print(f"phase 10b {key} ({backend}, {world} rank(s) on one card) N={n} B={b}: every "
                  f"rank's result bit-equal to the single-card solve; launches per rank "
                  f"{json.dumps(plan)} = the plan (counters); {max(ms):.1f} ms a solve, shard "
                  f"to gather (host clock between barriers; {how})")
    os.remove(h_path)
    os.remove(want_path)
    launches = {f"10b {k} (per rank)": v["launches_per_rank"] for k, v in runs.items()}
    runs["phase_s"] = time.perf_counter() - t_phase
    return launches, runs, extra


# Phase 11's cells: the LM and MIND substrate at published widths, each
# cut as printed.  qwen2-1.5b serves 32 prompts of 1024 tokens and 128
# greedy steps (decode_32k's 128 x 32768, cut for time and memory) and
# trains on train_4k's 4096-token sequence at a batch of 4 (cut from 256);
# deepseek-v2-236b keeps its published widths with its depth cut 60 -> 2
# (the dense first layer and one MoE layer); MIND runs its published
# config, its train cell at a batch of 16384 (cut from 65536: at 65536 the
# negatives' gather alone is 21 GB, and its gradient as much again).
QWEN_SERVE = dict(batch=32, prompt=1024, gen=128)
QWEN_TRAIN = dict(batch=4, seq=4096, microbatches=4, warmup=2, timed=5)
DSV2_SERVE = dict(layers=2, batch=8, prompt=512, gen=32)
MIND_CELLS = dict(serve_p99=512, serve_bulk=262144, train_batch=16384, cpu_train_batch=512)
COMPRESS_CFG = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=61,
                    attn_chunk=8)
SUBSTRATE_SEED = 0


def tokens_on(cfg, batch: int, seq: int, dev, seed: int = SUBSTRATE_SEED) -> dict:
    """One ``lm_batch_stream`` batch (Zipf tokens, labels the next token)."""
    from repro_torch.data import lm_batch_stream

    b = next(lm_batch_stream(batch=batch, seq_len=seq, vocab=cfg.vocab, seed=seed))
    return {k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels")}


def decode_against_forward(params, cfg, toks: torch.Tensor, steps: int):
    """Prefill ``toks``, then ``steps`` greedy decode steps; -> (each step's
    max |decode logits - forward logits at that position| over the largest
    forward logit there, top-1 agreement, all finite).  ``forward`` runs
    teacher-forced on the prompt and the decoded tokens."""
    from repro_torch.models.transformer import decode_step, forward, prefill

    b, s = toks.shape
    with torch.no_grad():
        last, cache = prefill(params, toks, cfg, s + steps)
        seq, dec = [toks], []
        nxt = torch.argmax(last, -1)[:, None]
        for _ in range(steps):
            seq.append(nxt)
            lg, cache = decode_step(params, cache, nxt, cfg)
            dec.append(lg)
            nxt = torch.argmax(lg, -1)[:, None]
        fwd, _ = forward(params, torch.cat(seq, 1), cfg)
    ref = fwd[:, s:s + steps].float()
    got = torch.stack(dec, 1).float()
    gaps = [float((got[:, i] - ref[:, i]).abs().max() / ref[:, i].abs().max())
            for i in range(steps)]
    top1 = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    return gaps, top1, bool(torch.isfinite(got).all() and torch.isfinite(ref).all())


def cast_share(per_kernel) -> float:
    """Device ms of the copy kernels (dtype casts and copies) in a trace."""
    return sum(ms for name, (ms, _) in per_kernel.items() if "copy" in name.lower())


def to_cpu_tree(params):
    from repro_torch.tree import tree_map

    return tree_map(lambda p: p.detach().cpu().clone().requires_grad_(), params)


def drive_qwen(card: str):
    """11a and 11b: qwen2-1.5b at its published config (28 layers, d_model
    1536, 12 / 2 heads, d_ff 8960, vocab 151936, QKV bias, tied
    embeddings, f32 params, bf16 compute), random weights from
    ``SUBSTRATE_SEED`` drawn on the card."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import decode_step, init_lm, loss_fn, prefill
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import flatten_with_path

    arch = get_arch("qwen2-1.5b")
    cfg = arch.make_config()
    out = {"parts_s": {}}
    t_part = [time.perf_counter()]

    def part(label):
        now = time.perf_counter()
        out["parts_s"][label] = now - t_part[0]
        t_part[0] = now

    gen = torch.Generator(device="cuda").manual_seed(SUBSTRATE_SEED)
    params, _ = init_lm(gen, cfg)
    n_params = sum(v.numel() for _, v in flatten_with_path(params))
    out["params"] = n_params

    # 11a (i) decode against forward in f32, the same weights: 4 prompts, 8 steps.
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    toks4 = tokens_on(cfg, 4, 64, "cuda")["tokens"]
    gaps, top1, finite = decode_against_forward(params, f32, toks4, 8)
    check(finite and max(gaps) <= 1e-3, f"11a qwen f32 decode against forward: gaps {gaps}")
    # (ii) bf16: finite, the gap and top-1 agreement printed as figures only.
    gaps16, top16, finite16 = decode_against_forward(params, cfg, toks4, 8)
    check(finite16, "11a qwen bf16 decode or forward logits are not finite")
    out.update({"f32_decode_gap": max(gaps), "bf16_decode_gap": max(gaps16),
                "bf16_top1_agreement": top16})
    print(f"phase 11a qwen2-1.5b ({n_params} params) on {card}: decode against forward "
          f"in f32, 4 prompts x 64 + 8 steps: worst gap {max(gaps):.2e} of max|logits| "
          f"(limit 1e-3); bf16: gap {max(gaps16):.2e}, top-1 agreement {top16:.3f} (figures only)")
    part("init and decode checks")

    # 11a serving: 32 prompts of 1024 tokens, prefill then 128 greedy steps.
    sv = QWEN_SERVE
    toks = tokens_on(cfg, sv["batch"], sv["prompt"], "cuda")["tokens"]
    max_len = sv["prompt"] + sv["gen"]
    with torch.no_grad():
        prefill(params, toks[:2], cfg, max_len)                 # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_pre = cuda_ms(lambda: out.__setitem__("_pf", prefill(params, toks, cfg, max_len)))
        last, cache = out.pop("_pf")
        nxt = torch.argmax(last, -1)[:, None]
        events = []
        t0 = time.perf_counter()
        for _ in range(sv["gen"]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lg, cache = decode_step(params, cache, nxt, cfg)
            nxt = torch.argmax(lg, -1)[:, None]
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(lg).all()), "11a qwen serving logits are not finite")
        check(int(cache.length[0]) == max_len, f"11a cache length {cache.length.tolist()}")
        peak = torch.cuda.max_memory_allocated() - base
        step_ms = statistics.median(a.elapsed_time(b) for a, b in events)
        part("serving")
        per_kernel, busy, window, _ = device_breakdown(
            "one qwen2-1.5b decode step (batch 32, cache 1152)",
            lambda: decode_step(params, cache, nxt, cfg))
    casts = cast_share(per_kernel)
    out.update({"prefill_ms": t_pre, "decode_ms": step_ms, "decode_wall_s": wall,
                "decode_tokens_per_s": sv["batch"] * 1e3 / step_ms,
                "tokens_per_s": sv["batch"] * sv["gen"] / (wall + t_pre / 1e3),
                "decode_busy_share": busy / window, "decode_copy_ms": casts,
                "decode_copy_share_of_busy": casts / busy, "serve_peak_gib": peak / 2 ** 30})
    print(f"phase 11a qwen2-1.5b serving on {card} (cut from decode_32k's 128 x 32768 to "
          f"{sv['batch']} prompts x {sv['prompt']} + {sv['gen']} greedy steps): prefill "
          f"{t_pre:.1f} ms, {step_ms:.3f} ms a decode step (median of {sv['gen']}), "
          f"{out['decode_tokens_per_s']:.0f} tokens/s decoding, {out['tokens_per_s']:.0f} "
          f"tokens/s with the prefill; a traced step busy {100 * busy / window:.1f}%, its "
          f"copy / cast kernels {casts:.3f} ms of {busy:.3f} ms busy; peak "
          f"{peak / 2 ** 30:.2f} GiB over the weights")
    del cache, lg, last
    part("traced decode step")

    # (iii) card against CPU: 2 layers at full width, f32, 4 prompts of 64 tokens.
    two = dataclasses.replace(cfg, n_layers=2, compute_dtype=torch.float32)
    p2, _ = init_lm(torch.Generator(device="cuda").manual_seed(SUBSTRATE_SEED + 1), two)
    p2_cpu = to_cpu_tree(p2)
    t4 = tokens_on(cfg, 4, 64, "cuda", seed=1)["tokens"]
    worst = 0.0
    with torch.no_grad():
        lc, cc = prefill(p2, t4, two, 68)
        lh, ch = prefill(p2_cpu, t4.cpu(), two, 68)
        for i in range(5):
            if i:
                nxt = torch.argmax(lc, -1)[:, None]
                lc, cc = decode_step(p2, cc, nxt, two)
                lh, ch = decode_step(p2_cpu, ch, nxt.cpu(), two)
            gap = float((lc.cpu() - lh).abs().max() / lh.abs().max())
            worst = max(worst, gap)
            check(gap <= 1e-4, f"11a qwen 2 layers card against CPU, "
                  f"{'prefill' if i == 0 else f'decode step {i}'}: gap {gap:.2e}")
    out["card_vs_cpu_gap"] = worst
    part("serving card against CPU")
    print(f"phase 11a qwen2-1.5b cut to 2 layers, f32, card against CPU: prefill and 4 "
          f"decode steps within {worst:.2e} of max|logits| (limit 1e-4)")
    del p2, p2_cpu

    # 11b training at published width: AdamW on the ArchDef's schedule,
    # microbatches 4, remat "full", 4 x 4096 tokens a step.
    tr = QWEN_TRAIN
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 20, 10_000))
    step_fn = make_train_step(lambda p, b: loss_fn(p, b, cfg), opt,
                              microbatches=tr["microbatches"])
    batch = tokens_on(cfg, tr["batch"], tr["seq"], "cuda", seed=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(params, opt)
    events, losses = [], []
    for i in range(tr["warmup"] + tr["timed"]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        events.append((start, end))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"11b qwen losses {losses}")
    ms = [a.elapsed_time(b) for a, b in events][tr["warmup"]:]
    peak = torch.cuda.max_memory_allocated() - base
    part("training steps")
    # The trace is of a step at one microbatch (1 x 4096, the timed step's
    # microbatch): the profiler takes 70 s to process the whole step's
    # 82 000 launches, a quarter of them as long.
    one_mb = make_train_step(lambda p, b: loss_fn(p, b, cfg), opt)
    _, busy, window, _ = device_breakdown(
        "one qwen2-1.5b train step at one microbatch (1 x 4096)",
        lambda: one_mb(state, {k: v[:1] for k, v in batch.items()}))
    part("traced train step")
    tokens = tr["batch"] * tr["seq"]
    out.update({"train_ms": statistics.median(ms), "train_tokens_per_s":
                tokens * 1e3 / statistics.median(ms), "train_busy_share": busy / window,
                "train_peak_gib": peak / 2 ** 30, "train_losses": losses})
    print(f"phase 11b qwen2-1.5b training on {card} (train_4k's sequence, batch cut from 256 "
          f"to {tr['batch']}; AdamW, microbatches {tr['microbatches']}, remat full): "
          f"{out['train_ms']:.1f} ms a step (median of {tr['timed']} after {tr['warmup']} "
          f"warm-up), {out['train_tokens_per_s']:.0f} tokens/s, busy {100 * busy / window:.1f}% "
          f"of a traced one-microbatch step, peak {peak / 2 ** 30:.2f} GiB over the weights; "
          f"losses {[round(x, 4) for x in losses]}")
    del state, params, batch

    # 11b check: 2 layers at full width, f32, a batch of 2 x 64, 3 steps, card against CPU.
    p2, _ = init_lm(torch.Generator(device="cuda").manual_seed(SUBSTRATE_SEED + 2), two)
    p2_cpu = to_cpu_tree(p2)
    step2 = make_train_step(lambda p, b: loss_fn(p, b, two), opt)
    states = {"card": init_train_state(p2, opt), "host": init_train_state(p2_cpu, opt)}
    worst = 0.0
    for i in range(3):
        b = tokens_on(cfg, 2, 64, "cpu", seed=10 + i)
        states["card"], mc = step2(states["card"], {k: v.cuda() for k, v in b.items()})
        states["host"], mh = step2(states["host"], b)
        for k in ("loss", "grad_norm"):
            a, h = float(mc[k]), float(mh[k])
            worst = max(worst, abs(a - h) / abs(h))
            check(abs(a - h) <= 1e-4 * abs(h), f"11b qwen 2 layers step {i + 1} {k}: card {a} "
                  f"against CPU {h}")
    out["train_card_vs_cpu_rel"] = worst
    part("training card against CPU")
    print(f"phase 11b qwen2-1.5b cut to 2 layers, f32, 3 AdamW steps on 2 x 64: loss and "
          f"grad norm within {worst:.2e} of the CPU (limit rtol 1e-4)")
    return out


def drive_deepseek(card: str):
    """11c: deepseek-v2-236b at its published widths, depth cut 60 -> 2 (the
    dense first layer and one MoE layer): MLA with the absorbed decode
    against the compressed cache, 160 routed experts top-6 plus 2 shared,
    bf16 params, random weights drawn on the card."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    from repro_torch.tree import flatten_with_path

    sv = DSV2_SERVE
    cfg = get_arch("deepseek-v2-236b").make_config(n_layers=sv["layers"])
    out = {}
    params, _ = init_lm(torch.Generator(device="cuda").manual_seed(SUBSTRATE_SEED), cfg)
    n_params = sum(v.numel() for _, v in flatten_with_path(params))
    toks = tokens_on(cfg, sv["batch"], sv["prompt"], "cuda")["tokens"]
    max_len = sv["prompt"] + sv["gen"]
    with torch.no_grad():
        prefill(params, toks[:1, :64], cfg, 128)                # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with moe.record_routing() as log:
            t_pre = cuda_ms(lambda: out.__setitem__("_pf", prefill(params, toks, cfg, max_len)))
        kept = sum(int(a) for a, _ in log)
        routed = sum(int(b) for _, b in log)
        last, cache = out.pop("_pf")
        check(tuple(cache.ckv.shape) == (2, sv["batch"], max_len, 512)
              and tuple(cache.kpe.shape) == (2, sv["batch"], max_len, 64),
              f"11c cache shapes {tuple(cache.ckv.shape)}, {tuple(cache.kpe.shape)}")
        nxt = torch.argmax(last, -1)[:, None]
        events = []
        for _ in range(sv["gen"]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lg, cache = decode_step(params, cache, nxt, cfg)
            nxt = torch.argmax(lg, -1)[:, None]
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(lg).all()), "11c deepseek logits are not finite")
        peak = torch.cuda.max_memory_allocated() - base
    step_ms = statistics.median(a.elapsed_time(b) for a, b in events)
    out.update({"params": n_params, "prefill_ms": t_pre, "decode_ms": step_ms,
                "peak_gib": peak / 2 ** 30, "prefill_dropped_share": 1 - kept / routed,
                "cache_values_per_token_layer": cache.ckv.shape[-1] + cache.kpe.shape[-1]})
    print(f"phase 11c deepseek-v2-236b (published widths, depth cut 60 -> 2: the dense first "
          f"layer and one MoE layer; {n_params} params) on {card}: {sv['batch']} prompts x "
          f"{sv['prompt']}: prefill {t_pre:.1f} ms, {100 * (1 - kept / routed):.2f}% of "
          f"(token, expert) slots dropped; {step_ms:.3f} ms an absorbed decode step (median of "
          f"{sv['gen']}); peak {peak / 2 ** 30:.2f} GiB over the weights; caches "
          f"{tuple(cache.ckv.shape)} + {tuple(cache.kpe.shape)} = "
          f"{out['cache_values_per_token_layer']} values a token a layer")
    del cache, lg, last

    # Decode against forward in f32, capacity raised until nothing drops
    # (a check setting: capacity drops depend on the batch).
    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32,
                              moe_capacity_factor=cfg.n_experts / cfg.moe_top_k + 1.0)
    t2 = tokens_on(cfg, 2, 64, "cuda", seed=1)["tokens"]
    with moe.record_routing() as log:
        gaps, top1, finite = decode_against_forward(params, f32, t2, 8)
    dropped = sum(int(b) - int(a) for a, b in log)
    check(dropped == 0, f"11c f32 check: {dropped} slots dropped at capacity factor "
          f"{f32.moe_capacity_factor}")
    check(finite and max(gaps) <= 1e-3, f"11c deepseek f32 decode against forward: gaps {gaps}")
    out.update({"f32_decode_gap": max(gaps), "f32_top1": top1,
                "check_capacity_factor": f32.moe_capacity_factor})
    print(f"phase 11c deepseek f32, capacity factor raised to {f32.moe_capacity_factor:.4g} "
          f"(nothing dropped), 2 prompts x 64 + 8 absorbed decode steps against forward: worst "
          f"gap {max(gaps):.2e} of max|logits| (limit 1e-3)")
    del params
    return out


def mind_users(cfg, n: int, gen: torch.Generator, *, train: bool = False) -> dict:
    """``n`` users drawn on the card with ``mind_batch_stream``'s laws
    (history length uniform in [4, hist_len], full profile bags, N(0, 1)
    routing logits; with ``train`` a target and ``n_negatives`` uniform
    negatives each)."""
    dev = gen.device
    ri = lambda hi, shape: torch.randint(0, hi, shape, generator=gen, device=dev,
                                         dtype=torch.int32)
    hlen = torch.randint(4, cfg.hist_len + 1, (n,), generator=gen, device=dev)
    b = {"hist_ids": ri(cfg.n_items, (n, cfg.hist_len)),
         "hist_mask": torch.arange(cfg.hist_len, device=dev)[None, :] < hlen[:, None],
         "profile_ids": ri(cfg.n_profile_feats, (n, cfg.profile_bag_len)),
         "profile_mask": torch.ones((n, cfg.profile_bag_len), dtype=torch.bool, device=dev),
         "routing_logits_init": torch.randn((n, cfg.n_interests, cfg.hist_len), generator=gen,
                                            device=dev)}
    if train:
        b["target_id"] = ri(cfg.n_items, (n,))
        b["neg_ids"] = ri(cfg.n_items, (n, cfg.n_negatives))
    return b


def drive_mind(card: str):
    """11d: MIND at its published config (1 M items x 64, 100 k profile
    features, history 50, 4 interests, 3 routing rounds, 1279 negatives)
    on its four cells, random weights drawn on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.data import mind_batch_stream
    from repro_torch.models.mind import init_mind, mind_loss, retrieval_scores, serve_user
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.train import init_train_state, make_train_step

    arch = get_arch("mind")
    cfg = arch.make_config()
    gen = torch.Generator(device="cuda").manual_seed(SUBSTRATE_SEED)
    params, _ = init_mind(gen, cfg)
    params_cpu = to_cpu_tree(params)
    out = {}

    def stream_batch(n, seed):
        b = next(mind_batch_stream(batch=n, n_items=cfg.n_items, hist_len=cfg.hist_len,
                                   n_profile_feats=cfg.n_profile_feats,
                                   profile_bag_len=cfg.profile_bag_len,
                                   n_interests=cfg.n_interests, n_negatives=cfg.n_negatives,
                                   seed=seed))
        return {k: torch.from_numpy(v) for k, v in b.items() if k != "step"}

    with torch.no_grad():
        # serve_p99: 512 users, card against CPU.
        p99 = stream_batch(MIND_CELLS["serve_p99"], 0)
        p99_dev = {k: v.cuda() for k, v in p99.items()}
        got = serve_user(params, p99_dev, cfg)
        want = serve_user(params_cpu, p99, cfg)
        err = float(((got.cpu() - want).abs() - 1e-5 * want.abs()).max())
        check(err <= 1e-6, f"11d serve_p99 interests: card against CPU beyond rtol 1e-5 by {err}")
        p99_ms = median_ms(lambda: serve_user(params, p99_dev, cfg), reps=5)
        # serve_bulk: 262144 users drawn on the card.
        bulk = mind_users(cfg, MIND_CELLS["serve_bulk"], gen)
        bulk_ms = median_ms(lambda: serve_user(params, bulk, cfg), reps=3)
        del bulk
        # retrieval_cand: one user against every item, top 10.
        one = {k: v[:1] for k, v in p99_dev.items()}
        one["cand_ids"] = torch.arange(cfg.n_items, dtype=torch.int32, device="cuda")
        _, ids = retrieval_scores(params, one, cfg, top_k=10)
        one_cpu = {k: v.cpu() for k, v in one.items()}
        _, ids_cpu = retrieval_scores(params_cpu, one_cpu, cfg, top_k=10)
        check(torch.equal(ids.cpu(), ids_cpu), f"11d top-10 ids {ids.tolist()} against the "
              f"CPU's {ids_cpu.tolist()}")
        ret_ms = median_ms(lambda: retrieval_scores(params, one, cfg, top_k=10), reps=5)
    out.update({"serve_p99_ms": p99_ms, "serve_p99_users_per_s": 512e3 / p99_ms,
                "serve_bulk_ms": bulk_ms,
                "serve_bulk_users_per_s": MIND_CELLS["serve_bulk"] * 1e3 / bulk_ms,
                "retrieval_ms": ret_ms, "p99_card_vs_cpu_excess": err})

    # 3 train steps at a batch of 512, card against CPU.
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 20, 10_000))
    step_fn = make_train_step(lambda p, b: mind_loss(p, b, cfg), opt)
    states = {"card": init_train_state(params, opt), "host": init_train_state(params_cpu, opt)}
    worst = 0.0
    for i in range(3):
        b = stream_batch(MIND_CELLS["cpu_train_batch"], 10 + i)
        states["card"], mc = step_fn(states["card"], {k: v.cuda() for k, v in b.items()})
        states["host"], mh = step_fn(states["host"], b)
        for k in ("loss", "grad_norm"):
            a, h = float(mc[k]), float(mh[k])
            worst = max(worst, abs(a - h) / abs(h))
            check(abs(a - h) <= 1e-4 * abs(h), f"11d MIND step {i + 1} {k}: card {a} against "
                  f"CPU {h}")
    del states["host"], params_cpu
    # train_batch cut to 16384 users, drawn on the card.
    big = mind_users(cfg, MIND_CELLS["train_batch"], gen, train=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = states["card"]
    state, _ = step_fn(state, big)                                 # warm-up
    ms = []
    for _ in range(3):
        holder = {}
        ms.append(cuda_ms(lambda: holder.update(r=step_fn(state, big))))
        state, m = holder["r"]
    check(math.isfinite(float(m["loss"])), "11d MIND train loss is not finite")
    peak = torch.cuda.max_memory_allocated() - base
    out.update({"train_ms": statistics.median(ms), "train_peak_gib": peak / 2 ** 30,
                "train_card_vs_cpu_rel": worst})
    print(f"phase 11d MIND (published: 1M items x 64, 100k profile features, history 50, "
          f"4 interests, 3 rounds, 1279 negatives) on {card}: serve_p99 {p99_ms:.3f} ms "
          f"({out['serve_p99_users_per_s']:.0f} users/s, interests within rtol 1e-5 of the "
          f"CPU); serve_bulk {bulk_ms:.1f} ms ({out['serve_bulk_users_per_s']:.0f} users/s); "
          f"retrieval_cand {ret_ms:.3f} ms (top-10 ids equal the CPU's); train_batch cut from "
          f"65536 to {MIND_CELLS['train_batch']}: {out['train_ms']:.1f} ms a step, peak "
          f"{peak / 2 ** 30:.2f} GiB; 3 steps at 512 within {worst:.2e} of the CPU")
    return out


SUBSTRATE_CLIS = {
    "serve qwen2-1.5b": (["repro_torch.launch.serve", "--arch", "qwen2-1.5b", "--requests", "4",
                          "--gen", "16"], ["[done] 4 requests"]),
    "serve mind": (["repro_torch.launch.serve", "--arch", "mind", "--requests", "8"],
                   ["[retrieval] top-10"]),
    "train mind": (["repro_torch.launch.train", "--arch", "mind", "--steps", "6",
                    "--log-every", "3"], ["[done] 6 steps"]),
    "train deepseek-v2-236b 6": (["repro_torch.launch.train", "--arch", "deepseek-v2-236b",
                                  "--steps", "6", "--ckpt-every", "3", "--log-every", "3"],
                                 ["[done] 6 steps"]),
}


def start_cli(argv, ck: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if "--ckpt-every" in argv:
        argv = argv + ["--ckpt-dir", str(ck)]
    return subprocess.Popen([sys.executable, "-m", *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))


def finish_cli(card: str, label: str, proc, t0: float, want, times: dict) -> str:
    try:
        so, se = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        so, se = proc.communicate()
    check(proc.returncode == 0 and all(w in so for w in want),
          f"11e {label}: rc {proc.returncode}\n{so[-2000:]}\n{se[-2000:]}")
    times[label] = time.perf_counter() - t0
    print(f"phase 11e {label} on {card}: rc 0, collected {times[label]:.1f} s after its "
          f"start; " + " | ".join(so.strip().splitlines()[-3:]))
    return so


def drive_substrate_clis(card: str, scratch: Path, alongside):
    """11e: the serve and train CLIs on the card at smoke configs, as the
    reference's run: four at once (while ``alongside()`` runs here), then
    the deepseek trainer resumed from its step-6 checkpoint to 9.  ->
    (times, what ``alongside`` returned)."""
    ck = scratch / "substrate_ckpt"
    times = {}
    t0 = time.perf_counter()
    procs = {label: start_cli(argv, ck) for label, (argv, _) in SUBSTRATE_CLIS.items()}
    try:
        other = alongside()
    finally:
        for label, proc in procs.items():
            so = finish_cli(card, label, proc, t0, SUBSTRATE_CLIS[label][1], times)
            check("[resume]" not in so, f"11e {label} resumed from nothing:\n{so}")
    t1 = time.perf_counter()
    argv = SUBSTRATE_CLIS["train deepseek-v2-236b 6"][0]
    argv = argv[:argv.index("--steps") + 1] + ["9"] + argv[argv.index("--steps") + 2:]
    finish_cli(card, "train deepseek-v2-236b 9 (resumed)", start_cli(argv, ck), t1,
               ["[resume] restored step 6", "[done] 9 steps"], times)
    shutil.rmtree(ck, ignore_errors=True)
    times["all_s"] = time.perf_counter() - t0
    return times, other


def compressed_rank(steps: int, *, device: str):
    """11f on one rank of four: the int8 compressed step on a (2, 2, 1)
    (pod, data, model) mesh beside the plain step, the reference test's
    config and batch; -> the totals of each step and a digest of the
    parameters after each."""
    import hashlib

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import LMConfig, init_lm, loss_fn
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.sharding import P
    from repro_torch.train import (init_train_state, make_compressed_train_step,
                                   make_train_step, pod_rows)
    from repro_torch.tree import flatten_with_path, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device=device)
    cfg = LMConfig(name="t", param_dtype=torch.float32, compute_dtype=torch.float32,
                   **COMPRESS_CFG)
    params, _ = init_lm(torch.Generator(device=device).manual_seed(SUBSTRATE_SEED), cfg)
    twin = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 10, 100))
    step_c = make_compressed_train_step(lambda p, b: loss_fn(p, b, cfg), opt, mesh,
                                        lambda b: {"tokens": P("pod"), "labels": P("pod")})
    step_p = make_train_step(lambda p, b: loss_fn(p, b, cfg), opt)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (8, 16))).to(device)
    batch = {"tokens": toks, "labels": toks}
    s1 = init_train_state(params, opt, n_pods=2)
    s1.err = pod_rows(s1.err, mesh)
    s2 = init_train_state(twin, opt)
    totals, digests = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        s1, m1 = step_c(s1, batch)
        s2, m2 = step_p(s2, batch)
        totals.append((float(m1["total"]), float(m2["total"])))
        h = hashlib.sha256()
        for _, v in flatten_with_path(s1.params):
            h.update(v.detach().cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    return {"totals": totals, "digests": digests, "s": time.perf_counter() - t0,
            "device": str(torch.device(device))}


def drive_compressed(card: str):
    """11f: the compressed step on four gloo ranks on the one card (phase
    10b's spawner), 4 steps against the plain step: |total_c - total_plain|
    < 0.05 on every rank (the reference's own bound), parameters bit-equal
    across ranks after each step."""
    from repro_torch.launch.apsp_run import run_ranks

    t0 = time.perf_counter()
    per_rank = run_ranks(compressed_rank, 4, (4,), device="cuda", backend="gloo", timeout=300)
    worst = 0.0
    for rank, r in enumerate(per_rank):
        for i, (c, p) in enumerate(r["totals"]):
            worst = max(worst, abs(c - p))
            check(math.isfinite(c) and abs(c - p) < 0.05,
                  f"11f rank {rank} step {i + 1}: compressed total {c} against plain {p}")
        check(r["digests"] == per_rank[0]["digests"], f"11f rank {rank}: parameters differ "
              f"from rank 0's")
    out = {"worst_total_gap": worst, "s": time.perf_counter() - t0,
           "steps_s_by_rank": [r["s"] for r in per_rank],
           "totals_rank0": per_rank[0]["totals"]}
    print(f"phase 11f compressed step, four gloo ranks on one card on a (2, 2, 1) mesh, 4 steps: "
          f"|total_c - total_plain| <= {worst:.2e} on every rank (limit 0.05), parameters "
          f"bit-equal across ranks after every step; {out['s']:.1f} s with process start")
    return out


def drive_substrate(card: str, scratch: Path):
    """Phase 11: the LM and MIND substrate on the card.  What the earlier
    phases hold is freed first; every cut is printed.  No kernel of this
    repo lies on the path (the reference's attention, MoE dispatch and MIND
    routing are XLA code; the port's are PyTorch's): the launch counters
    must not move."""
    import gc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    print(f"phase 11 on {card}: torch.cuda.memory_allocated() at the start "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    before = launch_counts()
    times = {}
    for key, fn in (("11a/b qwen2-1.5b", lambda: drive_qwen(card)),
                    ("11c deepseek-v2-236b", lambda: drive_deepseek(card)),
                    ("11d mind", lambda: drive_mind(card))):
        t0 = time.perf_counter()
        times[key] = fn()
        times[key]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    check(launch_counts() == before, f"phase 11 launched kernels of this repo: {before} -> "
          f"{launch_counts()}")
    # 11e's four CLIs run while 11f's four ranks do (their times are no metric).
    times["11e CLIs"], times["11f compressed"] = drive_substrate_clis(
        card, scratch, lambda: drive_compressed(card))
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 11 on {card}: {times['phase_s']:.1f} s; {json.dumps(times)}")
    return times


# Phase 12: the dry run (``repro_torch.launch.dryrun``) of every cell on both
# production meshes, traced on the host in the background from the start,
# and real steps on a 1 x 1 mesh against its prediction for the same shape.
DRYRUN_JOBS = 6
DRYRUN_WAIT_S = 600
REAL_CELLS = (("apsp", "square_4k"), ("apsp", "blocked_16k"), ("gcn-cora", "full_graph_sm"),
              ("nequip", "molecule"), ("mind", "serve_p99"), ("mind", "retrieval_cand"),
              ("gcn-cora", "ogb_products"))
# Cells run only if their predicted peak leaves this share of the card free.
SPARE = {("gcn-cora", "ogb_products"): 0.1}
BACKGROUND = []        # processes the smoke started, stopped when it ends


def start_dryrun(out_dir: Path):
    """Start phase 12a: ``python -m repro_torch.launch.dryrun --all --mesh
    both`` in a session of its own at the lowest priority (nice 19), with no
    card visible, so that it traces on the host's idle cores while the
    earlier phases run.  Returns (process, log path)."""
    log = out_dir.parent / "dryrun.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    argv = ["--all", "--mesh", "both", "--jobs", str(DRYRUN_JOBS), "--out-dir", str(out_dir)]
    # The priority is set in the child itself (its workers inherit it).
    code = ("import os, sys\nos.nice(19)\nfrom repro_torch.launch import dryrun\n"
            f"sys.exit(dryrun.main({argv!r}))\n")
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=f,
                                stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                                start_new_session=True)
    BACKGROUND.append(proc)
    return proc, log


def stop_background() -> None:
    """Kill every process group the smoke started that still runs."""
    import signal

    for proc in BACKGROUND:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def drive_dryrun(card: str, proc, log: Path, out_dir: Path):
    """Phase 12.  (a) Wait for the background dry run; every (arch x shape)
    cell on both meshes must end ``ok``, or ``skipped`` with its config's
    reason, and none ``FAILED``; print each cell's GB a rank, the bottleneck
    and the floor.  (b) For each of ``REAL_CELLS``: the dry run on a 1 x 1
    meta mesh, then, where the predicted peak fits the card (with
    ``SPARE``), the real step on the card from arguments drawn on it
    (``DryRunnable.concrete``): the argument bytes equal the prediction's,
    each kernel's launches equal the wrappers' counters and its work, priced
    by ``repro_torch.roofline.kernels``, the bound the launches report on
    the card, the outputs' shapes the prediction's (finite; APSP equal to
    ``repro_torch.solve``); printed beside them, the dot FLOPs against
    ``FlopCounterMode`` and the predicted peak against
    ``max_memory_allocated`` over the arguments' baseline."""
    import contextlib
    import gc

    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch
    from repro_torch.configs import ARCH_IDS, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.builders import build_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.roofline import HW
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    try:
        rc = proc.wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"12a: the dry run did not end within {DRYRUN_WAIT_S} s of phase 12; "
                           f"{log.read_text()[-2000:]}")
    waited = time.perf_counter() - t_phase
    text = log.read_text()
    done = [line for line in text.splitlines() if line.startswith("dry-run done:")]
    check(rc == 0 and len(done) == 1 and " 0 FAILED" in done[0] and "[FAIL]" not in text,
          f"12a: the dry run exited {rc}; {text[-3000:]}")
    want = {f"{a}:{s}@{m}": c.skip_reason for a in ARCH_IDS for s, c in get_arch(a).cells.items()
            for m in ("pod16x16", "pod2x16x16")}
    recs = {r["cell"]: r for r in (json.loads(p_.read_text()) for p_ in out_dir.glob("*.json"))}
    check(set(recs) == set(want), f"12a: records for {sorted(set(recs) ^ set(want))} differ")
    table = {}
    for tag, reason in want.items():
        r = recs[tag]
        if reason:
            check(r["status"] == "skipped" and r["reason"] == reason,
                  f"12a: {tag} should be skipped ({reason}), is {r['status']}")
            continue
        check(r["status"] == "ok", f"12a: {tag} ended {r['status']}: {r.get('error')}")
        m_ = r["memory"]
        table[tag] = {"gb_a_rank": m_["total_gb"], "fits_80gb": m_["fits"],
                      "bottleneck": r["roofline"]["bottleneck"],
                      "floor_s": r["floor"]["floor_s"], "trace_s": r["trace_s"]}
        print(f"12a {tag}: {m_['total_gb']:.3f} GB a rank ({'fits' if m_['fits'] else 'over'} "
              f"80 GB), bottleneck {r['roofline']['bottleneck']}, floor "
              f"{r['floor']['floor_s']:.4e} s, traced in {r['trace_s']} s")
    n_ok, n_skip = len(table), sum(1 for v in want.values() if v)
    print(f"phase 12a: {n_ok} ok, {n_skip} skipped, 0 FAILED on both meshes; {done[0]}; "
          f"phase 12 waited {waited:.1f} s for it")

    meta = make_host_mesh(device="meta")
    real_cells = {}
    for arch_id, shape_id in REAL_CELLS:
        arch = get_arch(arch_id)
        cell = arch.cells[shape_id]
        label = f"{arch_id}:{shape_id}"
        pred = dryrun.predict(build_cell(arch, cell, meta), meta)
        mem = pred["memory"]["bytes"]
        spare = SPARE.get((arch_id, shape_id), 0.0)
        kernels = pred["kernels"]
        entry = {"predicted_gb": mem["total"] / 1e9, "predicted_args_gb": mem["args"] / 1e9,
                 "spare": spare, "fits": mem["total"] <= (1 - spare) * HW.HBM_BYTES,
                 "predicted_launches": {k: v["launches"] for k, v in kernels.items()},
                 "predicted_bound_ms": {k: v["bound_ms"] for k, v in kernels.items()},
                 "predicted_dot_flops": pred["roofline"]["dot_flops"],
                 "predicted_t_s": {k: pred["roofline"][k] for k in
                                   ("t_compute_s", "t_memory_s", "t_collective_s")},
                 "trace_s": pred["trace_s"]}
        if not entry["fits"]:
            print(f"12b {label}: predicted {entry['predicted_gb']:.2f} GB does not fit the "
                  f"card's 80 GB with {spare:.0%} to spare: not run")
            real_cells[label] = entry
            continue
        dr = build_cell(arch, cell, make_host_mesh(device="cuda"))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        args = dr.concrete("cuda", seed=0)
        arg_bytes = sum(t.numel() * t.element_size() for t in leaves(args))
        check(arg_bytes == mem["args"], f"12b {label}: argument bytes {arg_bytes} differ from "
              f"the predicted {mem['args']}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        grad = contextlib.nullcontext() if dr.train else torch.no_grad()
        t0 = time.perf_counter()
        with grad, FlopCounterMode(display=False) as fc, OpCounter() as oc:
            out = dr.fn(*args)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        check(launched == entry["predicted_launches"],
              f"12b {label}: launched {launched}, predicted {entry['predicted_launches']}")
        real_bound = {k: v["bound_ms"] for k, v in oc.cost.kernels.items()}
        check(real_bound == entry["predicted_bound_ms"],
              f"12b {label}: the launches' bounds {real_bound} differ from the predicted "
              f"{entry['predicted_bound_ms']}")
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        check([list(t.shape) for t in outs] == pred["out_shapes"],
              f"12b {label}: output shapes differ from the prediction's")
        check(all(bool(torch.isfinite(t).all()) for t in outs if t.is_floating_point()
                  and arch_id != "apsp"), f"12b {label}: a non-finite output")
        if arch_id == "apsp":
            check(same(out, repro_torch.solve(args[0]).dist),
                  f"12b {label}: differs from repro_torch.solve")
        entry.update({"ran": True, "args_gb": arg_bytes / 1e9, "peak_gb": peak / 1e9,
                      "predicted_over_peak": mem["total"] / peak, "launches": launched,
                      "dot_flops": fc.get_total_flops(),
                      "dot_flops_ratio": (entry["predicted_dot_flops"] / fc.get_total_flops()
                                          if fc.get_total_flops() else None),
                      "step_ms_host_clock": step_ms})
        print(f"12b {label} on {card}: ran; argument bytes {arg_bytes} as predicted; launches "
              f"{launched} as predicted; kernel bounds {real_bound} ms as predicted; dot FLOPs "
              f"{entry['predicted_dot_flops']:.6e} predicted, {fc.get_total_flops():.6e} by "
              f"FlopCounterMode; peak {peak / 1e9:.4f} GB over the baseline, predicted "
              f"{entry['predicted_gb']:.4f} (ratio {entry['predicted_over_peak']:.4f}); step "
              f"{step_ms:.1f} ms (host clock, counters on)")
        real_cells[label] = entry
        del args, out, outs, dr
        gc.collect()
        torch.cuda.empty_cache()
    ran = sum(1 for e in real_cells.values() if e.get("ran"))
    check(all(e.get("ran") or not e["fits"] for e in real_cells.values()),
          "12b: a cell predicted to fit did not run")
    print(f"phase 12 on {card}: {time.perf_counter() - t_phase:.1f} s; 12b ran {ran} of "
          f"{len(real_cells)} cells; {json.dumps({'dryrun': table, 'real': real_cells})}")
    return real_cells


# Phase 13: the port's invariant checkers on the card.
ANALYSIS_TIMEOUT_S = 240


def zero_launch_counts() -> None:
    kernel_module("fw_round").rounds = 0
    for name in ("minplus", "fw_block", "row_close"):
        counts = kernel_module(name).launches
        counts.update(dict.fromkeys(counts, 0))


def drive_analysis(card: str, h16: torch.Tensor):
    """Phase 13.  (a) ``python -m repro_torch.analysis --json --require-cuda``
    in a subprocess: exit 0, no gating finding; the lattice through each of
    the six CUDA kernels, each with a canary hit, every plan and kernel
    mutant flagged with its kind and the controls clean (the checker's
    stderr summary).  (b) Every plan mutant with a C form handed to its C
    entry point is refused and leaves its output's canary intact.  (c)
    ``solve`` at N = 16384, B = 512 with ``donate=True`` and with
    ``donate=False``: the first returns the input's storage and rises by
    less than one round's scratch, the second rises by one N^2 matrix more."""
    from repro_torch.analysis.kernelcheck import mutants as kmut

    import repro_torch

    t_phase = time.perf_counter()
    # 13a
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--json",
                           "--require-cuda"], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          timeout=ANALYSIS_TIMEOUT_S)
    analysis_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(f"13a: python -m repro_torch.analysis exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    check(report["schema"] == 1 and set(report) == {"schema", "checks", "findings"},
          f"13a: the --json schema changed: {sorted(report)}")
    gating = [f for f in report["findings"] if not f["advisory"]]
    check(not gating, f"13a: gating findings: {gating}")
    per_check = {c: sum(f["check"] == c for f in report["findings"]) for c in report["checks"]}
    check(len(report["checks"]) == 7, f"13a: {len(report['checks'])} checks ran, not 7")
    line = next(ln for ln in proc.stderr.splitlines()
                if ln.startswith("analyze: [kernel-grid] {"))
    summary = json.loads(line.split("] ", 1)[1])
    six = ("fw_round", "minplus", "minplus_argmin", "fw_block", "fw_block_pred", "row_close")
    for k in six:
        check(summary["cuda_cases"].get(k, 0) >= 1 and summary["canary_hits"].get(k, 0) >= 1
              and summary["cuda_launches"].get(k, 0) >= 1,
              f"13a: {k} ran {summary['cuda_cases'].get(k)} lattice cases on the card with "
              f"{summary['canary_hits'].get(k)} canary hits, {summary['cuda_launches'].get(k)} "
              "launches")
    for name, got in list(summary["mutants"].items()) + list(summary["kernel_mutants"].items()):
        want = got["expect"]
        check((want is None and not got["found"]) or (want in got["found"]),
              f"13a: {name} expected {want or 'clean'}, found {got['found']}")
    print(f"phase 13a on {card}: python -m repro_torch.analysis --json --require-cuda exit 0 in "
          f"{analysis_s:.1f} s; findings per check {json.dumps(per_check)}; lattice cases "
          f"through each CUDA kernel {json.dumps(summary['cuda_cases'])} (CPU interpreter "
          f"{json.dumps(summary['cpu_cases'])}), launches {json.dumps(summary['cuda_launches'])}, "
          f"canary hits {json.dumps(summary['canary_hits'])}; plan mutants "
          f"{json.dumps(summary['mutants'])}; kernel mutants "
          f"{json.dumps(summary['kernel_mutants'])}")

    # 13b
    refused = {}
    for m in kmut.mutant_cases():
        if m.c_form is None:
            continue
        got = kmut.refused_on_card(m)
        refused[m.case.name] = got
        check(got["refused"] and got["intact"],
              f"13b: {m.case.name}'s plan was not refused by its C entry point or its "
              f"output's canary changed: {got}")
    print(f"phase 13b on {card}: every plan mutant with a C form refused, canary intact: "
          f"{json.dumps(refused)}")

    # 13c
    fr = kernel_module("fw_round")
    n, b = h16.shape[0], 512
    plan = fr.launch_plan(1, n, b)
    scratch = sum(math.prod(s) * 4 for s in plan.scratch.values())
    slack = 512 * len(plan.scratch)          # the caching allocator's 512-byte blocks
    rise, runs = {}, {}
    for donate in (True, False):
        x = h16.clone()
        ptr = x.data_ptr()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        t0 = time.perf_counter()
        r = repro_torch.solve(x, block_size=b, round_mode="fused", donate=donate,
                              validate=False)
        torch.cuda.synchronize()
        runs[donate] = {"ms": 1e3 * (time.perf_counter() - t0), "launches": launch_counts()}
        rise[donate] = torch.cuda.max_memory_allocated() - base
        check(runs[donate]["launches"]["fw_round"] == n // b and
              sum(runs[donate]["launches"].values()) == n // b,
              f"13c: donate={donate} launched {runs[donate]['launches']}, not {n // b} rounds")
        aliased = r.dist.data_ptr() == ptr
        check(aliased == donate, f"13c: donate={donate}: the result "
                                 f"{'does not alias' if donate else 'aliases'} the input")
        check(same(r.dist, repro_torch.solve(h16, block_size=b).dist) if not donate else True,
              "13c: the copying solve differs from the B = 512 solve")
        del r, x
    matrix = n * n * 4
    check(rise[True] <= scratch + slack,
          f"13c: donate=True rose {rise[True]} bytes, more than one round's scratch "
          f"{scratch} (+{slack})")
    check(matrix <= rise[False] <= matrix + scratch + slack,
          f"13c: donate=False rose {rise[False]} bytes, not one {matrix}-byte matrix and at "
          f"most one round's scratch")
    print(f"phase 13c on {card}: solve N={n} B={b}: donate=True returns the input's storage, "
          f"max_memory_allocated rose {rise[True]} bytes ({rise[True] / 2 ** 20:.2f} MiB; one "
          f"round's scratch {scratch} bytes = {scratch / 2 ** 20:.2f} MiB), "
          f"{runs[True]['ms']:.1f} ms; donate=False a new tensor, rose {rise[False]} bytes "
          f"({rise[False] / 2 ** 30:.4f} GiB; the N^2 matrix {matrix / 2 ** 30:.0f} GiB), "
          f"{runs[False]['ms']:.1f} ms; launches {json.dumps(runs[True]['launches'])}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 13 on {card}: {phase_s:.1f} s")
    return {"analysis_s": analysis_s, "per_check": per_check, "summary": summary,
            "refused": refused, "rise_bytes": {str(k): v for k, v in rise.items()},
            "scratch_bytes": scratch, "phase_s": phase_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    # The port's autotune cache in a fresh file: one left on the host would
    # change the block size the earlier phases solve at.  Phase 8 tunes into
    # it; the directory also holds phase 8's checkpoints.
    scratch = Path(tempfile.mkdtemp(prefix="chip-smoke-"))
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(scratch / "autotune.json")
    try:
        return run(scratch)
    finally:
        stop_background()
        shutil.rmtree(scratch, ignore_errors=True)


def run(scratch: Path) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import scipy.sparse
    from scipy.sparse.csgraph import dijkstra

    import repro_torch
    from repro_torch.core import (
        init_pred,
        path_cost,
        reconstruct_path,
        reconstruct_path_device,
        validate_tree,
    )
    from repro_torch.core.semiring import pad_pred_to_multiple, pad_to_multiple, unpad
    from repro_torch.kernels import _build, ops

    fb, fr, mp = kernel_module("fw_block"), kernel_module("fw_round"), kernel_module("minplus")

    dev = torch.device("cuda")

    # 1. The card and the build.
    card = nvidia_smi("name,power.limit")
    print(card)
    # Phase 12a's dry run traces on the host's idle cores from here on.
    dry_proc, dry_log = start_dryrun(scratch / "dryrun")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}: {sms} SMs, max SM clock {clock_mhz:g} MHz")
    t0 = time.perf_counter()
    _build.build(_build.sources())
    print(f"kernel build {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name in _build.sources():
        print(f"ptxas {name}.cu: {json.dumps(_build.ptxas_report(name), sort_keys=True)}")
    # The folds' hottest loops in the SASS: instructions a candidate (one FADD
    # a tropical candidate), the premise of the operations bound below, and
    # what the loop around it (a k slice: copies, barrier) adds.
    for src_, k in (("fw_round", "fw_update<0,float>"), ("minplus", "minplus<0,true>"),
                    ("minplus", "minplus_argmin<0,true>"), ("minplus", "minplus_pred<0,true>"),
                    ("row_close", "row_close<0,64>"), ("row_close", "row_close<0,16>"),
                    ("row_close", "row_close_pred<0,64>"), ("row_close", "row_close_pred<0,16>")):
        loops = sass_loops(_build, src_, k)
        hot = loops[0]
        around = [lp for lp in loops if lp["start"] <= hot["start"] and lp["end"] >= hot["end"]
                  and lp is not hot]
        extra = (f"; the loop around it {min(lp['instructions'] for lp in around)} instructions"
                 if around else "")
        print(f"sass {k}: hottest loop {hot['instructions']} instructions, {hot['FADD']} FADD "
              f"= {hot['instructions'] / hot['FADD']:.3f} instructions a candidate{extra}; "
              f"{json.dumps(hot['histogram'])}")

    elapsed("phase 2")
    # 2. Kernel against the plain version on the card.
    print("tolerance: exact (torch.equal, NaN in the same places)")
    err = 0.0

    def compare(label, d, o, b, semiring="tropical"):
        nonlocal err
        got = fr.fw_round_cuda(d.clone(), o, block_size=b, semiring=semiring)
        want = fr.fw_round_torch(d, o, block_size=b, semiring=semiring)
        torch.cuda.synchronize()
        check(same(got, want), f"fw_round {label}: kernel differs from the plain version")
        err = max(err, abs_err(got, want))
        print(f"fw_round {label} pivot {o // b}: equal")

    rng = np.random.default_rng(0)
    for b in (64, 256):
        for name in SEMIRING_NAMES:
            d = torch.from_numpy(in_domain(rng, 2048, name)).to(dev)
            compare(f"N=2048 B={b} {name}", d, b * (2048 // b // 2), b, name)
    hs = np.stack([in_domain(rng, 1024, "tropical") for _ in range(4)])
    compare("G=4 N=1024 B=256 tropical", torch.from_numpy(hs).to(dev), 512, 256)
    d = torch.from_numpy(in_domain(rng, 2048, "tropical")).to(dev).to(torch.bfloat16)
    compare("N=2048 B=256 bf16 tropical", d, 768, 256)
    h = in_domain(rng, 64, "tropical")
    h[3, 40] = h[40, 50] = np.nan
    for o in (0, 32):
        compare("N=64 B=32 with NaN", torch.from_numpy(h).to(dev), o, 32)
    # The cluster closure's tile classes, a G = 3 round and bf16 among them,
    # and N that is not a multiple of 4 (the scratches' pitch).
    for b in CLOSURE_B:
        compare(f"N={2 * b} B={b} tropical", torch.from_numpy(in_domain(rng, 2 * b, "tropical")).to(dev),
                b, b)
    for b in (9, 100, 256):
        hs = np.stack([in_domain(rng, 2 * b, "bottleneck") for _ in range(3)])
        compare(f"G=3 N={2 * b} B={b} bottleneck", torch.from_numpy(hs).to(dev), b, b, "bottleneck")
        d = torch.from_numpy(in_domain(rng, 2 * b, "tropical")).to(dev).to(torch.bfloat16)
        compare(f"N={2 * b} B={b} bf16 tropical", d, 0, b)
    for n_, b in ((7, 7), (19, 19), (100, 50)):
        d = torch.from_numpy(in_domain(rng, n_, "tropical")).to(dev)
        for o in range(0, n_, b):
            compare(f"N={n_} B={b} tropical", d, o, b)
    # Tiles above 256 nodes: the grid closure (fw_closure_grid).
    for b in (257,) + LARGE_B:
        d = torch.from_numpy(in_domain(rng, 2 * b, "tropical")).to(dev)
        compare(f"N={2 * b} B={b} tropical", d, b, b)
        hs = np.stack([in_domain(rng, 2 * b, "bottleneck") for _ in range(3)])
        compare(f"G=3 N={2 * b} B={b} bottleneck", torch.from_numpy(hs).to(dev), 0, b, "bottleneck")
        compare(f"N={2 * b} B={b} bf16 tropical", d.to(torch.bfloat16), 0, b)

    elapsed("phase 2b")
    # 2b. The slice-2 kernels against their plain versions on the card.  bf16
    # operands reach a kernel upcast, as ops sends them, and its value is
    # rounded once.
    errs = dict.fromkeys(("minplus", "minplus_argmin", "minplus_pred", "fw_block",
                          "fw_block_pred"), 0.0)
    pairs = {"minplus": (mp.minplus_cuda, mp.minplus_torch),
             "minplus_argmin": (mp.minplus_argmin_cuda, mp.minplus_argmin_torch),
             "minplus_pred": (mp.minplus_pred_cuda, mp.minplus_pred_torch),
             "fw_block": (fb.fw_block_cuda, fb.fw_block_torch),
             "fw_block_pred": (fb.fw_block_pred_cuda, fb.fw_block_pred_torch)}

    def compare_new(kind, label, *args, semiring="tropical", **kw):
        cuda_fn, plain_fn = pairs[kind]
        up = [t.float() if t is not None and t.is_floating_point() else t for t in args]
        got = cuda_fn(*up, semiring=semiring, **kw)
        want = plain_fn(*args, semiring=semiring, **kw)
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        value = got[0].to(args[0].dtype)
        ok = same(value, want[0]) and all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
        check(ok, f"{kind} {label}: kernel differs from the plain version")
        errs[kind] = max(errs[kind], abs_err(value, want[0]))
        print(f"{kind} {label}: equal")

    rng = np.random.default_rng(1)
    for kind in ("minplus", "minplus_argmin"):
        for name in SEMIRING_NAMES:
            for ties in (False, True):
                x, y = operand(rng, (1000, 300), name, ties), operand(rng, (300, 777), name, ties)
                a = operand(rng, (1000, 777), name, ties, density=0.2)
                tag = f"1000x300 x 300x777 {name}{' ties' if ties else ''}"
                compare_new(kind, tag, x, y, semiring=name)
                compare_new(kind, tag + " accumulate", x, y, a, semiring=name)
        x, y = operand(rng, (4, 256, 256), "tropical"), operand(rng, (4, 256, 1024), "tropical")
        a = operand(rng, (4, 256, 1024), "tropical", density=0.2)
        compare_new(kind, "G=4 256x256 x 256x1024 tropical", x, y)
        compare_new(kind, "G=4 256x256 x 256x1024 tropical accumulate", x, y, a)
        x, y = operand(rng, (1000, 300), "tropical", True), operand(rng, (300, 777), "tropical", True)
        a = operand(rng, (1000, 777), "tropical", True, density=0.2)
        compare_new(kind, "1000x300 x 300x777 bf16 tropical", x.bfloat16(), y.bfloat16())
        compare_new(kind, "1000x300 x 300x777 bf16 tropical accumulate",
                    x.bfloat16(), y.bfloat16(), a.bfloat16())
        x[5, :] = x[17, 40] = y[9, 3] = a[0, 0] = float("nan")
        for name in ("tropical", "bottleneck"):
            compare_new(kind, f"1000x300 x 300x777 {name} with NaN", x, y, semiring=name)
            compare_new(kind, f"1000x300 x 300x777 {name} with NaN accumulate", x, y, a,
                        semiring=name)
    for name in SEMIRING_NAMES:
        d = torch.from_numpy(in_domain(rng, 256, name)).to(dev)[None]
        p = init_pred(d[0], name)[None].contiguous()
        compare_new("fw_block", f"T=1 B=256 {name}", d, semiring=name)
        compare_new("fw_block_pred", f"T=1 B=256 {name}", d, p, semiring=name)
    d = torch.stack([torch.from_numpy(in_domain(rng, 100, "tropical")) for _ in range(3)]).to(dev)
    p = torch.stack([init_pred(t, "tropical") for t in d])
    compare_new("fw_block", "T=3 B=100 tropical", d)
    compare_new("fw_block_pred", "T=3 B=100 tropical", d, p)
    d = torch.from_numpy(repro_torch.generate_np(rng, 256).h).to(dev)
    p = init_pred(d)
    compare_new("fw_block", "B=256 bf16 tropical", d.bfloat16())
    compare_new("fw_block_pred", "B=256 bf16 tropical", d.bfloat16(), p)
    d[2, 7], d[7, 2], d[100, 101] = -9.0, 3.0, float("nan")
    compare_new("fw_block", "B=256 tropical, negative cycle and NaN", d)
    compare_new("fw_block_pred", "B=256 tropical, negative cycle and NaN", d, p)
    check(bool((torch.diagonal(fb.fw_block_pred_torch(d, p)[0]) < 0).any()),
          "the negative-cycle tile has no negative diagonal")
    for b in CLOSURE_B:
        for t_, name in ((1, "tropical"), (3, "reliability")):
            d = torch.stack([torch.from_numpy(in_domain(rng, b, name)) for _ in range(t_)]).to(dev)
            p = torch.stack([init_pred(x, name) for x in d])
            compare_new("fw_block", f"T={t_} B={b} {name}", d, semiring=name)
            compare_new("fw_block_pred", f"T={t_} B={b} {name}", d, p, semiring=name)
    for b in (9, 100, 255):
        d = torch.from_numpy(repro_torch.generate_np(rng, b, rho=30.0).h).to(dev)
        p = init_pred(d)
        d[2, 7], d[7, 2], d[b - 2, b - 1] = -9.0, 3.0, float("nan")
        compare_new("fw_block", f"B={b} tropical, negative cycle and NaN", d)
        compare_new("fw_block_pred", f"B={b} tropical, negative cycle and NaN", d, p)
        check(bool((torch.diagonal(fb.fw_block_pred_torch(d, p)[0]) < 0).any()),
              f"the B={b} negative-cycle tile has no negative diagonal")
    # The grid closure (tiles above 256 nodes): a T = 3 stack, and one tile
    # with a negative cycle and NaN.
    for b in (257,) + LARGE_B:
        d = torch.stack([torch.from_numpy(in_domain(rng, b, "reliability"))
                         for _ in range(3)]).to(dev)
        p = torch.stack([init_pred(x, "reliability") for x in d])
        compare_new("fw_block", f"T=3 B={b} reliability", d, semiring="reliability")
        compare_new("fw_block_pred", f"T=3 B={b} reliability", d, p, semiring="reliability")
        d = torch.from_numpy(repro_torch.generate_np(rng, b, rho=30.0).h).to(dev)
        p = init_pred(d)
        d[2, 7], d[7, 2], d[b - 2, b - 1] = -9.0, 3.0, float("nan")
        compare_new("fw_block", f"B={b} tropical, negative cycle and NaN", d)
        compare_new("fw_block_pred", f"B={b} tropical, negative cycle and NaN", d, p)
        check(bool((torch.diagonal(fb.fw_block_pred_torch(d, p)[0]) < 0).any()),
              f"the B={b} negative-cycle tile has no negative diagonal")
    # The pred epilogue: a G = 3 batch with ties, k_offset != j_offset (some
    # winners are the output's own column), px a strided view, with and
    # without the fallback.
    for name in SEMIRING_NAMES:
        x, y = operand(rng, (3, 300, 96), name, True), operand(rng, (3, 96, 260), name, True)
        a = operand(rng, (3, 300, 260), name, True, density=0.2)
        px = torch.randint(-1, 5000, (3, 300, 136), dtype=torch.int32, device=dev)[..., 17:113]
        py = torch.randint(-1, 5000, (3, 96, 260), dtype=torch.int32, device=dev)
        pa = torch.randint(-1, 5000, (3, 300, 260), dtype=torch.int32, device=dev)
        for ko, jo in ((0, 0), (100, 40)):
            tag = f"G=3 300x96 x 96x260 {name} ties k_offset={ko} j_offset={jo}"
            compare_new("minplus_pred", tag, x, y, px, py, k_offset=ko, j_offset=jo,
                        semiring=name)
            compare_new("minplus_pred", tag + " accumulate", x, y, px, py, a, pa,
                        k_offset=ko, j_offset=jo, semiring=name)
            compare_new("minplus_pred", tag + " accumulate, no fallback", x, y, px, py, a,
                        None, k_offset=ko, j_offset=jo, semiring=name)

    elapsed("phase 3")
    # 3. The main path: repro_torch.solve with all defaults.
    def plain_solve(h_dev, b=256):
        n = h_dev.shape[0]
        d = pad_to_multiple(h_dev, b)
        for t in range(d.shape[0] // b):
            d = fr.fw_round_torch(d, t * b, block_size=b, semiring="tropical")
        return unpad(d, n)

    results = {}
    path_clusters = {}
    for n in (8192, 8191):
        g = repro_torch.generate_np(np.random.default_rng(0), n, rho=2.0)
        clusters_seen(_build)
        fr.rounds = 0
        t0 = time.perf_counter()
        dist = repro_torch.solve(g.h).dist
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rounds = fr.rounds
        seen = clusters_seen(_build)
        expect = math.ceil(n / min(256, n))
        check(rounds == expect, f"N={n}: {rounds} fw_round rounds, expected {expect}")
        want = {"fw_closure": fb.closure_plan(min(256, n)).cluster, "fw_block": 0,
                "fw_block_pred": 0}
        check(seen == want, f"N={n}: the closures ran on clusters of {seen}, expected {want}")
        path_clusters[f"main N={n}"] = seen
        check(dist.is_cuda and dist.shape == (n, n), f"N={n}: result {dist.device} {dist.shape}")
        t0 = time.perf_counter()
        ref = plain_solve(torch.from_numpy(g.h).to(dev))
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        check(same(dist, ref), f"N={n}: solve differs from the plain solve on the card")
        err = max(err, abs_err(dist, ref))
        src = np.random.default_rng(1).choice(n, 32, replace=False)
        off = np.isfinite(g.h) & ~np.eye(n, dtype=bool)
        graph = scipy.sparse.csr_matrix((g.h[off], np.nonzero(off)), shape=(n, n))
        dj = dijkstra(graph, directed=True, indices=src)
        rows = dist[torch.from_numpy(src).to(dev)].cpu().numpy().astype(np.float64)
        check(np.array_equal(rows, dj), f"N={n}: rows differ from scipy Dijkstra")
        print(f"main path N={n} rho=2.0: repro_torch.solve {wall:.3f} s host clock, "
              f"fw_round rounds {rounds}, fw_closure on clusters of {seen['fw_closure']} "
              f"CTAs (read from the card); equal to the plain solve ({plain_wall:.3f} s) "
              f"and to Dijkstra on 32 sources; finite share "
              f"{float(torch.isfinite(dist).float().mean()):.4f}")
        results[n] = (g.h, rounds, dist, src, dj)

    elapsed("phase 3b")
    # 3b. The slice-2 paths, each driven with every count set to 0 just
    # before it and read just after.
    def counts():
        return {"fw_round": fr.rounds, **mp.launches, **fb.launches}

    kernel_of = {"fw_closure": "fw_round", "fw_block": "fw_block", "fw_block_pred": "fw_block_pred"}

    def drive(label, h, expect, b=256, **options):
        fr.rounds = 0
        mp.launches.update(dict.fromkeys(mp.launches, 0))
        fb.launches.update(fw_block=0, fw_block_pred=0)
        clusters_seen(_build)
        t0 = time.perf_counter()
        res = repro_torch.solve(h, block_size=b, **options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        seen = clusters_seen(_build)
        got = {k: v for k, v in counts().items() if v}
        check(got == expect, f"{label}: launches {got}, expected {expect}")
        # The cluster closures record their cluster; the grid closure (B >
        # 256) records none.
        want = {k: fb.closure_plan(b, pred=k == "fw_block_pred").cluster
                if b <= fb.MAX_BLOCK and kernel_of[k] in got else 0 for k in seen}
        check(seen == want, f"{label}: the closures ran on clusters of {seen}, expected {want}")
        path_clusters[label] = seen
        check(res.dist.is_cuda and (res.pred is None or (res.pred.is_cuda and
              res.pred.dtype == torch.int32)), f"{label}: result off the card")
        path_launches[label] = got
        print(f"{label}: repro_torch.solve {wall:.3f} s host clock, launches {got}, "
              f"clusters read from the card {seen}")
        return res

    path_launches = {}

    def plain_pred_solve(h, b, split):
        """The pred rounds composed from the plain versions, on h's device."""
        n = h.shape[0]
        d = pad_to_multiple(h, b)
        p = pad_pred_to_multiple(init_pred(h), b)
        for t in range(d.shape[0] // b):
            o = t * b
            piv, ppiv = fb.fw_block_pred_torch(d[o:o + b, o:o + b], p[o:o + b, o:o + b])
            row, prow = d[o:o + b, :], p[o:o + b, :]
            col, pcol = d[:, o:o + b], p[:, o:o + b]
            if split:
                row, k = mp.minplus_argmin_torch(piv, row, row)
                prow = ops.pred_from_kstar(k, ppiv, prow, k_offset=o, fallback=prow)
            col2, k = mp.minplus_argmin_torch(col, piv, col)
            pcol = ops.pred_from_kstar(k, pcol, ppiv, k_offset=o, j_offset=o, fallback=pcol)
            if split:
                col2[o:o + b], pcol[o:o + b] = piv, ppiv
            d2, k = mp.minplus_argmin_torch(col2, row, d)
            p = ops.pred_from_kstar(k, pcol, prow, k_offset=o, fallback=p)
            d = d2
        return unpad(d, n), unpad(p, n)

    for n in (8192, 8191):
        h_np, rounds, dist, src, dj = results[n]
        res = drive(f"with_pred N={n}", h_np,
                    {"fw_block_pred": rounds, "minplus_pred": 2 * rounds}, with_pred=True)
        check(same(res.dist, dist), f"with_pred N={n}: dist differs from the main path's")
        t0 = time.perf_counter()
        want_d, want_p = plain_pred_solve(torch.from_numpy(h_np).to(dev), 256, split=False)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        check(same(res.dist, want_d) and torch.equal(res.pred, want_p),
              f"with_pred N={n}: dist or pred differs from the plain pred solve")
        del want_d, want_p
        t0 = time.perf_counter()
        check(validate_tree(h_np, res.dist, res.pred), f"with_pred N={n}: invalid tree")
        tree_s = time.perf_counter() - t0
        targets = np.random.default_rng(2).integers(0, n, size=(len(src), 16))
        walked = 0
        for row, (s_, ts) in enumerate(zip(src, targets)):
            for t_ in ts:
                path = reconstruct_path(res.pred, int(s_), int(t_))
                if not np.isfinite(dj[row, t_]):
                    check(path is None, f"with_pred N={n}: a path to an unreachable node")
                    continue
                check(path is not None and path[0] == s_ and path[-1] == t_ and
                      path_cost(h_np, path) == dj[row, t_],
                      f"with_pred N={n}: path {s_}->{t_} does not cost Dijkstra's distance")
                walked += 1
                if walked <= 4:
                    dpath, dlen = reconstruct_path_device(res.pred, int(s_), int(t_),
                                                          max_len=len(path) + 2)
                    check(int(dlen) == len(path) and dpath[:len(path)].tolist() == path,
                          f"with_pred N={n}: device walk differs from the host walk")
        print(f"with_pred N={n}: dist equal to the main path's; dist and pred equal to the "
              f"plain pred solve on the card ({plain_wall:.1f} s); validate_tree holds "
              f"({tree_s:.1f} s on the host); {walked} paths from 32 sources cost "
              f"Dijkstra's distance")

    h_np, rounds, dist = results[8192][:3]
    for options, expect in (
        ({"round_mode": "split"}, {"fw_block": rounds, "minplus": 3 * rounds}),
        ({"round_mode": "split", "with_pred": True},
         {"fw_block_pred": rounds, "minplus_pred": 3 * rounds}),
    ):
        label = "split" + (" with_pred" if options.get("with_pred") else "") + " N=8192"
        res = drive(label, h_np, expect, **options)
        check(same(res.dist, dist), f"{label}: dist differs from the fused solve's")
        check(res.pred is None or tree_holds(torch.from_numpy(h_np).to(dev), res.dist, res.pred),
              f"{label}: invalid tree")
        if res.pred is not None:
            want_d, want_p = plain_pred_solve(torch.from_numpy(h_np).to(dev), 256, split=True)
            torch.cuda.synchronize()
            check(same(res.dist, want_d) and torch.equal(res.pred, want_p),
                  f"{label}: dist or pred differs from the plain pred solve")
            del want_d, want_p
            print(f"{label}: dist and pred equal to the plain pred solve on the card")
        print(f"{label}: dist equal to the fused solve's")

    h2 = torch.from_numpy(repro_torch.generate_np(np.random.default_rng(0), 2048, rho=2.0).h).to(dev)
    for split in (False, True):
        res = repro_torch.solve(h2, with_pred=True, round_mode="split" if split else "fused")
        want_d, want_p = plain_pred_solve(h2, 256, split)
        torch.cuda.synchronize()
        check(same(res.dist, want_d) and torch.equal(res.pred, want_p),
              f"N=2048 {'split' if split else 'fused'} pred solve differs from the plain one")
        print(f"N=2048 {'split' if split else 'fused'} with_pred: dist and pred equal to the "
              f"plain pred solve on the card")

    elapsed("phase 3c")
    # 3c. Tiles above 256 nodes (the grid closure) on every path: at N = 8192
    # dist equals the B = 256 solve's (integer weights: every sum is exact),
    # preds form a valid tree; at N = 2048, B = 512 the pred solves equal the
    # plain pred solve on the card.  Then the reference's blocked_16k shape,
    # N = 16384 at B = 512 (a 1 GiB f32 state), against its B = 256 solve.
    h_np, rounds, dist = results[8192][:3]
    h8 = torch.from_numpy(h_np).to(dev)
    large = {}
    for b in LARGE_B:
        r_ = 8192 // b
        for path, options in SOLVE_PATHS.items():
            pred_, split_ = options.get("with_pred", False), "round_mode" in options
            expect = ({"fw_block_pred": r_, "minplus_pred": (3 if split_ else 2) * r_} if pred_
                      else {"fw_block": r_, "minplus": 3 * r_} if split_ else {"fw_round": r_})
            label = f"{path} B={b}"
            res = drive(label, h_np, expect, b=b, **options)
            check(same(res.dist, dist), f"{label}: dist differs from the B=256 solve's")
            check(res.pred is None or tree_holds(h8, res.dist, res.pred), f"{label}: invalid tree")
            print(f"{label}: dist equal to the B=256 solve's"
                  f"{'; the tree invariant holds (on the card)' if res.pred is not None else ''}")
            del res
        # The grid closures' device time, from a traced solve of each path
        # that runs one (a closure a round).
        for path, grid in (("main N=8192", "fw_closure_grid"),
                           ("with_pred N=8192", "fw_block_pred_grid"),
                           ("split N=8192", "fw_block_grid")):
            rows_, _, _, launched = device_breakdown(
                f"one solve, {path} B={b}",
                lambda: repro_torch.solve(h8, block_size=b, **SOLVE_PATHS[path]))
            key = {"fw_closure_grid": "fw_round", "fw_block_pred_grid": "fw_block_pred",
                   "fw_block_grid": "fw_block"}[grid]
            check(launched.get(key) == r_, f"traced {path} B={b}: launches {launched}")
            tile_ms = traced_grid_ms(f"traced {path} B={b}", rows_, r_, grid)
            large[f"{grid} B={b} (device ms a tile)"] = tile_ms
            large[f"{grid} B={b} (device us a step)"] = 1e3 * tile_ms / b
            if path == "main N=8192":
                large[f"fw_update B={b} (device ms a round)"] = traced_grid_ms(
                    f"traced {path} B={b}", rows_, r_, "fw_update")
        large[f"main N=8192 B={b}"] = median_ms(lambda: repro_torch.solve(h8, block_size=b))
    for split in (False, True):
        res = repro_torch.solve(h2, with_pred=True, block_size=512,
                                round_mode="split" if split else "fused")
        want_d, want_p = plain_pred_solve(h2, 512, split)
        torch.cuda.synchronize()
        check(same(res.dist, want_d) and torch.equal(res.pred, want_p),
              f"N=2048 B=512 {'split' if split else 'fused'} pred solve differs from the plain one")
        print(f"N=2048 B=512 {'split' if split else 'fused'} with_pred: dist and pred equal to "
              f"the plain pred solve on the card")
    del h8
    t0 = time.perf_counter()
    h16_np = repro_torch.generate_np(np.random.default_rng(0), 16384, rho=2.0).h
    h16 = torch.from_numpy(h16_np).to(dev)
    print(f"N=16384 graph made and uploaded in {time.perf_counter() - t0:.1f} s")
    for b in (256, 512):
        fr.rounds = 0
        large[f"main N=16384 B={b}"] = median_ms(lambda: repro_torch.solve(h16, block_size=b))
        check(fr.rounds == 4 * 16384 // b, f"N=16384 B={b}: {fr.rounds} rounds in 4 solves")
    d16 = repro_torch.solve(h16, block_size=512).dist
    check(same(d16, repro_torch.solve(h16).dist), "N=16384: B=512 dist differs from B=256's")
    del d16
    rows16, busy16, window16, launched = device_breakdown(
        "one solve, main N=16384 B=512", lambda: repro_torch.solve(h16, block_size=512))
    check(launched == {"fw_round": 32}, f"traced N=16384 B=512: launches {launched}")
    large["closure us a step N=16384 B=512"] = 1e3 * traced_grid_ms(
        "traced main N=16384 B=512", rows16, 32, "fw_closure_grid") / 512
    large["busy share N=16384 B=512"] = busy16 / window16
    print(f"N=16384: B=512 dist equal to the B=256 solve's; solve ms (median of 3) and the "
          f"grid closure on {card}: {json.dumps(large)}")

    elapsed("phase 4")
    # 4. The times (fw_round a round, every solve path's median) and the
    # device breakdown of one main, pred and split solve (device rows only:
    # kernels, memcpy, memset), each grid counted against the path's rounds.
    h_np, rounds = results[8192][:2]
    h_dev = torch.from_numpy(h_np).to(dev)
    measured = timings(repro_torch, h_dev)
    traces = measured["traces"]
    # Each traced solve's launches by the counters equal its plan exactly;
    # the profiler's count of each kernel's grids is printed beside them
    # (it can lose a grid, PERF.md §7), and a grid's ms is read only where
    # the profiler saw at least one and no more than were launched.
    per_kernel, busy, window = traces["main N=8192"][:3]
    plans = {"main N=8192": {"fw_round": rounds},
             "with_pred N=8192": {"fw_block_pred": rounds, "minplus_pred": 2 * rounds},
             "split N=8192": {"fw_block": rounds, "minplus": 3 * rounds},
             "split with_pred N=8192": {"fw_block_pred": rounds, "minplus_pred": 3 * rounds}}
    grids_of = {"fw_round": ("fw_closure", "fw_panels", "fw_colpanel", "fw_update")}
    for path, plan in plans.items():
        launched = traces[path][3]
        check(launched == plan, f"traced {path} solve: launches {launched}, expected {plan}")
        seen = {g_: grid_count(traces[path][0], g_) for k_ in plan for g_ in grids_of.get(k_, (k_,))}
        print(f"traced {path} solve: launches {json.dumps(launched)} equal the plan (counters); "
              f"grids the profiler recorded {json.dumps(seen)}")
    grids = {k: grid_count(per_kernel, k) for k in grids_of["fw_round"]}
    grid_launches_per_round = sum(grids.values()) / rounds
    round_grid_ms = {k: traced_grid_ms("traced main N=8192 solve", per_kernel, rounds, k)
                     for k in grids}
    # The pred rule runs in minplus_pred's epilogue: no gather row is left.
    for path in ("with_pred N=8192", "split with_pred N=8192"):
        gathers = [name for name in traces[path][0] if "gather" in name.lower()]
        check(not gathers, f"{path}: the trace still holds gather rows {gathers}")
    print("pred and split pred traces: no gather rows")

    elapsed("phase 6")
    # 6 (run here, before the kernels line). The dynamic engine at N = 8192.
    lane_rate = bounds().lane_rate(sms, clock_mhz)
    dynamic_launches, dynamic_ms, row_close_err = drive_dynamic(dev, card)
    path_launches["dynamic N=8192"] = dynamic_launches

    # The row-close pass at r in ROW_CLOSE_R on the N = 8192 graph: each
    # mode against its bounds, and one pass with preds traced: it launches
    # row_close_pred and no row_close_argmin, and holds no gather or where
    # row (the pred rule runs in the kernel's epilogue).
    rc = kernel_module("row_close")
    n = 8192
    rc_times = row_close_times(h_dev)
    by_shape = {}
    for r, t_ in rc_times.items():
        for mode in ROW_CLOSE_MODES:
            w = bounds().row_close_work(mode, r, n)
            ops_k, bytes_k = w.ops_ms(lane_rate), w.bytes_ms()
            by_shape[f"{mode} r={r}"] = {
                "ms": t_[f"{mode} kernel"], "call_ms": t_[mode],
                "bound_ms": max(ops_k, bytes_k),
                "bound_by": "operations" if ops_k >= bytes_k else "bytes",
                "bound_ops_ms": ops_k, "bound_bytes_ms": bytes_k,
                "share_of_bound": max(ops_k, bytes_k) / t_[f"{mode} kernel"]}
        by_shape[f"pass r={r}"] = {"ms": t_["pass"]}
        by_shape[f"pass with preds r={r}"] = {"ms": t_["pass with preds"]}
    for k_, v in by_shape.items():
        print(f"row_close {k_} N={n} on {card}: {json.dumps(v)}")
    perm = np.random.default_rng(5).permutation(n)
    rows = torch.from_numpy(np.sort(perm[:1024]).astype(np.int32)).to(dev)
    p_dev = init_pred(h_dev)
    rc.launches.update(dict.fromkeys(rc.launches, 0))
    ops.row_restricted_close(h_dev, rows, pred=p_dev)
    torch.cuda.synchronize()
    check(rc.launches == {"row_close": 0, "row_close_argmin": 0, "row_close_pred": 1},
          f"a row_restricted_close pass with preds launched {rc.launches}")
    pass_rows, _, _, launched = device_breakdown(
        "one row_restricted_close pass with preds, r=1024",
        lambda: ops.row_restricted_close(h_dev, rows, pred=p_dev))
    check(launched == {"row_close_pred": 1}, f"the traced pass with preds launched {launched}")
    bad = [name for name in pass_rows if "gather" in name.lower() or "where" in name.lower()]
    check(not bad, f"the traced pass with preds holds gather or where rows {bad}")
    print(f"row_restricted_close with preds: launches row_close_pred only; its trace holds "
          f"no gather or where row; row_close_pred grid in the trace: "
          f"{grid_count(pass_rows, 'row_close_pred')}")
    main_mode = "row_close_pred r=1024"
    plain_pred = median_ms(lambda: rc.row_close_pred_torch(h_dev, rows, p_dev), reps=1)
    row_close_entry = {
        "name": "row_close",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/row_close.cu",
        "replaces": "src/repro/kernels/row_close.py:82",
        "launches": sum(dynamic_launches[m] for m in ROW_CLOSE_MODES),
        "launches_by_mode": {m: dynamic_launches[m] for m in ROW_CLOSE_MODES},
        "max_abs_err": row_close_err,
        "ms": by_shape[main_mode]["ms"],
        "plain_ms": plain_pred,
        "bound_ms": by_shape[main_mode]["bound_ms"],
        "bound_by": by_shape[main_mode]["bound_by"],
        "instructions_per_candidate": 4,
        "bound_clock_mhz": clock_mhz,
        "library_ms": None,
        "shape": f"N={n} r=1024 row_close_pred (device ms of its grids)",
        "other_shapes_ms": by_shape,
        "card": card,
    }

    elapsed("phase 7")
    # 7 (run here, before the kernels line). The paper's evaluation: its
    # corpus through solve_batch, each method at full width, the kernels on
    # the new shapes.
    paper_launches, paper_errs, paper_times = drive_paper(card, h16,
                                                          large["main N=16384 B=256"])
    del h16
    path_launches.update(paper_launches)
    err = max(err, paper_errs.pop("fw_round"))
    for kind, e in paper_errs.items():
        errs[kind] = max(errs[kind], e)

    elapsed("phase 8")
    # 8 (run here, before the kernels line). The serving tier: serve_apsp,
    # the pool on N = 8192 slots with and without chaos, the batched drain,
    # engine checkpoints.
    serving_launches, serving_errs, serving_times, serving_extra = drive_serving(
        card, scratch, lane_rate)
    path_launches.update(serving_launches)
    for kind, e in serving_errs.items():
        errs[kind] = max(errs[kind], e)
    elapsed("phase 9")
    # 9 (run here, before the kernels line). The GNN training path:
    # spd_features on the minplus kernel, the three GNN configs, launch.train.
    training_launches, training_times, training_extra = drive_training(
        card, scratch, h_dev, lane_rate)
    path_launches.update(training_launches)
    for kind, entries in training_extra.items():
        serving_extra.setdefault(kind, {}).update(entries)
    row_close_entry["launches_by_path"] = {
        lbl: {m: c[m] for m in ROW_CLOSE_MODES if c.get(m)}
        for lbl, c in path_launches.items() if any(c.get(m) for m in ROW_CLOSE_MODES)}
    elapsed("phase 10")
    # 10 (run here, before the kernels line). NequIP at its published config
    # on the molecule cell; the distributed solvers on the N = 8192 graph,
    # minplus and fw_block on every rank.
    nequip_times = drive_nequip(card, scratch)
    dist_launches, dist_times, dist_extra = drive_distributed(
        card, scratch, results[8192][0], results[8192][2], lane_rate, compare_new)
    path_launches.update(dist_launches)
    for kind, entries in dist_extra.items():
        serving_extra.setdefault(kind, {}).update(entries)
    print(f"phase 10 on {card}: {nequip_times['phase_s'] + dist_times['phase_s']:.1f} s; "
          f"{json.dumps({'10a': nequip_times, '10b': dist_times})}")
    elapsed("phase 11")
    # 11 (run here, before the kernels line). The LM and MIND substrate:
    # qwen2-1.5b serving and training, deepseek-v2-236b cut to 2 layers,
    # MIND's four cells, the CLIs, the compressed step on four gloo ranks.
    drive_substrate(card, scratch)

    elapsed("phase 5")
    # 5. The plain version's time, the bound and the kernels line.
    n, b = 8192, 256
    round_ms, solves = measured["round_ms"], measured["solve_ms"]
    fr.fw_round_torch(h_dev, n // 2, block_size=b)
    plain_ms = [cuda_ms(lambda: fr.fw_round_torch(h_dev, n // 2, block_size=b))
                for _ in range(3)]
    # Least time for one round: each candidate x ⊗ y folded by ⊕ is two FP32
    # instructions, over N*N*B (update) + N*B*B (col') + B^3 (closure)
    # candidates, at one instruction per lane a cycle; against reading and
    # writing D once.
    w = bounds().fw_round_work(1, n, b, h_dev.element_size())
    ops_ms, bytes_ms = w.ops_ms(bounds().lane_rate(sms, clock_mhz)), w.bytes_ms()
    bound_ms = max(ops_ms, bytes_ms)
    line = {
        "name": "fw_round",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fw_round.cu",
        "replaces": "src/repro/kernels/fw_round.py:65",
        "launches": rounds,
        "rounds": rounds,
        "grid_launches_per_round": grid_launches_per_round,
        "max_abs_err": err,
        "ms": statistics.median(round_ms),
        "solve_ms": solves["main N=8192"],
        "plain_ms": statistics.median(plain_ms),
        "bound_ms": bound_ms,
        "bound_solve_ms": bound_ms * rounds,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bound_clock_mhz": clock_mhz,
        "library_ms": None,
        "launches_by_path": {lbl: c["fw_round"] for lbl, c in path_launches.items()
                             if c.get("fw_round")},
        "shape": f"N={n} B={b} G=1 {str(h_dev.dtype).replace('torch.', '')}",
        "grid_ms": round_grid_ms,
        "closure": {"grid": "fw_closure", "cluster": path_clusters["main N=8192"]["fw_closure"],
                    "ms": round_grid_ms["fw_closure"],
                    "ms_per_step": round_grid_ms["fw_closure"] / b},
        "other_shapes_ms": {k_: v for k_, v in large.items()
                            if not k_.startswith(("fw_block_grid", "fw_block_pred_grid",
                                                  "busy"))},
        "device_busy_share N=16384 B=512": large["busy share N=16384 B=512"],
        "device_busy_share": busy / window,
        "card": card,
    }
    print(f"fw_round on {card}: {line['ms']:.4f} ms a round (median of "
          f"{len(round_ms)}; grids {json.dumps(round_grid_ms)} ms a round in the traced solve; "
          f"closure on a cluster of {line['closure']['cluster']} CTAs read from the card, "
          f"{1e3 * line['closure']['ms_per_step']:.3f} us a step), "
          f"{line['solve_ms']:.3f} ms a solve (median of 3), bound "
          f"{bound_ms:.4f} ms a round by {line['bound_by']} at {clock_mhz:g} MHz "
          f"(operations {ops_ms:.4f} ms, bytes {bytes_ms:.4f} ms), plain "
          f"{line['plain_ms']:.3f} ms a round")

    # The slice-2 kernels at the main path's shapes (N = 8192, B = 256, the
    # pivot at N/2), each against its least time: instructions a candidate
    # (minplus: ⊗ and ⊕; a witness: ⊗, compare and two selects) over the
    # card's FP32 issue rate, against each input read once and each output
    # written once.
    o = n // 2
    col = h_dev[:, o:o + b].contiguous()
    row = h_dev[o:o + b, :].contiguous()
    piv = h_dev[o:o + b, o:o + b].contiguous()
    ppiv = init_pred(h_dev)[o:o + b, o:o + b].contiguous()
    rk = bounds()
    work = {   # kind: (args, work, shape)
        "minplus": ((col, row, h_dev), rk.minplus_work(1, n, b, n, accumulate=True),
                    f"{n}x{b} x {b}x{n} accumulate (split round, full update)"),
        "minplus_argmin": ((col, row, h_dev),
                           rk.minplus_work(1, n, b, n, mode="minplus_argmin", accumulate=True),
                           f"{n}x{b} x {b}x{n} accumulate (pred round, stage 3)"),
        "fw_block": ((piv[None],), rk.fw_block_work(1, b), f"T=1 B={b}"),
        "fw_block_pred": ((piv[None], ppiv[None]), rk.fw_block_work(1, b, pred=True),
                          f"T=1 B={b}"),
    }
    # The rank-k shapes of the dynamic engine: (n, K) x (K, n) accumulate
    # into the state, K the padded batch width.
    rank_k = {k_: ((h_dev[:, :k_] + 7.0).contiguous(), h_dev[k_:2 * k_, :].contiguous(), h_dev)
              for k_ in (4, 16)}
    other_shapes = {
        "minplus": {"row panel 256x256 x 256x8192": (piv, row),
                    "column panel 8192x256 x 256x256": (col, piv),
                    **{f"rank-k {n}x{k_} x {k_}x{n} accumulate": a_
                       for k_, a_ in rank_k.items()}},
        "minplus_argmin": {"stage 2 8192x256 x 256x256 accumulate": (col, piv, col),
                           **{f"rank-k {n}x{k_} x {k_}x{n} accumulate": a_
                              for k_, a_ in rank_k.items()}},
    }
    # minplus_pred, the witness kernel with the pred epilogue, at the pred
    # round's stages 3 and 2 (stage 2 on strided panels of the state, as the
    # round passes them).
    p_dev = init_pred(h_dev)
    pred_shapes = {
        f"minplus_pred stage 3 {n}x{b} x {b}x{n} accumulate":
            (col, row, p_dev[:, o:o + b], p_dev[o:o + b, :], h_dev, p_dev, o, 0),
        f"minplus_pred stage 2 {n}x{b} x {b}x{b} accumulate":
            (h_dev[:, o:o + b], piv, p_dev[:, o:o + b], ppiv, h_dev[:, o:o + b],
             p_dev[:, o:o + b], o, o),
    }
    for lbl, (*a_, ko, jo) in pred_shapes.items():
        compare_new("minplus_pred", f"{lbl} (main path's shape)", *a_, k_offset=ko, j_offset=jo)
    path_of = {"minplus": "split N=8192", "minplus_argmin": "with_pred N=8192",
               "fw_block": "split N=8192", "fw_block_pred": "with_pred N=8192"}
    sources = {"minplus": ("minplus.cu", "minplus.py:235"),
               "minplus_argmin": ("minplus.cu", "minplus.py:284"),
               "fw_block": ("fw_block.cu", "fw_block.py:34"),
               "fw_block_pred": ("fw_block.cu", "fw_block.py:67")}
    lines = [line]

    def family(counts_, kind):
        """Launches of a kernel's entry on a path: minplus_argmin's witness
        kernel runs in its pred mode (minplus_pred) on the pred paths."""
        names = (kind, "minplus_pred") if kind == "minplus_argmin" else (kind,)
        return sum(counts_.get(k_, 0) for k_ in names)

    for kind, (args, w, shape) in work.items():
        cuda_fn, plain_fn = pairs[kind]
        compare_new(kind, f"{shape} (main path's shape)", *args)
        for lbl, a_ in other_shapes.get(kind, {}).items():
            compare_new(kind, f"{lbl} (main path's shape)", *a_)
        k_ms = median_ms(lambda: cuda_fn(*args), reps=10)
        p_ms = median_ms(lambda: plain_fn(*args), reps=3)
        ops_k, bytes_k = w.ops_ms(lane_rate), w.bytes_ms()
        entry = {
            "name": kind,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[kind][0]}",
            "replaces": f"src/repro/kernels/{sources[kind][1]}",
            "launches": family(path_launches[path_of[kind]], kind),
            "launches_by_path": {lbl: {k_: v for k_, v in c.items()
                                       if k_ in (kind, "minplus_pred" if kind == "minplus_argmin"
                                                 else kind)}
                                 for lbl, c in path_launches.items() if family(c, kind)},
            "max_abs_err": errs[kind],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(ops_k, bytes_k),
            "bound_by": "operations" if ops_k >= bytes_k else "bytes",
            "instructions_per_candidate": w.instructions,
            "bound_clock_mhz": clock_mhz,
            "library_ms": None,
            "shape": shape,
            "other_shapes_ms": {lbl: median_ms(lambda a_=a_: cuda_fn(*a_), reps=10)
                                for lbl, a_ in other_shapes.get(kind, {}).items()},
            "solve_ms": solves[path_of[kind]],
            "device_busy_share": traces[path_of[kind]][1] / traces[path_of[kind]][2],
            "card": card,
        }
        if kind.startswith("fw_block"):
            # CUDA events around one wrapper call count its host time too;
            # the traced solve's rows give the kernel's own device time.
            device = traced_grid_ms(f"traced {path_of[kind]} solve", traces[path_of[kind]][0],
                                    rounds, kind)
            entry["cluster"] = path_clusters[path_of[kind]][kind]
            entry["device_ms"] = device
            entry["ms_per_step"] = device / b
            # The grid closure (B > 256): its device time in the traced
            # B = 512 and 1024 solves (phase 3c).
            entry["other_shapes_ms"].update(
                {k_: v for k_, v in large.items() if k_.startswith(f"{kind}_grid ")})
        else:
            # Device ms a launch of each product grid in the path's traced
            # solve (the split solve's full updates and panels; the pred
            # solve's stages 2 and 3 together), and of the k-major copy.
            grids_ = (kind, "minplus_pred") if kind == "minplus_argmin" else (kind,)
            entry["device_ms_in_solve"] = {
                name.split("repro_torch::", 1)[1].split("(", 1)[0]: ms / count
                for name, (ms, count) in traces[path_of[kind]][0].items()
                if any(f"repro_torch::{g_}<" in name for g_ in grids_)
                or "repro_torch::kmajor(" in name}
        for lbl, v in serving_extra.get(kind, {}).items():
            entry["other_shapes_ms"][lbl] = v["ms"]
            entry[f"bound_ms {lbl}"] = v["bound_ms"]
        if kind == "minplus_argmin":
            for lbl, (*a_, ko, jo) in pred_shapes.items():
                entry["other_shapes_ms"][lbl] = median_ms(
                    lambda: mp.minplus_pred_cuda(*a_, k_offset=ko, j_offset=jo), reps=10)
            entry["bound_ms stage 2"] = rk.minplus_work(
                1, n, b, b, mode="minplus_argmin", accumulate=True).ops_ms(lane_rate)
        lines.append(entry)
        print(f"{kind} on {card}: {k_ms:.4f} ms at {shape} (median of 10), bound "
              f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} (operations {ops_k:.4f} ms "
              f"at {w.instructions} instructions a candidate, bytes {bytes_k:.4f} ms), plain "
              f"{p_ms:.3f} ms; other shapes {entry['other_shapes_ms']}")
    lines.append(row_close_entry)
    print(f"solve ms at N=8192 (median of 3): {json.dumps(solves)}")
    print(f"dynamic update ms at N=8192 by path (medians): "
          f"{json.dumps({k: v['median_ms'] for k, v in dynamic_ms.items() if 'median_ms' in v})}")
    elapsed("phase 12")
    # 12 (run here, before the kernels line). The dry run of every cell on
    # both production meshes, and real steps on a 1 x 1 mesh against it.
    drive_dryrun(card, dry_proc, dry_log, scratch / "dryrun")

    elapsed("phase 13")
    # 13 (run here, before the kernels line). The port's invariant checkers:
    # the analysis CLI with the lattice through the CUDA kernels, the C entry
    # points refusing defective plans, and the donation check at full size.
    drive_analysis(card, torch.from_numpy(h16_np).to(dev))

    elapsed("the kernels line")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--times":
        sys.exit(times(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--profiler-study"] and len(sys.argv) <= 3:
        sys.exit(profiler_study(Path(sys.argv[2]) if len(sys.argv) == 3
                                else ROOT / "build" / "profiler_study.json"))
    sys.exit(main())
