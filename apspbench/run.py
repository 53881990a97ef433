"""Run one cell of the benchmark once, on the card, and print its result.

    python3 -m apspbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The program under test is ``repro_torch``
(``src/repro_torch``), driven through ``solve``, ``solve_batch`` and
``DynamicAPSP``; nothing here imports JAX or the JAX package.

Set-up (``setup_s``) runs from the start of this process to the first
timed step: the imports, the kernels' build where they are not built yet,
the inputs made on the card from the seed, and a warm-up of every shape the
window will use; seconds that a loop spent in the plain reference to draw
its inputs (``reference_s``) are left out of it.  The window is a closed
loop that runs whole steps until ``--seconds`` have passed, and whole
cycles where the loop has them (``cycle_steps``); each step ends in a
device synchronise.  The traffic file's ``kind`` names the loop,
``kinds/<kind>.py``.  After the
window, the peak memory is read, the program's state is dropped, and the
steps' answers are judged against the plain reference (``reference/``).
With ``--trace 1`` the first steps run under ``torch.profiler`` and the
result carries the per-layer metrics, ``busy_s`` / ``window_s`` and a
breakdown.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Exit codes: 0 a result was printed; 2 no card, too few cards, or the
program or a file of the benchmark missing; 3 JAX or the JAX package was
loaded in this process by the time the result was due (after the window,
the judgement and every metric reader), and no result is printed.

``--record <file>`` also writes the run's record, what the metric readers
read, as JSON: the recorded traces under ``tests/fixtures/`` are such
records of traced runs on the card, each gzipped beside the line the run
printed (``{"record": ..., "printed": ...}``).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Optional, Tuple  # noqa: E402

from . import spec  # noqa: E402

# Top-level module names that must never be loaded in a run.  Compared whole:
# the port's own name starts with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin_environment(root) -> None:
    """The program's caches inside the checkout: its kernels build under
    ``build/repro_torch/`` (``repro_torch.kernels._build``), and its
    autotune cache is a file of the harness's own state directory that the
    harness never writes, so every run dispatches the compiled-in
    defaults."""
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(root / "build" / "apspbench" / "autotune.json")


def launch_counts():
    """The program's launch counters, by kernel."""
    out = {"fw_round": importlib.import_module("repro_torch.kernels.fw_round").rounds}
    for name in ("minplus", "fw_block", "row_close"):
        out.update(importlib.import_module(f"repro_torch.kernels.{name}").launches)
    return out


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def measure(loop, seconds: float, trace_plan: Optional[dict], device) -> dict:
    """The window: whole steps until ``seconds`` have passed, ending on a
    whole cycle of the loop's ``cycle_steps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace
    from .kinds import sync

    prof, traced = None, None
    if trace_plan is not None:
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        lead, last = int(trace_plan["lead"]), int(trace_plan["lead"]) + int(trace_plan["steps"])
        prof.start()
    cycle = getattr(loop, "cycle_steps", 1)
    step_ms = []
    before = launch_counts()
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        with record_function(trace.STEP_SPAN):
            loop.step(i)
            sync(device)
        e = time.perf_counter()
        step_ms.append((e - s) * 1e3)
        i += 1
        if prof is not None and i >= last:
            prof.stop()
            traced, prof = trace.capture(prof, lead), None
        if e - t0 >= seconds and i % cycle == 0:
            break
    window = e - t0
    if prof is not None:
        prof.stop()
        traced = trace.capture(prof, lead)
    after = launch_counts()
    return {"window_s": window, "steps": i, "step_ms": step_ms,
            "counters": {k: after[k] - before[k] for k in after}, "trace": traced}


def run_cell(program, bench: dict, workload: str, cfg: dict, traffic: dict, seed: int,
             seconds: float, trace_on: bool, device, t_start: float) -> Tuple[dict, dict]:
    """One run of a cell: set-up, window, judgement.  Returns the result
    (the printed line) and the record the metric readers read."""
    import torch

    from . import kinds, peaks, trace

    loop = kinds.load(traffic["kind"])(program, cfg, traffic, seed, device)
    loop.warm()
    kinds.sync(device)
    reference_s = getattr(loop, "reference_s", 0.0)
    setup_s = time.perf_counter() - t_start - reference_s
    rec = measure(loop, seconds, traffic["trace"] if trace_on else None, device)
    cuda = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if cuda else torch.device(device).type,
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(0) if cuda else 0}
    rec.update(setup_s=setup_s, reference_s=reference_s, items_per_step=loop.items_per_step,
               work_per_step=loop.work_per_step, peak_candidates_per_s=peaks.CANDIDATES_PER_S)
    if hasattr(loop, "counters"):
        rec["counters"].update(loop.counters())
    checks = loop.judge()
    correct = rec["steps"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in spec.metrics(bench, workload, per_layer=trace_on):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": rec["steps"], "failed": int(loop.failed),
              "metrics": metrics, "device": dev_info}
    if trace_on and rec["trace"] is not None:
        dev_info["busy_s"] = trace.busy_s(rec["trace"])
        dev_info["window_s"] = trace.window_s(rec["trace"])
        result["breakdown"] = trace.breakdown(rec["trace"])
    result["checks"] = checks
    return result, rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", default=None,
                    help="also write the run's record (what the metric readers read) here; "
                         "the way the recorded traces under tests/fixtures/ are made")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    root = spec.ROOT
    pin_environment(root)
    import torch

    try:
        bench = spec.load(root)
        wl = spec.cell(bench, args.workload)
        cfg = spec.config(bench, wl["config"], root)
        traffic = spec.traffic(wl["traffic"])
    except (OSError, KeyError, ValueError) as e:
        print(f"apspbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"apspbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    try:
        import repro_torch
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"apspbench: the program under test is missing: {e}", file=sys.stderr)
        return 2
    _build.build(_build.sources())
    result, rec = run_cell(repro_torch, bench, args.workload, cfg, traffic, args.seed,
                           args.seconds, bool(args.trace), "cuda", T_PROCESS)
    return report(result, rec, args, card_line())


def report(result: dict, rec: dict, args, card: str) -> int:
    """Print the run's result, unless JAX or the JAX package is loaded by
    now: the window, the judgement and every metric reader have run."""
    found = forbidden_loaded()
    if found:
        print(f"apspbench: modules loaded that a run must not load: {found}", file=sys.stderr)
        return 3
    if args.record:
        with open(args.record, "w") as f:
            json.dump(rec, f)
    print(f"apspbench: {args.workload} seed {args.seed} on {card}: {rec['steps']} steps in "
          f"{rec['window_s']:.3f} s, set-up {rec['setup_s']:.3f} s (and "
          f"{rec['reference_s']:.3f} s of the reference's in it, left out)", file=sys.stderr)
    print(f"apspbench: counters {json.dumps(rec['counters'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} <= {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
