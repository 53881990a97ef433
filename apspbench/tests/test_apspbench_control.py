"""The control of every cell: the program with its bfloat16 storage
switched on (``dtype=torch.bfloat16``), the nearest precision below the
configurations' float32, must come out not correct, at each cell's own
size, on three seeds.  The updates cell has one more: an engine whose
worsening phase leaves its state stale must read ``rows_off`` above its
limit on three seeds.

Needs the card (marker ``cuda``); on the chip, from the repo root:

    python -m pytest -q -m cuda apspbench/tests/test_apspbench_control.py -s

Each run prints its compared numbers beside their limits, the readings
that ``PERF.md`` sets the limits from.
"""

import json
import sys
import time

import pytest
import torch

from apspbench import run, spec
from apspbench.tests.test_apspbench_harness import Program, StaleEngine

SEEDS = (2_300_000_011, 2_300_000_013, 2_300_000_017)
# a short window at the cell's own load: it finishes several steps, and the
# rows kept of each are judged as in a run
SECONDS = 4.0


class LowerPrecision:
    """The program with its bfloat16 storage mode on: bf16 state, float32
    arithmetic (``solve``'s ``dtype``)."""

    def __init__(self, program):
        self.program = program

    def solve(self, h, **kw):
        return self.program.solve(h, dtype=torch.bfloat16, **kw)

    def solve_batch(self, hs, sizes=None, **kw):
        return self.program.solve_batch(hs, sizes, dtype=torch.bfloat16, **kw)

    def DynamicAPSP(self, h, **kw):
        return self.program.DynamicAPSP(h, dtype=torch.bfloat16, **kw)



@pytest.fixture(scope="module")
def program():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run only on the card")
    run.pin_environment(spec.ROOT)
    sys.path.insert(0, str(spec.ROOT / "src"))
    import repro_torch
    from repro_torch.kernels import _build

    _build.build(_build.sources())
    return repro_torch


def control_runs(control, workload):
    bench = spec.load()
    wl = spec.cell(bench, workload)
    cfg = spec.config(bench, wl["config"])
    traffic = spec.traffic(wl["traffic"])
    for seed in SEEDS:
        result, rec = run.run_cell(control, bench, workload, cfg, traffic, seed, SECONDS, False,
                                   "cuda", time.perf_counter())
        print(f"control {workload} seed {seed}: steps {rec['steps']} "
              f"correct {result['correct']} checks {json.dumps(result['checks'])}")
        torch.cuda.empty_cache()
        yield result, rec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load()["workloads"]])
def test_lower_precision_is_not_correct(program, workload):
    for result, rec in control_runs(LowerPrecision(program), workload):
        assert rec["steps"] > 0
        assert result["correct"] is False


@pytest.mark.cuda
def test_stale_engine_is_not_correct(program):
    for result, rec in control_runs(Program(DynamicAPSP=StaleEngine), "gen32k.updates"):
        assert rec["steps"] > 0
        assert result["checks"]["rows_off"]["value"] > 0
