"""Whole runs of every cell on the CPU at a small size, past the harness's
look for a card: a sound program comes out correct, and a program broken
under the timed path comes out not correct, once for each fault a cell
can have:

* a step that returns its state unchanged (a solve that hands back its
  input);
* an answer altered where it is produced (one distance off by one, one
  predecessor moved);
* half of the batch left out (the corpus solved for its first half only);
* an update whose worsening phase leaves the engine's state as it was.

The cells run on one chip, so no exchange between chips can be left out.
The command line's own refusals (no card, a missing program, JAX loaded
by the time the result is due) close the file.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from apspbench import run, spec

sys.path.insert(0, str(spec.ROOT / "src"))
import repro_torch  # noqa: E402
from repro_torch.core.apsp import APSPResult, BatchAPSPResult  # noqa: E402

SMALL = {"gen32k": {"V": 64, "rho": 8.0},
         "paper-corpus": {"n_graphs": 10, "v_min": 4, "v_max": 24}}
# the updates cell's table wants strata from no affected source to most of
# them: out-degree 4.9 as at V = 32768, on enough nodes
SMALL_CELL = {"gen32k.updates": {"V": 256, "rho": 200 * 4.9 / 256}}
SEED = 2 ** 31 + 99


def cell_run(workload, program, seconds=0.3, trace=False):
    bench = spec.load()
    wl = spec.cell(bench, workload)
    cfg = {**spec.config(bench, wl["config"]), **SMALL[wl["config"]],
           **SMALL_CELL.get(workload, {})}
    traffic = spec.traffic(wl["traffic"])
    return run.run_cell(program, bench, workload, cfg, traffic, SEED, seconds, trace, "cpu",
                        time.perf_counter())


class Program:
    """The program as the harness sees it, each entry point replaceable."""

    def __init__(self, **over):
        self.solve = over.get("solve", repro_torch.solve)
        self.solve_batch = over.get("solve_batch", repro_torch.solve_batch)
        self.DynamicAPSP = over.get("DynamicAPSP", repro_torch.DynamicAPSP)


def returns_input(h, with_pred=False, **kw):
    n = h.shape[-1]
    pred = torch.full((n, n), -1, dtype=torch.int32) if with_pred else None
    return APSPResult(dist=h.clone(), pred=pred, method="broken")


def one_distance_off(h, **kw):
    r = repro_torch.solve(h, **kw)
    r.dist[1, 2] += 1.0
    return r


def one_pred_moved(h, **kw):
    r = repro_torch.solve(h, **kw)
    r.pred[3, 5] = (r.pred[3, 5] + 1) % h.shape[-1]
    return r


def first_half_only(hs, sizes, **kw):
    r = repro_torch.solve_batch(hs, sizes, **kw)
    g = r.dist.shape[0]
    n = hs.shape[-1]
    dist = r.dist.clone()
    dist[g // 2:] = hs[g // 2:, :n, :n]
    return BatchAPSPResult(dist=dist, pred=r.pred, sizes=r.sizes, method=r.method)


def corpus_one_off(hs, sizes, **kw):
    r = repro_torch.solve_batch(hs, sizes, **kw)
    r.dist[0, 1, 1] += 1.0
    return r


class StaleEngine(repro_torch.DynamicAPSP):
    """Raises the edges in ``h`` and leaves ``dist`` and ``pred`` as they
    were: a worsening phase that returns its state unchanged."""

    def _apply_worsening(self, uw, vw, oldw, info):
        return info


class OneOffEngine(repro_torch.DynamicAPSP):
    """Every update's answer one distance off."""

    def update(self, u, v=None, w=None):
        info = super().update(u, v, w)
        self.dist[1, 2] += 1.0
        return info


CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_program_is_correct(workload, trace):
    result, rec = cell_run(workload, Program(), trace=trace)
    assert result["correct"] is True and result["failed"] == 0 and rec["steps"] > 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in result["checks"].values())
    names = {m["name"] for m in spec.metrics(spec.load(), workload, trace)}
    if trace:
        # the CPU has no device trace and launches no kernel: only the
        # harness's own clocks are read
        assert set(result["metrics"]) <= names
    else:
        assert set(result["metrics"]) == names


FAULTS = [
    ("gen32k.solve", "state unchanged", dict(solve=returns_input)),
    ("gen32k.solve", "answer altered", dict(solve=one_distance_off)),
    ("gen32k.pred", "state unchanged", dict(solve=returns_input)),
    ("gen32k.pred", "answer altered", dict(solve=one_pred_moved)),
    ("corpus.blocked", "half the batch left out", dict(solve_batch=first_half_only)),
    ("corpus.blocked", "answer altered", dict(solve_batch=corpus_one_off)),
    ("gen32k.updates", "state unchanged", dict(DynamicAPSP=StaleEngine)),
    ("gen32k.updates", "answer altered", dict(DynamicAPSP=OneOffEngine)),
]


@pytest.mark.parametrize("workload,fault,over", FAULTS, ids=[f"{w}:{f}" for w, f, _ in FAULTS])
def test_broken_program_is_not_correct(workload, fault, over):
    result, _ = cell_run(workload, Program(**over))
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "apspbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_no_result_once_jax_is_loaded(tmp_path, monkeypatch, capsys):
    """A metric reader that loads JAX (here a stub module named ``jax``)
    runs after the window and the judgement: the run then prints no result
    and exits 3, naming what it found."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "jax", raising=False)

    def loads_jax(rec):
        import jax  # noqa: F401

        return 1.0

    monkeypatch.setitem(spec._readers, "solve_ms", loads_jax)
    result, rec = cell_run("gen32k.solve", Program())
    assert "jax" in sys.modules and result["metrics"]["solve_ms"]["value"] == 1.0
    args = argparse.Namespace(workload="gen32k.solve", seed=SEED, record=None)
    assert run.report(result, rec, args, "cpu") == 3
    out, err = capsys.readouterr()
    assert out == "" and "['jax']" in err
    monkeypatch.delitem(sys.modules, "jax")
    assert run.report(result, rec, args, "cpu") == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"] is True
