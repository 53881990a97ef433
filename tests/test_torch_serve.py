"""The port's serving driver (``repro_torch.launch.serve``) on the CPU:
``serve_apsp`` for every method, ``serve_apsp_dynamic`` with and without
chaos, sync and async, its pool summary against the JAX driver's on the
same seeded run, the CLI in a subprocess, and the request recasts against
the JAX driver's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.graphgen import generate_np
from repro.launch import serve as jax_serve
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
SUMMARY_KEYS = ("pool", "slots", "states", "faults_injected", "transitions", "recoveries",
                "live_bytes", "mem_budget_bytes")
# tests/test_resilience.py::test_serve_apsp_dynamic_chaos_smoke_exit_zero's run
CHAOS_ARGS = dict(n_max=16, graphs=2, mutate_rate=0.5, mutate_k=3, verify_every=8, seed=3,
                  fault_spec="nan:0.2,crash:0.1:3,poison:0.1", deadline_ms=200.0,
                  backlog_watermark=3)

pytestmark = pytest.mark.resilience


@pytest.fixture(autouse=True)
def _own_autotune_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port-autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax-autotune.json"))


@pytest.mark.parametrize("method,with_pred", [
    ("squaring", False), ("blocked_fw", False), ("blocked_fw", True), ("rkleene", False),
])
def test_serve_apsp_exit_zero(method, with_pred, capsys):
    got = {}
    rc = serve.serve_apsp(8, batch=4, n_max=16, method=method, with_pred=with_pred,
                          device="cpu", summary_out=got)
    assert rc == 0
    assert got["graphs"] == 8 and got["graphs_per_s"] > 0 and got["steady_graphs_per_s"] > 0
    out = capsys.readouterr().out
    assert "[done] 8 graphs" in out and "device=cpu" in out
    assert "[autotune]" in out


def test_serve_apsp_tunes_the_round_of_a_blocked_server(tmp_path, capsys):
    from repro_torch.kernels import autotune

    serve.serve_apsp(4, batch=4, n_max=16, method="blocked_fw", device="cpu")
    assert autotune.lookup_fw_round("torch", torch.float32, 16)
    assert "measured" in capsys.readouterr().out


def test_serve_apsp_with_no_elapsed_time(monkeypatch, capsys):
    """Two equal clock reads around an empty stream give a rate, not a
    ZeroDivisionError."""
    monkeypatch.setattr(serve.time, "time", lambda: 1000.0)
    assert serve.serve_apsp(0, batch=4, n_max=16, method="classic", device="cpu") == 0
    assert "[done] 0 graphs, 0.0 graphs/s end-to-end" in capsys.readouterr().out


@pytest.mark.parametrize("semiring", ["bottleneck", "reliability", "boolean"])
def test_serve_apsp_other_semirings(semiring):
    assert serve.serve_apsp(4, batch=4, n_max=12, method="squaring", semiring=semiring,
                            device="cpu") == 0


def test_serve_apsp_dynamic_chaos_smoke_exit_zero():
    assert serve.serve_apsp_dynamic(24, device="cpu", **CHAOS_ARGS) == 0


def test_serve_apsp_dynamic_summary_matches_jax(capsys):
    """The same seeded run through both drivers (no deadline, so no timing
    enters a decision): the same pool summary, bar the recovery times."""
    args = dict(CHAOS_ARGS, deadline_ms=0.0)
    got = {}
    assert serve.serve_apsp_dynamic(24, device="cpu", summary_out=got, **args) == 0
    capsys.readouterr()
    assert jax_serve.serve_apsp_dynamic(24, **args) == 0
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[pool] "))
    want = json.loads(line[len("[pool] "):])
    for key in SUMMARY_KEYS:
        assert json.loads(json.dumps(got["summary"][key], sort_keys=True)) == want[key], key
    assert got["n_updates"] + got["n_queries"] == 24 and got["verify_drift"] == 0
    assert got["ms_per_submit_drain"] >= 0 and got["ms_per_query"] >= 0


def test_serve_apsp_dynamic_async_durable_correlated_chaos():
    rc = serve.serve_apsp_dynamic(
        24, n_max=12, graphs=3, mutate_rate=0.6, mutate_k=4, verify_every=8, seed=1,
        fault_spec="backend_loss:0.3:6,cache_storm:0.2:8,crash_restore:0.25",
        async_updates=True, durability_dir="auto", checkpoint_every=4, device="cpu")
    assert rc == 0


def test_serve_apsp_dynamic_with_pred_and_budget():
    rc = serve.serve_apsp_dynamic(
        24, n_max=16, graphs=3, mutate_rate=0.5, mutate_k=4, verify_every=6,
        with_pred=True, mem_budget_mb=2 * 16 * 16 * 8 / 2**20, device="cpu")
    assert rc == 0


def test_crash_restore_needs_a_durability_dir():
    with pytest.raises(ValueError, match="durability"):
        serve.serve_apsp_dynamic(4, n_max=12, fault_spec="crash_restore:0.5", device="cpu")


@pytest.mark.parametrize("argv", [
    ["--requests", "8", "--batch", "4", "--n-max", "16", "--method", "blocked_fw"],
    ["--requests", "24", "--n-max", "16", "--graphs", "2", "--mutate-rate", "0.5",
     "--mutate-k", "3", "--verify-every", "8", "--seed", "3",
     "--fault-spec", "nan:0.2,crash:0.1:3,poison:0.1", "--deadline-ms", "200",
     "--backlog-watermark", "3"],
])
def test_cli_on_the_cpu_exit_zero(tmp_path, argv):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "apsp",
         "--device", "cpu", *argv],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[done]" in out.stdout


@pytest.mark.parametrize("arch", ["mind", "qwen2-1.5b", "deepseek-v2-236b", "arctic-480b"])
def test_lm_and_mind_modes_serve_on_the_cpu(arch, capsys):
    """The JAX driver's LM and MIND modes: ``--requests 4 --gen 6`` through
    prefill and greedy decode, or 4 users' interests and one retrieval."""
    assert serve.main(["--arch", arch, "--device", "cpu", "--requests", "4", "--gen", "6"]) == 0
    out = capsys.readouterr().out
    if arch == "mind":
        assert "[serve] 4 users -> interests (4, 4, 16)" in out and "[retrieval] top-10" in out
    else:
        assert "prompt 16 -> +6 tokens" in out and "[done] 4 requests" in out


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "apsp", "--requests", "4", "--batch", "4", "--n-max", "8"])


@pytest.mark.parametrize("semiring", serve.RECASTABLE)
def test_recasts_are_the_jax_ones(semiring):
    h = generate_np(np.random.default_rng(2), 20, rho=40.0).h
    assert np.array_equal(serve._recast_graph(h, semiring),
                          jax_serve._recast_graph(h, semiring))
    w = np.array([1.0, 5.0, 99.0], np.float32)
    if semiring != "tropical":
        assert np.array_equal(serve._recast_edge_weights(w, semiring),
                              jax_serve._recast_edge_weights(w, semiring))
    assert serve.RECASTABLE == jax_serve.RECASTABLE


def test_unrecastable_semiring_fails_fast():
    with pytest.raises(ValueError, match="recast"):
        serve.serve_apsp(4, semiring="nope", device="cpu")
