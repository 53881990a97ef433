"""The port's autotune cache (``repro_torch.kernels.autotune``) on the CPU:
the JAX package's key families and ``REPRO_AUTOTUNE`` modes, a cache file
of its own, lookups that only read, the fixed plans of the families with no
knob, and the ``fwround`` winner reaching ``core.blocked_fw``'s
``_resolve_round``.  Mirrors ``tests/test_autotune.py``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_autotune
from repro_torch import solve
from repro_torch.core.blocked_fw import _resolve_round
from repro_torch.core.graphgen import generate_np
from repro_torch.core.semiring import TROPICAL
from repro_torch.kernels import autotune


@pytest.fixture
def at_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax-autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    return path


def test_fw_round_tune_roundtrip_no_remeasure(at_cache):
    e1 = autotune.tune_fw_round(48, device="cpu", reps=1, blocks=(16, 32))
    assert e1["source"] == "measured"
    assert e1["params"]["block_size"] in (16, 32)
    assert e1["params"]["round_mode"] in ("fused", "split")
    assert e1["lattice"] == 4 and e1["us"] > 0
    e2 = autotune.tune_fw_round(48, device="cpu", reps=1, blocks=(16, 32))
    assert e2["source"] == "cache" and e2["params"] == e1["params"]
    data = json.loads(at_cache.read_text())
    assert data["schema"] == autotune.SCHEMA
    assert list(data["entries"]) == ["fwround|torch|float32|g0|n64"]


def test_lookup_buckets_backend_and_fallbacks(at_cache):
    e = autotune.tune_fw_round(48, device="cpu", reps=1, blocks=(16, 32))
    got = autotune.lookup_fw_round("torch", torch.float32, 40)     # same bucket (64)
    assert got == e["params"]
    assert autotune.lookup_fw_round("cuda", torch.float32, 40) == {}
    assert autotune.lookup_fw_round("torch", torch.float32, 400) == {}
    assert autotune.lookup_fw_round("torch", torch.bfloat16, 40) == {}
    # batched and non-tropical lookups fall back as the JAX cache's do
    assert autotune.lookup_fw_round("torch", torch.float32, 40, g=4) == got
    assert autotune.lookup_fw_round("torch", torch.float32, 40, semiring="bottleneck") == got
    assert autotune.key_for_fw_round("torch", torch.float32, 48) in autotune.touched_entries()


def test_keys_are_the_jax_families(at_cache):
    for port_dt, jax_dt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for sr in ("tropical", "reliability"):
            assert autotune.key_for("cuda", port_dt, 60, 30, 58, g=3, semiring=sr) == \
                jax_autotune.key_for("cuda", jax_dt, 60, 30, 58, g=3, semiring=sr)
            assert autotune.key_for_fw_round("cuda", port_dt, 1000, semiring=sr) == \
                jax_autotune.key_for_fw_round("cuda", jax_dt, 1000, semiring=sr)
            assert autotune.key_for_row_close("cuda", port_dt, 5, 8192, semiring=sr) == \
                jax_autotune.key_for_row_close("cuda", jax_dt, 5, 8192, semiring=sr)
    assert autotune.key_for_fw_round("cuda", torch.float32, 1024) == "fwround|cuda|float32|g0|n1024"
    assert autotune.bucket(1) == 8 and autotune.bucket(1000) == 1024


def test_disabled_and_force_modes(at_cache, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert autotune.mode() == "off"
    assert autotune.tune_fw_round(48, device="cpu")["source"] == "disabled"
    assert autotune.tune(64, 32, 64, device="cpu")["source"] == "disabled"
    assert autotune.tune_row_close(4, 64, device="cpu")["source"] == "disabled"
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    autotune.tune_fw_round(48, device="cpu", reps=1, blocks=(16,))
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert autotune.lookup_fw_round("torch", torch.float32, 48) == {}
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    assert autotune.mode() == "force"
    e = autotune.tune_fw_round(48, device="cpu", reps=1, blocks=(16,))
    assert e["source"] == "measured"


def test_corrupt_cache_is_ignored(at_cache):
    at_cache.write_text("{not json")
    assert autotune.load_entries(reload=True) == {}
    e = autotune.tune_fw_round(40, device="cpu", reps=1, blocks=(8,))
    assert e["source"] == "measured"
    assert json.loads(at_cache.read_text())["schema"] == autotune.SCHEMA


def test_never_touches_the_jax_cache(tmp_path, monkeypatch):
    """The port reads and writes its own file: an entry in the JAX
    package's cache (its variable, its default path) is never consulted."""
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    jax_cache = tmp_path / "jax.json"
    jax_cache.write_text(json.dumps({"schema": 1, "entries": {
        "fwround|torch|float32|g0|n64": {"params": {"block_size": 8, "round_mode": "split"}}}}))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(jax_cache))
    assert autotune.cache_path() != jax_cache
    assert ".cache/repro/" not in str(autotune.cache_path())
    assert autotune.cache_path().parts[-3:] == ("build", "repro_torch", "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port.json"))
    assert autotune.lookup_fw_round("torch", torch.float32, 48) == {}
    autotune.tune_fw_round(48, device="cpu", reps=1, blocks=(16,))
    assert json.loads(jax_cache.read_text())["entries"].keys() == {"fwround|torch|float32|g0|n64"}
    assert (tmp_path / "port.json").exists()


def test_lookups_never_measure(at_cache, monkeypatch):
    autotune._save({autotune.key_for_fw_round("torch", torch.float32, 64):
                    {"params": {"block_size": 16, "round_mode": "split"}}})

    def boom(*a, **kw):
        raise AssertionError("a lookup measured")

    monkeypatch.setattr(autotune, "measure", boom)
    assert autotune.lookup_fw_round("torch", torch.float32, 64) == {
        "block_size": 16, "round_mode": "split"}
    assert autotune.lookup("torch", torch.float32, 64, 64, 64) == {}
    assert autotune.lookup_row_close("torch", torch.float32, 4, 64) == {}
    h = generate_np(np.random.default_rng(0), 60).h
    solve(h, device="cpu")


@pytest.mark.parametrize("fn,args", [("tune", (64, 32, 64)), ("tune_row_close", (4, 64))])
def test_fixed_plan_families_measure_and_write_nothing(at_cache, monkeypatch, fn, args):
    def boom(*a, **kw):
        raise AssertionError("a fixed plan measured")

    monkeypatch.setattr(autotune, "measure", boom)
    e = getattr(autotune, fn)(*args, device="cpu")
    assert e["source"].startswith("fixed plan") and e["params"]
    assert not at_cache.exists()


def test_resolve_round_reads_the_winner_and_explicit_args_win(at_cache):
    autotune._save({autotune.key_for_fw_round("torch", torch.float32, 40):
                    {"params": {"block_size": 8, "round_mode": "split"}, "source": "measured"}})
    h = torch.zeros(40, 40)
    assert _resolve_round(h, None, None, TROPICAL) == (8, "split")
    assert _resolve_round(h, 16, "fused", TROPICAL) == (16, "fused")
    assert _resolve_round(h, None, "fused", TROPICAL) == (8, "fused")
    # predecessor solves stay on the fused round
    assert _resolve_round(h, None, None, TROPICAL, with_pred=True) == (8, "fused")
    # a (G, n, n) stack looks up its g bucket, then falls back to g = 0
    assert _resolve_round(torch.zeros(3, 40, 40), None, None, TROPICAL) == (8, "split")
    # another bucket misses: the compiled-in defaults
    assert _resolve_round(torch.zeros(300, 300), None, None, TROPICAL) == (256, "fused")


def test_solve_runs_the_tuned_round_and_equals_the_default(at_cache, monkeypatch):
    import importlib

    ops = importlib.import_module("repro_torch.kernels.ops")
    h = generate_np(np.random.default_rng(1), 40).h
    default = solve(h, device="cpu", block_size=256, round_mode="fused").dist
    autotune._save({autotune.key_for_fw_round("torch", torch.float32, 40):
                    {"params": {"block_size": 8, "round_mode": "split"}}})
    calls = []
    real = ops.fw_block
    monkeypatch.setattr(ops, "fw_block", lambda d, **kw: calls.append(d.shape) or real(d, **kw))
    tuned = solve(h, device="cpu").dist
    assert len(calls) == 5 and calls[0][-1] == 8          # five split rounds at B = 8
    assert torch.equal(tuned, default)


def test_measure_times_on_the_host_clock_on_the_cpu():
    calls = []
    us = autotune.measure(lambda: calls.append(1), 3, "cpu")
    assert len(calls) == 4 and 0 <= us < 1e6                # one warm call, three timed
