"""``repro_torch.solve(h, device="cpu")`` against ``repro.core.solve(h)``:
the main path of the port, end to end, on the plain PyTorch version.

Inputs come from ``generate_np`` (tropical, integer weights) or from
``tests/oracle.py::generate`` (in-domain values for the other semirings),
made with numpy from a seed.  Both packages get an explicit block size
where one is given, and the JAX side runs without its autotune cache.
Tolerance: exact (``np.array_equal``).  Each round's candidates are single
rounded operations folded by a selective ⊕, so both packages produce the
same bits round after round.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import generate

import repro.core as jax_core
import repro_torch
from repro_torch.core import (
    InputValidationError,
    NegativeCycleError,
    generate_np,
    solve,
)
from repro_torch.core.convert import to_numpy

SIZES = [1, 7, 64, 100, 256, 384]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_KERNELS", "xla")


def _graph(n: int, semiring: str) -> np.ndarray:
    rng = np.random.default_rng(1000 + n)
    if semiring == "tropical":
        return generate_np(rng, n).h
    return generate(rng, n, semiring)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("semiring,dtype", [
    ("tropical", "float32"),
    ("bottleneck", "float32"),
    ("reliability", "float32"),
    ("boolean", "float32"),
    ("tropical", "bfloat16"),
])
def test_solve_matches_jax(semiring, dtype, n):
    h = _graph(n, semiring)
    want = jax_core.solve(h, semiring=semiring, dtype=getattr(jnp, dtype)).dist
    got = solve(h, semiring=semiring, dtype=getattr(torch, dtype), device="cpu")
    assert got.method == "blocked_fw" and got.pred is None
    dist, kind = to_numpy(got.dist)
    assert kind == dtype
    want = np.asarray(want)
    assert np.array_equal(dist, want.view(np.uint16) if dtype == "bfloat16" else want)


@pytest.mark.parametrize("n", [7, 64, 100, 384])
@pytest.mark.parametrize("block_size", [16, None])
def test_solve_matches_jax_block_sizes(block_size, n):
    h = _graph(n, "tropical")
    want = jax_core.solve(h, block_size=block_size).dist
    got = solve(h, block_size=block_size, device="cpu").dist
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_solve_takes_a_tensor_and_leaves_it_unchanged():
    h = torch.from_numpy(_graph(100, "tropical"))
    before = h.clone()
    got = solve(h, block_size=32, device="cpu").dist
    assert torch.equal(h, before)
    assert np.array_equal(got.numpy(), np.asarray(jax_core.solve(before.numpy()).dist))


def test_nan_raises_input_validation_error():
    h = _graph(64, "tropical")
    h[5, 9] = np.nan
    with pytest.raises(InputValidationError, match="NaN"):
        solve(h, device="cpu")
    assert issubclass(InputValidationError, repro_torch.APSPError)


def test_nan_passes_through_without_validation():
    h = _graph(64, "tropical")
    h[5, 9] = np.nan
    got = solve(h, device="cpu", validate=False, block_size=32).dist.numpy()
    want = np.asarray(jax_core.solve(h, validate=False, block_size=32).dist)
    assert np.isnan(want).any() and np.array_equal(got, want, equal_nan=True)


def test_negative_cycle_raises():
    h = _graph(32, "tropical")
    h[0, 1], h[1, 0] = -5.0, 2.0
    with pytest.raises(NegativeCycleError, match="negative cycle"):
        solve(h, device="cpu")


def test_solve_without_a_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(_graph(8, "tropical"))


@pytest.mark.parametrize("method", ["squaring", "squaring_3d", "classic", "rkleene"])
def test_unported_options_raise(method):
    """The JAX package's other methods, once unported, are ported now
    (tests/test_torch_methods.py holds them against JAX): each solves to the
    blocked solve's distances, and a name that is not registered still
    raises, naming the registered methods."""
    h = _graph(16, "tropical")
    got = solve(h, device="cpu", method=method)
    assert got.method == method
    assert torch.equal(got.dist, solve(h, device="cpu").dist)
    with pytest.raises(ValueError, match=method):
        solve(h, device="cpu", method=method + "_unknown")


def test_unknown_method_and_round_mode_raise():
    with pytest.raises(ValueError, match="unknown APSP method"):
        solve(_graph(8, "tropical"), method="nope", device="cpu")
    with pytest.raises(ValueError, match="round_mode"):
        solve(_graph(8, "tropical"), round_mode="fast", device="cpu")
