"""``repro_torch.solve(h, with_pred=True, device="cpu")`` against
``repro.core.solve(h, with_pred=True)``, and the port's path functions
(``repro_torch.core.paths``) against the JAX package's on solved graphs.

Inputs come from ``generate_np`` (tropical, integer weights) or from
``tests/oracle.py::generate`` (in-domain values for the other semirings),
made with numpy from a seed.  The JAX side runs its chunked-XLA folds
without its autotune cache.  Tolerance: exact (``np.array_equal``) for
``dist`` and ``pred``: every round's candidates are single rounded
operations folded in ascending k with strict improvement, so both packages
pick the same witnesses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import generate

import repro.core as jax_core
from repro.core import paths as jax_paths
from repro_torch.core import (
    generate_np,
    path_cost,
    reconstruct_path,
    reconstruct_path_device,
    solve,
    validate_tree,
)
from repro_torch.core.convert import to_numpy

SIZES = [1, 7, 64, 100, 256, 384]
CASES = [
    ("tropical", "float32"),
    ("bottleneck", "float32"),
    ("reliability", "float32"),
    ("boolean", "float32"),
    ("tropical", "bfloat16"),
]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_KERNELS", "xla")


def graph(n: int, semiring: str) -> np.ndarray:
    rng = np.random.default_rng(2000 + n)
    if semiring == "tropical":
        return generate_np(rng, n).h
    return generate(rng, n, semiring)


def assert_same(got, want, dtype="float32"):
    dist, kind = to_numpy(got.dist)
    assert kind == dtype
    wd = np.asarray(want.dist)
    assert np.array_equal(dist, wd.view(np.uint16) if dtype == "bfloat16" else wd)
    assert got.pred.dtype == torch.int32 and got.pred.device == got.dist.device
    assert np.array_equal(got.pred.numpy(), np.asarray(want.pred))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("semiring,dtype", CASES)
def test_solve_with_pred_matches_jax(semiring, dtype, n):
    h = graph(n, semiring)
    want = jax_core.solve(h, semiring=semiring, dtype=getattr(jnp, dtype), with_pred=True)
    got = solve(h, semiring=semiring, dtype=getattr(torch, dtype), with_pred=True,
                device="cpu")
    assert got.method == "blocked_fw"
    assert_same(got, want, dtype)


@pytest.mark.parametrize("n", [64, 100])
@pytest.mark.parametrize("semiring", ["tropical", "reliability"])
def test_solve_with_pred_block_not_dividing_n(semiring, n):
    h = graph(n, semiring)
    want = jax_core.solve(h, semiring=semiring, with_pred=True, block_size=19)
    got = solve(h, semiring=semiring, with_pred=True, block_size=19, device="cpu")
    assert_same(got, want)


def test_pred_dist_equals_the_no_pred_dist():
    h = graph(100, "tropical")
    assert torch.equal(solve(h, with_pred=True, device="cpu").dist,
                       solve(h, device="cpu").dist)


@pytest.mark.parametrize("semiring", ["tropical", "bottleneck", "reliability", "boolean"])
def test_paths_match_jax(semiring):
    n = 60
    h = graph(n, semiring)
    res = solve(h, semiring=semiring, with_pred=True, device="cpu")
    dist, pred = res.dist.numpy(), res.pred.numpy()
    assert validate_tree(h, dist, pred, semiring)
    assert validate_tree(h, res.dist, res.pred, semiring)
    assert validate_tree(h, dist, pred, semiring) == jax_paths.validate_tree(
        h, dist, pred, semiring)
    rng = np.random.default_rng(5)
    for i, j in rng.integers(0, n, size=(40, 2)):
        got = reconstruct_path(res.pred, int(i), int(j))
        assert got == jax_paths.reconstruct_path(pred, int(i), int(j))
        if got is not None:
            cost = path_cost(h, got, semiring)
            assert cost == jax_paths.path_cost(h, got, semiring)
            if semiring == "tropical":
                assert cost == dist[i, j]


def test_validate_tree_catches_a_broken_tree():
    h = graph(40, "tropical")
    res = solve(h, with_pred=True, device="cpu")
    pred = res.pred.numpy().copy()
    i, j = np.argwhere(np.isfinite(res.dist.numpy()) & ~np.eye(40, dtype=bool))[3]
    pred[i, j] = -1
    assert not validate_tree(h, res.dist, pred)
    assert not jax_paths.validate_tree(h, res.dist.numpy(), pred)


def test_reconstruct_path_device_matches_jit():
    n = 100
    h = generate_np(np.random.default_rng(8), n, rho=4.0).h
    res = solve(h, with_pred=True, device="cpu")
    pred = res.pred
    lengths = []
    rng = np.random.default_rng(6)
    for i, j in list(rng.integers(0, n, size=(12, 2))) + [(3, 3)]:
        host = reconstruct_path(pred, int(i), int(j))
        need = 0 if host is None else len(host)
        lengths.append(need)
        for max_len in (need + 2, max(need - 1, 1), need + 1):
            path, length = reconstruct_path_device(pred, int(i), int(j), max_len=max_len)
            assert path.shape == (max_len,) and path.dtype == torch.int32
            jp, jl = jax_paths.reconstruct_path_jit(jnp.asarray(pred.numpy()), int(i), int(j),
                                                    max_len=max_len)
            if need == 0 or need <= max_len:
                assert int(length) == int(jl) and np.array_equal(path.numpy(), np.asarray(jp))
            assert int(length) == (need if 0 < need <= max_len else 0)
            if 0 < need <= max_len:
                assert path[:need].tolist() == host and (path[need:] == -1).all()
            else:
                assert (path == -1).all()
    assert max(lengths) > 3 and 0 in lengths


def test_reconstruct_path_device_overflow_by_one_node():
    """A path of max_len + 1 nodes overflows: length 0 (the JAX version
    returns max_len + 1 and a path without its source here)."""
    n = 6
    pred = np.full((n, n), -1, np.int32)
    pred[0, 0] = 0
    for j in range(1, 5):
        pred[0, j] = j - 1
    path, length = reconstruct_path_device(torch.from_numpy(pred), 0, 4, max_len=4)
    assert int(length) == 0 and (path == -1).all()
    path, length = reconstruct_path_device(torch.from_numpy(pred), 0, 4, max_len=5)
    assert int(length) == 5 and path.tolist() == [0, 1, 2, 3, 4]
