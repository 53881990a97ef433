"""``repro_torch.solve(h, round_mode="split", device="cpu")``, with and
without predecessors, against ``repro.core.solve`` with the same options.

The split round is the legacy four-dispatch round: pivot closure
(``fw_block``), row and column panels (``minplus``; ``minplus_argmin`` with
predecessors), the closed pivot written into the column panel, and the
full accumulate.  Inputs are made with numpy from a seed; the JAX side runs
its chunked-XLA folds without its autotune cache.  Tolerance: exact
(``np.array_equal``) for ``dist`` and ``pred``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import generate

import repro.core as jax_core
from repro_torch.core import generate_np, solve
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
    rng = np.random.default_rng(3000 + n)
    if semiring == "tropical":
        return generate_np(rng, n).h
    return generate(rng, n, semiring)


def check(h, semiring, dtype, with_pred, **kw):
    want = jax_core.solve(h, semiring=semiring, dtype=getattr(jnp, dtype),
                          round_mode="split", with_pred=with_pred, **kw)
    got = solve(h, semiring=semiring, dtype=getattr(torch, dtype), round_mode="split",
                with_pred=with_pred, device="cpu", **kw)
    dist, kind = to_numpy(got.dist)
    wd = np.asarray(want.dist)
    assert kind == dtype
    assert np.array_equal(dist, wd.view(np.uint16) if dtype == "bfloat16" else wd)
    if with_pred:
        assert got.pred.dtype == torch.int32
        assert np.array_equal(got.pred.numpy(), np.asarray(want.pred))
    else:
        assert got.pred is None and want.pred is None
    return got


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("semiring,dtype", CASES)
def test_split_matches_jax(semiring, dtype, n):
    check(graph(n, semiring), semiring, dtype, False)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("semiring,dtype", CASES)
def test_split_with_pred_matches_jax(semiring, dtype, n):
    check(graph(n, semiring), semiring, dtype, True)


@pytest.mark.parametrize("n", [64, 100])
@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("semiring", ["tropical", "bottleneck"])
def test_split_block_not_dividing_n(semiring, with_pred, n):
    check(graph(n, semiring), semiring, "float32", with_pred, block_size=19)


@pytest.mark.parametrize("with_pred", [False, True])
def test_split_dist_equals_fused_dist(with_pred):
    h = graph(256, "tropical")
    split = solve(h, round_mode="split", with_pred=with_pred, block_size=64, device="cpu")
    fused = solve(h, block_size=64, device="cpu")
    assert torch.equal(split.dist, fused.dist)


def test_split_leaves_a_tensor_input_unchanged():
    h = torch.from_numpy(graph(100, "tropical"))
    before = h.clone()
    solve(h, round_mode="split", block_size=50, device="cpu")
    solve(h, round_mode="split", with_pred=True, block_size=50, device="cpu")
    assert torch.equal(h, before)
