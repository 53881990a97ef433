"""The port's other solvers — ``squaring`` (the paper's FW-GPU),
``squaring_3d`` (its N×N×N broadcast), ``classic`` and ``rkleene`` — and
the rest of ``repro_torch.core.semiring`` against the JAX package on the
CPU.

Inputs come from ``generate_np`` (tropical, integer weights) or from
``tests/oracle.py::generate`` (in-domain values for the other semirings),
made with numpy from a seed.  The JAX side runs its chunked-XLA folds
without its autotune cache.  Tolerance: exact (``np.array_equal``) for
``dist`` and ``pred`` — every candidate is one rounded operation folded by
a selective ⊕ with ties to the smallest k, and both packages run the same
products on the same quadrants — except ``softmin_matmul``, an
approximation through exp, a matmul and log, held within 1e-5 of its
input scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import generate

import repro.core as jax_core
from repro.core import floyd_warshall as jax_fw
from repro.core import semiring as jax_sr
from repro_torch.core import (
    fw_squaring_early_exit,
    generate_np,
    minplus,
    minplus_3d,
    minplus_3d_argmin,
    minplus_pred,
    solve,
    softmin_matmul,
    tropical_eye,
    validate_tree,
)
from repro_torch.core.convert import to_numpy
from repro_torch.core.semiring import auto_row_chunk, get_semiring

SEMIRINGS = ["tropical", "bottleneck", "reliability", "boolean"]
# (method, options): R-Kleene at base 8 and at base 6, whose quadrants
# start at columns that are not a multiple of 4.
METHODS = [
    ("squaring", {}),
    ("squaring_3d", {}),
    ("classic", {}),
    ("rkleene", {"base": 8}),
    ("rkleene", {"base": 6}),
]
IDS = ["-".join([m] + [f"{k}{v}" for k, v in kw.items()]) for m, kw in METHODS]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_KERNELS", "xla")


def graph(n: int, semiring: str, seed: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    if semiring == "tropical":
        return generate_np(rng, n).h
    return generate(rng, n, semiring)


def assert_result(got, want, with_pred, dtype="float32"):
    dist, kind = to_numpy(got.dist)
    assert kind == dtype
    wd = np.asarray(want.dist)
    assert np.array_equal(dist, wd.view(np.uint16) if dtype == "bfloat16" else wd)
    if with_pred:
        assert got.pred.dtype == torch.int32
        assert np.array_equal(got.pred.numpy(), np.asarray(want.pred))
    else:
        assert got.pred is None and want.pred is None


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("method,kw", METHODS, ids=IDS)
def test_method_matches_jax(method, kw, semiring, with_pred):
    h = graph(37, semiring)
    want = jax_core.solve(h, method=method, with_pred=with_pred, semiring=semiring, **kw)
    got = solve(h, method=method, with_pred=with_pred, semiring=semiring, device="cpu", **kw)
    assert got.method == method
    assert_result(got, want, with_pred)
    if with_pred and get_semiring(semiring).monotone_mul:
        assert validate_tree(h, got.dist, got.pred, semiring)


@pytest.mark.parametrize("method,kw", [("squaring", {}), ("rkleene", {"base": 8})],
                         ids=["squaring", "rkleene-base8"])
@pytest.mark.parametrize("n", [5, 64])
def test_method_matches_jax_sizes(method, kw, n):
    """n = 64 is a power of two (R-Kleene's pred grid is the matrix); n = 5
    is below one leaf."""
    h = graph(n, "tropical")
    for with_pred in (False, True):
        want = jax_core.solve(h, method=method, with_pred=with_pred, **kw)
        got = solve(h, method=method, with_pred=with_pred, device="cpu", **kw)
        assert_result(got, want, with_pred)


@pytest.mark.parametrize("method,kw", METHODS, ids=IDS)
def test_method_matches_jax_bf16(method, kw):
    h = graph(37, "tropical")
    want = jax_core.solve(h, method=method, dtype=jnp.bfloat16, **kw)
    got = solve(h, method=method, dtype=torch.bfloat16, device="cpu", **kw)
    assert_result(got, want, False, dtype="bfloat16")


@pytest.mark.parametrize("method,kw", METHODS, ids=IDS)
def test_method_leaves_its_input_unchanged(method, kw):
    h = torch.from_numpy(graph(20, "tropical"))
    before = h.clone()
    got = solve(h, method=method, device="cpu", donate=True, **kw).dist
    assert torch.equal(h, before)
    assert torch.equal(got, solve(before, device="cpu").dist)


@pytest.mark.parametrize("n,rho", [(37, None), (48, 3.0), (2, None)])
def test_early_exit_matches_jax(n, rho):
    """Distances and the iteration count; a sparse graph (rho = 3) stops
    before ceil(log2 n) + 1."""
    h = generate_np(np.random.default_rng(n), n, rho=rho).h
    want_d, want_it = jax_fw.fw_squaring_early_exit(jnp.asarray(h))
    got_d, got_it = fw_squaring_early_exit(torch.from_numpy(h))
    assert got_it == int(want_it)
    assert np.array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_minplus_3d_matches_jax(semiring):
    rng = np.random.default_rng(7)
    x, y = generate(rng, 9, semiring)[:, :7], generate(rng, 11, semiring)[:7, :]
    want = jax_sr.minplus_3d(jnp.asarray(x), jnp.asarray(y), semiring)
    got = minplus_3d(torch.from_numpy(x), torch.from_numpy(y), semiring)
    assert np.array_equal(got.numpy(), np.asarray(want))
    wz, wk = jax_sr.minplus_3d_argmin(jnp.asarray(x), jnp.asarray(y), semiring)
    gz, gk = minplus_3d_argmin(torch.from_numpy(x), torch.from_numpy(y), semiring)
    assert gk.dtype == torch.int32
    assert np.array_equal(gz.numpy(), np.asarray(wz))
    assert np.array_equal(gk.numpy(), np.asarray(wk))


def test_minplus_3d_takes_a_stack():
    xs = np.stack([graph(12, "tropical", seed=s) for s in range(3)])
    got = minplus_3d(torch.from_numpy(xs), torch.from_numpy(xs))
    for i in range(3):
        want = jax_sr.minplus_3d(jnp.asarray(xs[i]), jnp.asarray(xs[i]))
        assert np.array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(40, 24, 33), (1, 64, 1), (64, 64, 64)])
def test_core_minplus_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = generate_np(rng, max(m, k)).h[:m, :k]
    y = generate_np(rng, max(k, n)).h[:k, :n]
    want = jax_sr.minplus(jnp.asarray(x), jnp.asarray(y), row_chunk=8)
    got = minplus(torch.from_numpy(x), torch.from_numpy(y), row_chunk=8)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k_offset,j_offset", [(0, 0), (24, 0), (16, 16)])
def test_core_minplus_pred_matches_jax(k_offset, j_offset):
    rng = np.random.default_rng(11)
    x = generate_np(rng, 40).h[:, :24]
    y = generate_np(rng, 40).h[:24, :33]
    px = rng.integers(-1, 40, size=x.shape).astype(np.int32)
    py = rng.integers(-1, 40, size=y.shape).astype(np.int32)
    wz, wp = jax_sr.minplus_pred(jnp.asarray(x), jnp.asarray(y), jnp.asarray(px),
                                 jnp.asarray(py), k_offset=k_offset, j_offset=j_offset)
    gz, gp = minplus_pred(*(torch.from_numpy(a) for a in (x, y, px, py)), k_offset=k_offset,
                          j_offset=j_offset)
    assert np.array_equal(gz.numpy(), np.asarray(wz))
    assert np.array_equal(gp.numpy(), np.asarray(wp))


def test_core_minplus_pred_rejects_mismatched_preds():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="do not match"):
        minplus_pred(x, torch.zeros(3, 5), torch.zeros(4, 4, dtype=torch.int32),
                     torch.zeros(3, 5, dtype=torch.int32))


@pytest.mark.parametrize("m,n,k,budget", [(1000, 256, 256, 1 << 16), (3, 8, 8, 1 << 16),
                                          (512, 1, 1, 1 << 16), (64, 100, 7, 4096),
                                          (9, 0, 0, 1 << 16)])
def test_auto_row_chunk_matches_jax(m, n, k, budget):
    assert auto_row_chunk(m, n, k, budget) == jax_sr.auto_row_chunk(m, n, k, budget)


def test_tropical_eye_matches_jax():
    got = tropical_eye(5, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(jax_sr.tropical_eye(5)))


@pytest.mark.parametrize("tau", [0.02, 0.05, 0.2])
def test_softmin_matmul_matches_jax(tau):
    """|port - jax| <= 1e-5 * scale, scale the largest finite |x|, |y| (the
    JAX normalisation); inf entries equal."""
    rng = np.random.default_rng(5)
    x = generate_np(rng, 48, rho=60.0).h
    y = generate_np(rng, 48, rho=60.0).h
    want = np.asarray(jax_sr.softmin_matmul(jnp.asarray(x), jnp.asarray(y), tau=tau))
    got = softmin_matmul(torch.from_numpy(x), torch.from_numpy(y), tau=tau).numpy()
    scale = max(np.abs(x[np.isfinite(x)]).max(), np.abs(y[np.isfinite(y)]).max())
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(got[~fin], want[~fin])
    assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * scale


def test_softmin_matmul_restores_matmul_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        softmin_matmul(torch.ones(3, 3), torch.ones(3, 3))
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def test_unknown_method_names_the_methods():
    with pytest.raises(ValueError, match="rkleene"):
        solve(np.zeros((2, 2), np.float32), method="nope", device="cpu")
