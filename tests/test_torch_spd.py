"""``repro_torch.spd_features`` against ``repro.core.paths.spd_features`` on
the CPU.  Tolerance: exact (``np.array_equal``): integer weights, so every
sum is exact, and both fold the same candidates with a selective min.

The hop count is read by counting ``kernels.ops.minplus`` calls: on the
card each is one launch of the ``minplus`` kernel (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 9a hold that)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paths import spd_features as jax_spd

import repro_torch
from repro_torch.core import generate_np
from repro_torch.kernels import ops
from repro_torch.kernels.minplus import _ring_limit, ring_rows


def _path_graph(n: int) -> np.ndarray:
    """0 -> 1 -> ... -> n-1, unit weights: hop diameter n-1 (worst case)."""
    h = np.full((n, n), np.inf, np.float32)
    np.fill_diagonal(h, 0.0)
    for i in range(n - 1):
        h[i, i + 1] = 1.0
    return h


@pytest.fixture
def hops(monkeypatch):
    """Counts the product calls ``spd_features`` makes (one per hop)."""
    calls = []
    real = ops.minplus

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "minplus", counted)
    return calls


def _both(h, landmarks, **kw):
    want = np.asarray(jax_spd(jnp.asarray(h), jnp.asarray(landmarks), **kw))
    got = repro_torch.spd_features(torch.from_numpy(h), landmarks, **kw)
    return want, got.numpy()


def test_path_graph_regression_takes_n_minus_1_hops(hops):
    n = 32
    want, got = _both(_path_graph(n), np.array([0]))
    assert got.shape == (n, 1) and np.array_equal(got, want)
    assert np.array_equal(got[:, 0], np.arange(n, dtype=np.float32))
    assert len(hops) == n - 1 and hops[0] == (1, n)


def test_unreachable_capped(rng):
    g = generate_np(rng, 20, rho=15.0)
    want, got = _both(g.h, np.array([0, 3]), cap=99.0)
    assert np.array_equal(got, want)
    assert got.max() == 99.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generated_graph_four_landmarks(seed, hops):
    g = generate_np(np.random.default_rng(seed), 64)
    lm = np.array([0, 9, 31, 63])
    want, got = _both(g.h, lm)
    assert got.shape == (64, 4) and np.array_equal(got, want)
    # Every landmark row equals the solve's, capped: the loop reached its fixpoint.
    dist = repro_torch.solve(g.h, device="cpu").dist.numpy()
    assert np.array_equal(got, np.minimum(dist[lm], 1e4).T)
    assert 1 <= len(hops) < 63


@pytest.mark.parametrize("form", ["list", "numpy", "tensor"])
def test_landmark_forms(form):
    g = generate_np(np.random.default_rng(4), 30)
    lm = [2, 17, 29]
    arg = {"list": lm, "numpy": np.array(lm, np.int32),
           "tensor": torch.tensor(lm, dtype=torch.int32)}[form]
    want, _ = _both(g.h, np.array(lm))
    assert np.array_equal(repro_torch.spd_features(torch.from_numpy(g.h), arg).numpy(), want)


def test_negative_cycle_stops_at_the_hop_cap(hops):
    """No fixpoint: the count of hops (n - 1) decides the answer, as in JAX."""
    n = 12
    h = _path_graph(n)
    h[5, 2] = -10.0                      # cycle 2 -> 3 -> 4 -> 5 -> 2 of weight -7
    want, got = _both(h, np.array([0, 7]))
    assert np.array_equal(got, want)
    assert len(hops) == n - 1


def test_single_node_takes_no_hop(hops):
    want, got = _both(np.zeros((1, 1), np.float32), np.array([0]))
    assert np.array_equal(got, want) and hops == []


def test_ring_rows_pads_once_and_keeps_ready_rows():
    """On the card ``spd_features`` hands the kernel ``ring_rows(h)``: a
    ready h as it is, else one copy in rows padded to 32 floats that every
    hop's launch takes as it lies (``_ring_limit`` is not None)."""
    h = torch.from_numpy(generate_np(np.random.default_rng(5), 64).h)
    assert ring_rows(h) is h and _ring_limit(h, 64) == 64
    odd = torch.from_numpy(generate_np(np.random.default_rng(5), 63).h)
    assert _ring_limit(odd, 63) is None
    y = ring_rows(odd)
    assert y.shape == (63, 63) and y.stride() == (64, 1) and torch.equal(y, odd)
    assert _ring_limit(y, 63) == 64 and ring_rows(y) is y
    # The last row's read up to column 64 must stay inside the storage.
    tight = torch.empty(63 * 64 - 1).as_strided((63, 63), (64, 1))
    assert _ring_limit(tight, 63) is None


@pytest.mark.parametrize("landmarks", [[0, 7], [5], [-6], np.array([2, 9]), torch.tensor([7])])
def test_out_of_range_landmark_raises(landmarks, hops):
    """An id outside [-n, n) raises IndexError before any product (the JAX
    function clamps it instead: a divergence by design)."""
    with pytest.raises(IndexError, match=r"outside \[-5, 5\)"):
        repro_torch.spd_features(torch.from_numpy(_path_graph(5)), landmarks)
    assert hops == []


def test_negative_landmark_wraps_as_jax_reads_it():
    """Landmark -1 on a 5-node graph is node 4, as in the JAX function."""
    h = _path_graph(5)
    want, got = _both(h, np.array([-1, 0, -5]))
    assert np.array_equal(got, want)
    node4 = repro_torch.spd_features(torch.from_numpy(h), [4]).numpy()
    assert np.array_equal(got[:, :1], node4)
