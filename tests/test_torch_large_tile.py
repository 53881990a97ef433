"""Tiles above 256 nodes, the pred product and ``repro.kernels``' names in
the port, on the CPU against the JAX package.

* ``repro_torch.solve(h, block_size=512, device="cpu")`` against
  ``repro.core.solve(h, block_size=512)`` at n = 700 (padded to 1024), on
  the fused, split and pred paths: the shape of the reference's own
  ``blocked_16k`` cell, whose tile the card closes on the grid closure.
* The plain ``minplus_pred_torch`` (``minplus_argmin_torch`` and then
  ``pred_from_kstar``, the oracle of the CUDA kernel's pred epilogue)
  against ``repro.kernels.ops.minplus_pred`` at the pred round's stage-2 and
  stage-3 shapes, px a strided view as the round passes it.
* ``repro_torch.kernels`` binds ``repro.kernels``' eight ``ops`` names and
  ``ref``, and ``repro_torch.core`` binds ``reconstruct_path_jit``; each is
  called the way the reference's is and gives its answer.

Inputs come from ``generate_np`` (integer weights) and numpy draws from a
seed; the JAX side runs its chunked-XLA folds without its autotune cache.
Tolerance: exact (``np.array_equal``) for values and preds: every candidate
is one rounded operation, folded in ascending k with strict improvement.
"""

import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.kernels as jax_kernels
from repro.kernels import ops as jax_ops

import repro_torch.core as port_core
import repro_torch.kernels as port_kernels
from repro_torch.core import generate_np, init_pred, solve
from repro_torch.kernels import ops

mp = importlib.import_module("repro_torch.kernels.minplus")

REFERENCE_NAMES = ["minplus", "minplus_argmin", "minplus_pred", "pred_from_kstar", "fw_block",
                   "fw_block_pred", "fw_round", "fw_round_pred"]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_KERNELS", "xla")


@pytest.mark.parametrize("options", [{}, {"with_pred": True}, {"round_mode": "split"},
                                     {"round_mode": "split", "with_pred": True}])
def test_block_512_solve_matches_jax(options):
    h = generate_np(np.random.default_rng(700), 700, rho=4.0).h
    want = jax_core.solve(h, block_size=512, **options)
    got = solve(h, block_size=512, device="cpu", **options)
    assert np.array_equal(got.dist.numpy(), np.asarray(want.dist))
    if options.get("with_pred"):
        assert np.array_equal(got.pred.numpy(), np.asarray(want.pred))
        assert port_core.validate_tree(h, got.dist, got.pred)


def test_block_512_dist_equals_block_256():
    """Integer weights: every sum is exact, so the tile size does not move a bit."""
    h = generate_np(np.random.default_rng(701), 700, rho=4.0).h
    assert torch.equal(solve(h, block_size=512, device="cpu").dist,
                       solve(h, device="cpu").dist)


def _stage_operands(seed: int, n: int = 192, b: int = 64, o: int = 64):
    """A solved-ish state's stage-2 and stage-3 operands, as the pred round
    forms them: stage 2 col ⊗ A* into col (k_offset = j_offset = o), stage 3
    col' ⊗ row into D (k_offset = o)."""
    h = generate_np(np.random.default_rng(seed), n, rho=6.0).h
    d = torch.from_numpy(h)
    p = init_pred(d)
    piv, ppiv = ops.fw_block_pred(d[o:o + b, o:o + b], p[o:o + b, o:o + b])
    return d, p, piv, ppiv, o, b


@pytest.mark.parametrize("stage", [2, 3])
@pytest.mark.parametrize("fallback", [True, False])
def test_minplus_pred_plain_matches_jax(stage, fallback):
    d, p, piv, ppiv, o, b = _stage_operands(11 + stage)
    col, pcol = d[:, o:o + b], p[:, o:o + b]
    assert not pcol.is_contiguous()                   # a strided panel, as the round passes it
    if stage == 2:
        x, y, px, py, a, pa, ko, jo = col, piv, pcol, ppiv, col, pcol, o, o
    else:
        x, px = mp.minplus_pred_torch(col, piv, pcol, ppiv, col, pcol, k_offset=o, j_offset=o)
        y, py, a, pa, ko, jo = d[o:o + b, :], p[o:o + b, :], d, p, o, 0
    pa = pa if fallback else None
    got = mp.minplus_pred_torch(x, y, px, py, a, pa, k_offset=ko, j_offset=jo)
    want = jax_ops.minplus_pred(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jnp.asarray(px.numpy()),
        jnp.asarray(py.numpy()), a=jnp.asarray(a.numpy()),
        pa=None if pa is None else jnp.asarray(pa.numpy()), k_offset=ko, j_offset=jo)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert bool((got[1] != -1).any())
    # ops.minplus_pred on a CPU tensor runs the same plain version.
    via_ops = ops.minplus_pred(x, y, px, py, a=a, pa=pa, k_offset=ko, j_offset=jo)
    assert torch.equal(via_ops[0], got[0]) and torch.equal(via_ops[1], got[1])


def test_minplus_pred_plain_without_accumulator_matches_jax():
    rng = np.random.default_rng(5)
    x = np.where(rng.uniform(size=(3, 40, 24)) < 0.5, rng.integers(1, 4, (3, 40, 24)), np.inf)
    y = np.where(rng.uniform(size=(3, 24, 30)) < 0.5, rng.integers(1, 4, (3, 24, 30)), np.inf)
    x, y = x.astype(np.float32), y.astype(np.float32)
    px = rng.integers(-1, 500, (3, 40, 24)).astype(np.int32)
    py = rng.integers(-1, 500, (3, 24, 30)).astype(np.int32)
    got = mp.minplus_pred_torch(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(px),
                                torch.from_numpy(py), k_offset=10, j_offset=4)
    want = jax_ops.minplus_pred(jnp.asarray(x), jnp.asarray(y), jnp.asarray(px),
                                jnp.asarray(py), k_offset=10, j_offset=4)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("name", REFERENCE_NAMES + ["ref", "ops"])
def test_kernels_bind_the_reference_names(name):
    ref_obj, port_obj = getattr(jax_kernels, name), getattr(port_kernels, name)
    assert name in jax_kernels.__all__ and name in port_kernels.__all__
    if name in ("ref", "ops"):
        assert inspect.ismodule(ref_obj) and inspect.ismodule(port_obj)
        assert port_obj is importlib.import_module(f"repro_torch.kernels.{name}")
        assert [f for f in port_obj.__all__ if not hasattr(ref_obj, f)] == []
    else:
        assert callable(port_obj) and port_obj is getattr(ops, name)


def _call_both(name):
    """Call ``name`` in both packages the same way, on the same numpy data.
    The reference side is ``repro.kernels.ops``: ``repro.kernels`` binds the
    same functions, but importing a submodule of the same name later (as
    ``from repro.kernels.fw_round import fw_round_pallas`` does in another
    test of the same process) rebinds that package attribute to the module."""
    d, p, piv, ppiv, o, b = _stage_operands(40, n=96, b=32, o=32)
    dn, pn = d.numpy(), p.numpy()
    calls = {
        "minplus": lambda m, t: m.minplus(t(dn[:, :32]), t(dn[:32, :]), t(dn)),
        "minplus_argmin": lambda m, t: m.minplus_argmin(t(dn[:, :32]), t(dn[:32, :]), t(dn)),
        "minplus_pred": lambda m, t: m.minplus_pred(
            t(dn[:, o:o + b]), t(dn[o:o + b, :]), t(pn[:, o:o + b]), t(pn[o:o + b, :]),
            a=t(dn), pa=t(pn), k_offset=o),
        "pred_from_kstar": lambda m, t: m.pred_from_kstar(
            t(np.arange(96 * 32, dtype=np.int32).reshape(96, 32) % 33 - 1), t(pn[:, :32]),
            t(pn[:32, :32]), k_offset=3, j_offset=5, fallback=t(pn[:, :32])),
        "fw_block": lambda m, t: m.fw_block(t(dn[:32, :32])),
        "fw_block_pred": lambda m, t: m.fw_block_pred(t(dn[:32, :32]), t(pn[:32, :32])),
        "fw_round": lambda m, t: m.fw_round(t(dn), 32, block_size=32),
        "fw_round_pred": lambda m, t: m.fw_round_pred(t(dn), t(pn), 32, block_size=32),
    }
    want = calls[name](jax_ops, lambda a: jnp.asarray(np.ascontiguousarray(a)))
    got = calls[name](port_kernels, lambda a: torch.from_numpy(np.ascontiguousarray(a)))
    return got, want


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_reference_names_answer_alike(name):
    got, want = _call_both(name)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_kernel_submodules_stay_reachable_by_module_path():
    """``repro_torch.kernels.fw_block`` is the ops function; the submodule
    (the wrappers, their counters and launch plans) by module path."""
    for name in ("minplus", "fw_block", "fw_round"):
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        assert inspect.ismodule(mod) and getattr(port_kernels, name) is getattr(ops, name)
        assert hasattr(mod, "launches") or hasattr(mod, "rounds")


def test_reconstruct_path_jit_is_bound_and_answers_alike():
    n = 60
    h = generate_np(np.random.default_rng(9), n, rho=4.0).h
    res = solve(h, with_pred=True, device="cpu")
    assert port_core.reconstruct_path_jit is not port_core.reconstruct_path_device
    rng = np.random.default_rng(2)
    for i, j in rng.integers(0, n, size=(10, 2)):
        got = port_core.reconstruct_path_jit(res.pred, int(i), int(j), max_len=n)
        want = jax_core.reconstruct_path_jit(jnp.asarray(res.pred.numpy()), int(i), int(j),
                                             max_len=n)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])
        dev = port_core.reconstruct_path_device(res.pred, int(i), int(j), max_len=n)
        assert torch.equal(got[0], dev[0]) and torch.equal(got[1], dev[1])
