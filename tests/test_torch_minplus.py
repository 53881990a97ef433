"""The port's plain ⊕⊗ products (``repro_torch.kernels.minplus``) against the
JAX package's: the Pallas kernels in interpret mode (``minplus_pallas``,
``minplus_argmin_pallas``), the chunked-XLA folds (``minplus_xla``,
``minplus_argmin_xla``) and the oracles of ``repro.kernels.ref``.

Inputs are made with numpy from a seed and handed to both packages; bf16
crosses as its bit view.  Tolerance: exact (``np.array_equal``), values and
witnesses alike.  ⊕ is selective and each candidate is one rounded
operation, so every fold over the same candidates gives the same bits, and
every fold keeps the smallest k on a tie.  Witnesses are compared on
NaN-free inputs only: under NaN the JAX package's three witness functions
disagree with each other, and the port keeps its own rule (tested against
a per-candidate loop below).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.semiring import get_semiring as jax_semiring
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.minplus import minplus_argmin_pallas, minplus_pallas
from repro.kernels.minplus_xla import minplus_argmin_xla, minplus_xla
from repro_torch.core.convert import to_numpy, to_torch
from repro_torch.core.semiring import get_semiring
from repro_torch.kernels import ops, ref
from repro_torch.kernels.minplus import minplus_argmin_torch, minplus_torch

SEMIRINGS = ["tropical", "bottleneck", "reliability", "boolean"]
ZERO = {"tropical": np.inf, "bottleneck": -np.inf, "reliability": 0.0, "boolean": 0.0}


@pytest.fixture
def xla(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def mat(rng, shape, semiring, ties=False, density=0.6):
    """In-domain values, the semiring zero elsewhere.  ``ties`` draws from
    a few values, so many candidates of an element are equal."""
    if semiring == "boolean":
        vals = np.ones(shape)
    elif semiring == "reliability":
        vals = (rng.choice([0.25, 0.5, 1.0], size=shape) if ties
                else rng.uniform(0.05, 0.999, size=shape))
    else:
        vals = rng.integers(1, 4, size=shape) if ties else rng.uniform(1, 100, size=shape)
    edge = rng.uniform(size=shape) < density
    return np.where(edge, vals, ZERO[semiring]).astype(np.float32)


def operands(seed, semiring, g, m, k, n, ties=False):
    rng = np.random.default_rng(seed)
    lead = (g,) if g else ()
    x = mat(rng, lead + (m, k), semiring, ties)
    y = mat(rng, lead + (k, n), semiring, ties)
    a = mat(rng, lead + (m, n), semiring, ties, density=0.3)
    return x, y, a


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def plain(x, y, a, semiring, track):
    fn = minplus_argmin_torch if track else minplus_torch
    out = fn(t(x), t(y), None if a is None else t(a), semiring=semiring)
    return tuple(o.numpy() for o in out) if track else out.numpy()


def equal(got, want):
    if isinstance(got, tuple):
        return all(np.array_equal(g, np.asarray(w)) for g, w in zip(got, want))
    return np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("g", [0, 2])
@pytest.mark.parametrize("track", [False, True])
def test_plain_matches_pallas_interpret(semiring, acc, g, track):
    x, y, a = operands(g * 10 + acc, semiring, g, 21, 19, 37)
    a = a if acc else None
    fn = minplus_argmin_pallas if track else minplus_pallas
    want = fn(jnp.asarray(x), jnp.asarray(y), None if a is None else jnp.asarray(a),
              accumulate=acc, interpret=True, semiring=jax_semiring(semiring))
    assert equal(plain(x, y, a, semiring, track), want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("m,k,n", [(37, 45, 29), (5, 20, 7), (64, 100, 33)])
@pytest.mark.parametrize("track", [False, True])
def test_plain_matches_xla(semiring, acc, m, k, n, track):
    x, y, a = operands(m + k + n, semiring, 0, m, k, n)
    a = a if acc else None
    fn = minplus_argmin_xla if track else minplus_xla
    want = fn(jnp.asarray(x), jnp.asarray(y), None if a is None else jnp.asarray(a),
              semiring=jax_semiring(semiring))
    assert equal(plain(x, y, a, semiring, track), want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("k", [9, 70])
def test_ties_resolve_to_the_smallest_k(semiring, acc, k):
    x, y, a = operands(k + acc, semiring, 0, 23, k, 31, ties=True)
    a = a if acc else None
    z, ks = plain(x, y, a, semiring, True)
    sr = jax_semiring(semiring)
    for want in (
        minplus_argmin_xla(jnp.asarray(x), jnp.asarray(y),
                           None if a is None else jnp.asarray(a), semiring=sr),
        minplus_argmin_pallas(jnp.asarray(x), jnp.asarray(y),
                              None if a is None else jnp.asarray(a), accumulate=acc,
                              interpret=True, semiring=sr),
    ):
        assert equal((z, ks), want)
    # the draw is tie-heavy: some reachable element has several winning k
    best = jax_ref.minplus_ref(jnp.asarray(x), jnp.asarray(y), sr)
    wins = sr.mul(jnp.asarray(x)[:, :, None], jnp.asarray(y)[None, :, :]) == best[:, None, :]
    wins = np.asarray(wins.sum(axis=1))[~np.asarray(sr.is_zero(best))]
    assert wins.max() > 1


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_port_oracles_match_jax_oracles(semiring):
    x, y, a = operands(3, semiring, 0, 12, 17, 9)
    sr = jax_semiring(semiring)
    jx, jy, ja = jnp.asarray(x), jnp.asarray(y), jnp.asarray(a)
    assert equal(ref.minplus_ref(t(x), t(y), semiring).numpy(), jax_ref.minplus_ref(jx, jy, sr))
    got = ref.minplus_argmin_ref(t(x), t(y), semiring)
    assert equal(tuple(o.numpy() for o in got), jax_ref.minplus_argmin_ref(jx, jy, sr))
    got = ref.minplus_acc_argmin_ref(t(a), t(x), t(y), semiring)
    assert equal(tuple(o.numpy() for o in got), jax_ref.minplus_acc_argmin_ref(ja, jx, jy, sr))
    # the plain fold agrees with the oracles on NaN-free inputs
    assert equal(plain(x, y, None, semiring, True), jax_ref.minplus_argmin_ref(jx, jy, sr))
    assert equal(plain(x, y, a, semiring, True), jax_ref.minplus_acc_argmin_ref(ja, jx, jy, sr))


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("g", [0, 3])
def test_ops_bf16_matches_jax_ops(xla, track, acc, g):
    x, y, a = operands(40 + g, "tropical", g, 33, 48, 26, ties=True)
    xb, yb, ab = (jnp.asarray(v, jnp.bfloat16) for v in (x, y, a))
    ab = ab if acc else None
    jfn = jax_ops.minplus_argmin if track else jax_ops.minplus
    want = jfn(xb, yb, ab)
    fn = ops.minplus_argmin if track else ops.minplus
    got = fn(to_torch(np.asarray(xb)), to_torch(np.asarray(yb)),
             None if ab is None else to_torch(np.asarray(ab)))
    z = got[0] if track else got
    assert z.dtype == torch.bfloat16
    zw = np.asarray(want[0] if track else want).view(np.uint16)
    assert np.array_equal(to_numpy(z)[0], zw)
    if track:
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def test_ops_bf16_matches_jax_interpret(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "interpret")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    x, y, a = operands(7, "tropical", 0, 17, 24, 20, ties=True)
    xb, yb, ab = (jnp.asarray(v, jnp.bfloat16) for v in (x, y, a))
    z, ks = jax_ops.minplus_argmin(xb, yb, ab)
    got = ops.minplus_argmin(*(to_torch(np.asarray(v)) for v in (xb, yb, ab)))
    assert np.array_equal(to_numpy(got[0])[0], np.asarray(z).view(np.uint16))
    assert np.array_equal(got[1].numpy(), np.asarray(ks))


def _loop_argmin(x, y, a, semiring):
    """Per-candidate ascending-k fold with strict improvement: a NaN
    candidate never improves, a NaN accumulator is never replaced."""
    mul = {"tropical": np.add, "bottleneck": np.minimum, "reliability": np.multiply,
           "boolean": np.minimum}[semiring]
    better = (lambda c, v: c < v) if semiring == "tropical" else (lambda c, v: c > v)
    m, k = x.shape
    n = y.shape[1]
    z = np.full((m, n), ZERO[semiring], np.float32) if a is None else a.copy()
    ks = np.full((m, n), -1, np.int32)
    for i in range(m):
        for j in range(n):
            for kk in range(k):
                c = np.float32(mul(np.float32(x[i, kk]), np.float32(y[kk, j])))
                if not np.isnan(c) and better(c, z[i, j]):
                    z[i, j], ks[i, j] = c, kk
    return z, ks


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("acc", [False, True])
def test_witness_nan_rule(semiring, acc):
    x, y, a = operands(5, semiring, 0, 6, 11, 7)
    x[1, :] = np.nan          # a row of NaN candidates
    x[2, 3] = np.nan          # one NaN candidate among good ones
    y[5, 4] = np.nan
    a = a if acc else None
    if acc:
        a[0, 0] = np.nan      # a NaN accumulator stays
    z, ks = plain(x, y, a, semiring, True)
    wz, wk = _loop_argmin(x, y, a, semiring)
    assert np.array_equal(z, wz, equal_nan=True) and np.array_equal(ks, wk)
    assert (ks[1] == -1).all()
    if acc:
        assert np.isnan(z[0, 0]) and ks[0, 0] == -1


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_value_fold_propagates_nan_as_jax(xla, semiring):
    x, y, a = operands(8, semiring, 0, 9, 40, 8)
    x[2, 30] = np.nan
    want = minplus_xla(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a),
                       semiring=jax_semiring(semiring))
    got = plain(x, y, a, semiring, False)
    assert np.isnan(got).any() and np.array_equal(got, np.asarray(want), equal_nan=True)


def test_ops_minplus_follows_the_device_and_rejects_bf16_outside_tropical():
    x = torch.zeros(4, 4)
    assert ops.minplus(x, x).device.type == "cpu"
    assert ops.minplus_argmin(x, x)[1].dtype == torch.int32
    with pytest.raises(ValueError, match="bf16"):
        ops.minplus(x.bfloat16(), x, semiring="boolean")
    with pytest.raises(ValueError, match="bf16"):
        ops.minplus_argmin(x, x, x.bfloat16(), semiring="bottleneck")


def _deferred_fold(x, y, a, semiring, bk):
    """A plain model of the CUDA witness fold's deferred slices
    (``fold_ring``, ``csrc/minplus_tile.cuh``): each slice of ``bk`` k is
    folded into a copy of the accumulator with a ⊕ that ignores NaN (as
    ``fminf`` / ``fmaxf``; between equal values, ±0, it keeps the later, so
    the slice value's own bits are never the answer); an output takes a
    witness from the slice only where that slice value strictly improves on
    the accumulator (``better``, false for NaN), and then it is the first k
    of the slice whose candidate equals the slice value, whose bits the
    accumulator takes."""
    sr = get_semiring(semiring)

    def pick(v, c):
        return torch.where(torch.isnan(c) | sr.better(v, c), v, c)

    m, k = x.shape
    acc = (torch.full((m, y.shape[1]), sr.zero) if a is None else a).clone()
    idx = torch.full(acc.shape, -1, dtype=torch.int32)
    for k0 in range(0, k, bk):
        cand = sr.mul(x[:, k0:k0 + bk, None], y[None, k0:k0 + bk, :])
        v = acc.clone()
        for q in range(cand.shape[1]):
            v = pick(v, cand[:, q])
        moved = sr.better(v, acc)
        first = (cand == v[:, None, :]).int().argmax(dim=1)
        won = torch.gather(cand, 1, first[:, None, :])[:, 0]
        acc = torch.where(moved, won, acc)
        idx = torch.where(moved, (first + k0).to(torch.int32), idx)
    return acc, idx


def _deferred_case(case, semiring, bk):
    """(x, y, a, bk) of one case of the rule's test."""
    rng = np.random.default_rng(31 + bk)
    k = 70
    x, y, a = operands(41, semiring, 0, 12, k, 9, ties=case in ("ties", "tie_across_slices"))
    if case == "tie_across_slices":
        # slice 1 repeats slice 0's candidates exactly: it only ties
        x[:, bk:2 * bk], y[bk:2 * bk] = x[:, :bk], y[:bk]
    elif case == "signed_zero":
        x = rng.choice([0.0, -0.0, 1.0], size=x.shape).astype(np.float32)
        y = rng.choice([0.0, -0.0, 2.0], size=y.shape).astype(np.float32)
        a = np.full(a.shape, 1.0 if semiring == "tropical" else -1.0, np.float32)
    elif case == "nan":
        x[rng.uniform(size=x.shape) < 0.1] = np.nan
        y[3, :] = np.nan
        a[rng.uniform(size=a.shape) < 0.2] = np.nan
    elif case == "from_zero":
        a = None
    elif case == "nothing_improves":
        a = plain(x, y, a, semiring, False)
    elif case == "ragged_k":
        x, y = x[:, :37], y[:37]
    return x, y, a


DEFERRED_CASES = [(case, bk) for case in ("ties", "tie_across_slices", "signed_zero", "nan",
                                          "from_zero", "nothing_improves", "ragged_k")
                  for bk in (32,)] + [("ragged_k", 16), ("ties", 16)]


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("case,bk", DEFERRED_CASES)
def test_deferred_witness_fold_is_the_eager_fold(semiring, case, bk):
    """The CUDA kernel's deferred witness rule gives the eager fold's (Z, K*)
    bit for bit: against the per-candidate loop (the kernel's eager fold:
    the bits of ±0 and of each tie's first candidate) and against
    ``minplus_argmin_torch`` (values and witnesses), under ties inside and
    across slices, ±0 candidates, NaN candidates and accumulators, a K that
    is not a multiple of the slice, a fold from the zero, and a start value
    that nothing improves."""
    x, y, a = _deferred_case(case, semiring, bk)
    z, ks = _deferred_fold(t(x), t(y), None if a is None else t(a), semiring, bk)
    z, ks = z.numpy(), ks.numpy()
    wz, wk = _loop_argmin(x, y, a, semiring)
    assert np.array_equal(z.view(np.int32), wz.view(np.int32)) and np.array_equal(ks, wk)
    pz, pk = plain(x, y, a, semiring, True)
    assert np.array_equal(z, pz, equal_nan=True) and np.array_equal(ks, pk)
    if case == "nothing_improves":
        assert (ks == -1).all()
    if case == "tie_across_slices":
        assert not ((ks >= bk) & (ks < 2 * bk)).any()


def test_witness_fold_counts_are_kept_only_under_a_profiler():
    """Off a profiler the witness launches hand the kernel no counts buffer
    (a null pointer: nothing is counted); under one, one buffer of
    FOLD_COUNTS a device, made once; the reader gives zeros for a device
    where none was made."""
    mpm = importlib.import_module("repro_torch.kernels.minplus")
    dev = torch.device("cpu")
    assert mpm._fold_buffer(dev) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        buf = mpm._fold_buffer(dev)
        assert buf is not None and mpm._fold_buffer(dev) is buf
    assert buf.shape == (len(mpm.FOLD_COUNTS),) and buf.dtype == torch.int64
    assert mpm._fold_buffer(dev) is None
    mpm._fold_buffers.pop(dev)
    assert mpm.fold_counts("cpu") == dict.fromkeys(mpm.FOLD_COUNTS, 0)
