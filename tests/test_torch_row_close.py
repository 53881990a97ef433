"""The port's row-restricted pass (``repro_torch.kernels.row_close`` and
``ops.row_restricted_close``) against the JAX package's: the TPU kernel
``row_close_pallas`` in interpret mode, and ``ops.row_restricted_close`` on
its XLA and interpret backends (with preds, against the plain pred mode
``row_close_pred_torch``).  A torch emulation of the kernel's split-k merge
is held against the unsplit fold.

Inputs are made with numpy from a seed and handed to both packages; bf16
crosses as its bit view.  Tolerance: exact (``np.array_equal``) for values,
witnesses and predecessors.  ⊕ is selective and each candidate is one
rounded operation, so every fold over the same candidates gives the same
bits, and every fold keeps the smallest k on a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.semiring import get_semiring as jax_semiring
from repro.kernels import ops as jax_ops
from repro.kernels.row_close import row_close_pallas
from repro_torch.core import init_pred
from repro_torch.core.convert import to_numpy, to_torch
from repro_torch.kernels import ops
from repro_torch.kernels import row_close as rc
from repro_torch.core.semiring import get_semiring
from repro_torch.kernels.minplus import minplus_argmin_torch, minplus_torch
from repro_torch.kernels.row_close import row_close_torch

SEMIRINGS = ["tropical", "bottleneck", "reliability", "boolean"]
ZERO_ONE = {"tropical": (np.inf, 0.0), "bottleneck": (-np.inf, np.inf),
            "reliability": (0.0, 1.0), "boolean": (0.0, 1.0)}


@pytest.fixture(params=["xla", "interpret"])
def jax_backend(request, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", request.param)
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    return request.param


def state(seed, n, semiring, ties=False, density=0.5):
    """An (n, n) matrix in the semiring's domain, the one on its diagonal.
    ``ties`` draws from a few values, so many candidates of a row tie."""
    rng = np.random.default_rng(seed)
    if semiring == "boolean":
        vals = np.ones((n, n))
    elif semiring == "reliability":
        vals = (rng.choice([0.25, 0.5, 1.0], size=(n, n)) if ties
                else rng.uniform(0.05, 0.999, size=(n, n)))
    else:
        vals = rng.integers(1, 4, size=(n, n)) if ties else rng.integers(1, 100, size=(n, n))
    zero, one = ZERO_ONE[semiring]
    d = np.where(rng.uniform(size=(n, n)) < density, vals, zero).astype(np.float32)
    np.fill_diagonal(d, one)
    return d


def row_ids(seed, n, r):
    """r row ids with repeats: a drawn list whose last id repeats its first."""
    rows = np.random.default_rng(seed).integers(0, n, r).astype(np.int32)
    rows[-1] = rows[0]
    return rows


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(got, want):
    return np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("n,r", [(40, 6), (130, 13)])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_matches_pallas_interpret(semiring, track, n, r, ties):
    d, rows = state(n + r, n, semiring, ties), row_ids(n, n, r)
    want = row_close_pallas(jnp.asarray(d), jnp.asarray(rows), track=track,
                            interpret=True, semiring=jax_semiring(semiring))
    got = row_close_torch(t(d), t(rows), track=track, semiring=semiring)
    assert same(got[0].numpy(), want[0])
    assert (got[1] is None) == (want[1] is None)
    assert not track or same(got[1].numpy(), want[1])


def test_plain_is_the_gathered_panel_closed_against_d():
    d, rows = state(3, 40, "tropical"), np.array([3, 7, 7, 20, 39, 3], np.int32)
    z, ks = row_close_torch(t(d), t(rows), track=True)
    cand = d[rows][:, :, None] + d[None, :, :]              # (r, k, n)
    best = cand.min(axis=1)
    want = np.minimum(d[rows], best)
    assert same(z.numpy(), want)
    improved = best < d[rows]
    assert same(ks.numpy(), np.where(improved, cand.argmin(axis=1), -1))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("n,r", [(40, 8), (130, 16)])
def test_ops_matches_jax_ops(jax_backend, semiring, with_pred, n, r):
    d, rows = state(2 * n, n, semiring), row_ids(r, n, r)
    p = init_pred(t(d), semiring) if with_pred else None
    want = jax_ops.row_restricted_close(
        jnp.asarray(d), jnp.asarray(rows),
        pred=None if p is None else jnp.asarray(p.numpy()), semiring=semiring)
    got = ops.row_restricted_close(t(d), t(rows), pred=p, semiring=semiring)
    assert same(got[0].numpy(), want[0])
    assert not same(got[0].numpy(), d)                    # the pass moved
    assert not with_pred or same(got[1].numpy(), want[1])


@pytest.mark.parametrize("with_pred", [False, True])
def test_ops_bf16_tropical_matches_jax(jax_backend, with_pred):
    n, rows = 64, row_ids(5, 64, 12)
    d32 = state(9, n, "tropical")
    d32[d32 != np.inf] *= 3.7                         # values bf16 rounds
    d = to_torch(to_numpy(t(d32).bfloat16())[0], dtype="bfloat16")
    p = init_pred(d) if with_pred else None
    want = jax_ops.row_restricted_close(
        jnp.asarray(d32).astype(jnp.bfloat16), jnp.asarray(rows),
        pred=None if p is None else jnp.asarray(p.numpy()))
    got = ops.row_restricted_close(d, t(rows), pred=p)
    assert got[0].dtype == torch.bfloat16
    assert same(to_numpy(got[0])[0], np.asarray(want[0]).view(np.uint16))
    assert not with_pred or same(got[1].numpy(), want[1])


def test_ops_rejects_bf16_outside_tropical():
    d = torch.ones((8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        ops.row_restricted_close(d, torch.tensor([0, 1], dtype=torch.int32),
                                 semiring="reliability")


def test_ops_returns_new_tensors_and_leaves_its_inputs():
    d = state(4, 40, "tropical")
    dist, pred = t(d.copy()), init_pred(t(d))
    p0 = pred.clone()
    out, pout = ops.row_restricted_close(dist, torch.tensor([1, 2, 2, 30], dtype=torch.int32),
                                         pred=pred)
    assert same(dist.numpy(), d) and torch.equal(pred, p0)
    assert not same(out.numpy(), d) and not torch.equal(pout, p0)
    untouched = [i for i in range(40) if i not in (1, 2, 30)]
    assert same(out.numpy()[untouched], d[untouched])
    assert torch.equal(pout[untouched], p0[untouched])


def test_plain_row_ids_out_of_range_raise_and_count_no_launch():
    before = rc.launches["row_close"]
    with pytest.raises(IndexError):
        row_close_torch(t(state(1, 8, "tropical")), torch.tensor([0, 8], dtype=torch.int32))
    assert rc.launches["row_close"] == before


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("r", [1, 3, 4, 16, 33])
@pytest.mark.parametrize("ties", [False, True])
def test_plain_pred_matches_jax_ops(jax_backend, semiring, r, ties):
    """The plain pred mode (the witness fold, then pred_from_kstar) against
    the JAX pass with preds: the panel rows of its new dist and pred."""
    n = 40
    d = state(3 * r + n, n, semiring, ties)
    rows = row_ids(r + 7, n, r)
    p = init_pred(t(d), semiring)
    want_d, want_p = jax_ops.row_restricted_close(
        jnp.asarray(d), jnp.asarray(rows), pred=jnp.asarray(p.numpy()), semiring=semiring)
    z, pz = rc.row_close_pred_torch(t(d), t(rows), p, semiring=semiring)
    assert same(z.numpy(), np.asarray(want_d)[rows])
    assert pz.dtype == torch.int32 and same(pz.numpy(), np.asarray(want_p)[rows])


def split_fold(d, rows, chunk, track, semiring):
    """What the kernel does with k split into chunks of ``chunk``: each chunk
    folded from the semiring zero into a partial (value, global k), the
    partials folded in ascending chunk order from the zero with the strict
    better, then the start value d[rows] folded in last."""
    sr = get_semiring(semiring)
    x = d.index_select(0, rows.long())
    v = torch.full(x.shape, sr.zero)
    k = torch.full(x.shape, -1, dtype=torch.int32)
    for k0 in range(0, d.shape[0], chunk):
        xs, ys = x[:, k0:k0 + chunk], d[k0:k0 + chunk]
        if track:
            pv, pk = minplus_argmin_torch(xs, ys, semiring=sr)
            won = sr.better(pv, v)
            v, k = torch.where(won, pv, v), torch.where(won, torch.where(pk < 0, pk, pk + k0), k)
        else:
            v = sr.add(v, minplus_torch(xs, ys, semiring=sr))
    if not track:
        return sr.add(x, v), None
    won = sr.better(v, x)
    return torch.where(won, v, x), torch.where(won, k, -1)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("chunk", [1, 5, 16, 33, 70])
def test_split_merge_matches_unsplit_fold(semiring, track, chunk):
    """The split-k merge keeps the bits of the unsplit fold: ties across
    chunks (the first chunk's smallest k wins), chunks whose candidates are
    all the zero, NaN candidates and NaN start values."""
    n = 70
    d = state(chunk, n, semiring, ties=True)
    zero = ZERO_ONE[semiring][0]
    d[:, 16:21] = zero                      # k 16..20: every candidate is the zero
    d[16:21, :] = zero
    if semiring in ("tropical", "bottleneck"):
        d[2, 40] = d[50, 9] = np.nan        # NaN candidates and a NaN start value
    rows = np.array([2, 9, 9, 30, 50, 69, 0], np.int32)
    want = row_close_torch(t(d), t(rows), track=track, semiring=semiring)
    got = split_fold(t(d), t(rows), chunk, track, semiring)
    nan = torch.isnan(want[0])
    assert torch.equal(nan, torch.isnan(got[0]))
    assert torch.equal(got[0][~nan], want[0][~nan])
    assert not track or torch.equal(got[1], want[1])
