"""The port's plain tile closures (``repro_torch.kernels.fw_block``) and its
predecessor helpers against the JAX package's: ``fw_block_pallas`` and
``fw_block_pred_pallas`` in interpret mode, the oracles of
``repro.kernels.ref``, and ``init_pred``, ``pad_pred_to_multiple``,
``pred_from_kstar``, ``minplus_pred`` and ``fw_round_pred``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: exact (``np.array_equal``).  Each pivot step is one rounded
candidate a element and a selective ⊕ (or a strict comparison), so the
steps give the same bits in both packages, negative cycles and NaN
included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import generate

from repro.core.floyd_warshall import init_pred as jax_init_pred
from repro.core.semiring import get_semiring as jax_semiring
from repro.core.semiring import pad_pred_to_multiple as jax_pad_pred
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.fw_block import fw_block_pallas, fw_block_pred_pallas
from repro_torch.core import init_pred, pad_pred_to_multiple
from repro_torch.core.convert import to_numpy, to_torch
from repro_torch.kernels import ops
from repro_torch.kernels.fw_block import fw_block_pred_torch, fw_block_torch

SEMIRINGS = ["tropical", "bottleneck", "reliability", "boolean"]


@pytest.fixture
def xla(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "xla")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def tiles(seed, semiring, b, t=0):
    rng = np.random.default_rng(seed)
    d = np.stack([generate(rng, b, semiring) for _ in range(max(t, 1))])
    return d if t else d[0]


def preds(d, semiring, offset=0):
    """Global-id predecessors of tiles at node offset ``offset``."""
    p = np.stack([np.asarray(jax_init_pred(jnp.asarray(x), semiring)) for x in d.reshape(
        (-1,) + d.shape[-2:])]).reshape(d.shape)
    return np.where(p >= 0, p + offset, p).astype(np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("b,tiles_", [(16, 0), (37, 0), (24, 3)])
def test_fw_block_matches_pallas_interpret_and_ref(semiring, b, tiles_):
    d = tiles(b + tiles_, semiring, b, tiles_)
    sr = jax_semiring(semiring)
    got = fw_block_torch(t(d), semiring=semiring).numpy()
    assert np.array_equal(got, np.asarray(fw_block_pallas(jnp.asarray(d), interpret=True,
                                                          semiring=sr)))
    for k, x in enumerate(d.reshape((-1, b, b))):
        assert np.array_equal(got.reshape((-1, b, b))[k], np.asarray(jax_ref.fw_block_ref(
            jnp.asarray(x), sr)))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("b,tiles_", [(16, 0), (37, 0), (24, 3)])
def test_fw_block_pred_matches_pallas_interpret_and_ref(semiring, b, tiles_):
    d = tiles(2 * b + tiles_, semiring, b, tiles_)
    p = preds(d, semiring, offset=5)
    sr = jax_semiring(semiring)
    z, pz = (o.numpy() for o in fw_block_pred_torch(t(d), t(p), semiring=semiring))
    wz, wp = fw_block_pred_pallas(jnp.asarray(d), jnp.asarray(p), interpret=True, semiring=sr)
    assert np.array_equal(z, np.asarray(wz)) and np.array_equal(pz, np.asarray(wp))
    assert pz.dtype == np.int32
    for k, (x, q) in enumerate(zip(d.reshape((-1, b, b)), p.reshape((-1, b, b)))):
        rz, rp = jax_ref.fw_block_pred_ref(jnp.asarray(x), jnp.asarray(q), sr)
        assert np.array_equal(z.reshape((-1, b, b))[k], np.asarray(rz))
        assert np.array_equal(pz.reshape((-1, b, b))[k], np.asarray(rp))


def test_fw_block_pred_negative_cycle_tile():
    """d[k, k] < 0 after a few steps: step k rewrites row and column k, and
    both packages read the old ones."""
    b = 12
    d = tiles(3, "tropical", b)
    d[2, 7], d[7, 2] = -9.0, 3.0
    d[4, 9], d[9, 4] = -2.0, -1.0
    p = preds(d, "tropical")
    z, pz = (o.numpy() for o in fw_block_pred_torch(t(d), t(p)))
    wz, wp = fw_block_pred_pallas(jnp.asarray(d), jnp.asarray(p), interpret=True,
                                  semiring=jax_semiring("tropical"))
    assert (np.diag(z) < 0).any()
    assert np.array_equal(z, np.asarray(wz)) and np.array_equal(pz, np.asarray(wp))
    assert np.array_equal(fw_block_torch(t(d)).numpy(),
                          np.asarray(fw_block_pallas(jnp.asarray(d), interpret=True)))


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_fw_block_pred_nan_as_jax_ref(semiring):
    b = 10
    d = tiles(4, semiring, b)
    d[3, 6] = np.nan
    d[6, 6] = np.nan
    p = preds(d, semiring)
    z, pz = (o.numpy() for o in fw_block_pred_torch(t(d), t(p), semiring=semiring))
    rz, rp = jax_ref.fw_block_pred_ref(jnp.asarray(d), jnp.asarray(p), jax_semiring(semiring))
    assert np.isnan(z).any()
    assert np.array_equal(z, np.asarray(rz), equal_nan=True)
    assert np.array_equal(pz, np.asarray(rp))


@pytest.mark.parametrize("pred", [False, True])
def test_ops_fw_block_bf16_matches_jax_ops(xla, pred):
    d = jnp.asarray(tiles(5, "tropical", 32, 2), jnp.bfloat16)
    db = to_torch(np.asarray(d))
    if pred:
        p = preds(np.asarray(d.astype(jnp.float32)), "tropical")
        wz, wp = jax_ops.fw_block_pred(d, jnp.asarray(p))
        z, pz = ops.fw_block_pred(db, t(p))
        assert np.array_equal(pz.numpy(), np.asarray(wp))
    else:
        wz, z = jax_ops.fw_block(d), ops.fw_block(db)
    assert z.dtype == torch.bfloat16
    assert np.array_equal(to_numpy(z)[0], np.asarray(wz).view(np.uint16))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("n", [1, 5, 33])
def test_init_pred_matches_jax(semiring, n):
    h = generate(np.random.default_rng(n), n, semiring)
    got = init_pred(t(h), semiring)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jax_init_pred(jnp.asarray(h), semiring)))


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (7, 7), (100, 64), (1, 3)])
def test_pad_pred_to_multiple_matches_jax(n, multiple):
    p = preds(generate(np.random.default_rng(n), n, "tropical"), "tropical")
    got = pad_pred_to_multiple(t(p), multiple)
    assert np.array_equal(got.numpy(), np.asarray(jax_pad_pred(jnp.asarray(p), multiple)))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("k_offset,j_offset", [(0, 0), (8, 8), (8, 0)])
@pytest.mark.parametrize("fallback", [False, True])
def test_pred_from_kstar_matches_jax(batched, k_offset, j_offset, fallback):
    rng = np.random.default_rng(k_offset + 2 * j_offset + fallback)
    lead = (2,) if batched else ()
    m, k, n = 24, 8, 24
    kstar = rng.integers(-1, k, size=lead + (m, n)).astype(np.int32)
    px = rng.integers(-1, 40, size=lead + (m, k)).astype(np.int32)
    py = rng.integers(-1, 40, size=lead + (k, n)).astype(np.int32)
    fb = rng.integers(-1, 40, size=lead + (m, n)).astype(np.int32) if fallback else None
    want = jax_ops.pred_from_kstar(
        jnp.asarray(kstar), jnp.asarray(px), jnp.asarray(py), k_offset=k_offset,
        j_offset=j_offset, fallback=None if fb is None else jnp.asarray(fb))
    got = ops.pred_from_kstar(t(kstar), t(px), t(py), k_offset=k_offset, j_offset=j_offset,
                              fallback=None if fb is None else t(fb))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_minplus_pred_matches_jax(xla, semiring):
    rng = np.random.default_rng(9)
    n, b, o = 48, 16, 16
    d = generate(rng, n, semiring)
    p = preds(d, semiring)
    col, pcol = d[:, o:o + b], p[:, o:o + b]
    piv, ppiv = d[o:o + b, o:o + b], p[o:o + b, o:o + b]
    for acc in (False, True):
        kw = dict(a=col, pa=pcol) if acc else {}
        want = jax_ops.minplus_pred(
            jnp.asarray(col), jnp.asarray(piv), jnp.asarray(pcol), jnp.asarray(ppiv),
            k_offset=o, j_offset=o, semiring=semiring,
            **{k_: jnp.asarray(v) for k_, v in kw.items()})
        got = ops.minplus_pred(t(col), t(piv), t(pcol), t(ppiv), k_offset=o, j_offset=o,
                               semiring=semiring, **{k_: t(v) for k_, v in kw.items()})
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("batched", [False, True])
def test_fw_round_pred_matches_jax(xla, semiring, batched):
    rng = np.random.default_rng(10 + batched)
    n, b = 64, 16
    hs = np.stack([generate(rng, n, semiring) for _ in range(2 if batched else 1)])
    ps = preds(hs, semiring)
    if not batched:
        hs, ps = hs[0], ps[0]
    for o in (0, 32, 48):
        wd, wp = jax_ops.fw_round_pred(jnp.asarray(hs), jnp.asarray(ps), o, block_size=b,
                                       semiring=semiring)
        d, p = ops.fw_round_pred(t(hs), t(ps), o, block_size=b, semiring=semiring)
        assert np.array_equal(d.numpy(), np.asarray(wd)), o
        assert np.array_equal(p.numpy(), np.asarray(wp)), o
        # values equal the fused round's without predecessors
        assert np.array_equal(d.numpy(), ops.fw_round(t(hs), o, block_size=b,
                                                      semiring=semiring).numpy())


def test_fw_round_pred_bf16_matches_jax(xla):
    h = jnp.asarray(generate(np.random.default_rng(12), 64, "tropical"), jnp.bfloat16)
    p = preds(np.asarray(h.astype(jnp.float32)), "tropical")
    for o in (0, 32):
        wd, wp = jax_ops.fw_round_pred(h, jnp.asarray(p), o, block_size=32)
        d, pz = ops.fw_round_pred(to_torch(np.asarray(h)), t(p), o, block_size=32)
        assert np.array_equal(to_numpy(d)[0], np.asarray(wd).view(np.uint16))
        assert np.array_equal(pz.numpy(), np.asarray(wp))
