"""The port's semiring registry, padding helpers, graph generator and state
conversion against the JAX package's.

Inputs are made with numpy from a seed.  Tolerance: exact — the same
elementwise IEEE operations on the same inputs, and a generator copied line
for line.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
from repro.core import semiring as jsr
from repro_torch.core import graphgen, semiring as tsr
from repro_torch.core.convert import to_numpy, to_torch

NAMES = ["tropical", "bottleneck", "reliability", "boolean"]


def _operands(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50, 50, size=(16, 24)).astype(np.float32)
    y = rng.uniform(-50, 50, size=(16, 24)).astype(np.float32)
    for a in (x, y):
        a[rng.uniform(size=a.shape) < 0.1] = np.inf
        a[rng.uniform(size=a.shape) < 0.1] = -np.inf
        a[rng.uniform(size=a.shape) < 0.05] = np.nan
    x[0, :4] = y[0, :4]                       # ties
    return x, y


def test_registry_names_and_constants_match():
    assert set(tsr.SEMIRINGS) == set(jax_core.SEMIRINGS) == set(NAMES)
    for name in NAMES:
        t, j = tsr.get_semiring(name), jsr.get_semiring(name)
        assert (t.zero, t.one, t.monotone_mul) == (j.zero, j.one, j.monotone_mul)


@pytest.mark.parametrize("name", NAMES)
def test_ops_match_jnp(name):
    t, j = tsr.get_semiring(name), jsr.get_semiring(name)
    x, y = _operands(NAMES.index(name))
    tx, ty, jx, jy = torch.from_numpy(x), torch.from_numpy(y), jnp.asarray(x), jnp.asarray(y)
    pairs = [
        (t.add(tx, ty), j.add(jx, jy)),
        (t.mul(tx, ty), j.mul(jx, jy)),
        (t.reduce(tx, dim=1), j.reduce(jx, axis=1)),
        (t.better(tx, ty), j.better(jx, jy)),
        (t.is_zero(tx), j.is_zero(jx)),
    ]
    for got, want in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want), equal_nan=True)
    clean = np.nan_to_num(x, nan=1.0)
    assert np.array_equal(
        t.argreduce(torch.from_numpy(clean), dim=1).numpy(),
        np.asarray(j.argreduce(jnp.asarray(clean), axis=1)),
    )


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (7, 7), (100, 64)])
def test_padding_matches_jnp(name, n, multiple):
    h = np.random.default_rng(n).uniform(1, 9, size=(n, n)).astype(np.float32)
    got = tsr.pad_to_multiple(torch.from_numpy(h), multiple, name)
    want = jsr.pad_to_multiple(jnp.asarray(h), multiple, name)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tsr.unpad(got, n).numpy(), np.asarray(jsr.unpad(want, n)))
    assert np.array_equal(
        tsr.semiring_eye(n, name, device="cpu").numpy(), np.asarray(jsr.semiring_eye(n, name))
    )


def test_ceil_log2_matches():
    for n in [0, 1, 2, 3, 4, 5, 255, 256, 257, 8191, 8192]:
        assert tsr.ceil_log2(n) == jsr.ceil_log2(n)


def test_get_semiring_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown semiring"):
        tsr.get_semiring("nope")


def test_register_semiring_adds_an_entry():
    custom = tsr.Semiring(
        name="tropical_copy", add=torch.minimum, mul=torch.add,
        zero=float("inf"), one=0.0, reduce=torch.amin,
        argreduce=torch.argmin, better=tsr.TROPICAL.better,
    )
    try:
        assert tsr.register_semiring(custom) is custom
        assert tsr.get_semiring("tropical_copy") is custom
    finally:
        tsr.SEMIRINGS.pop("tropical_copy")


@pytest.mark.parametrize("seed,n,rho", [(0, 1, None), (1, 50, None), (2, 200, 2.0)])
def test_generate_np_matches_bit_for_bit(seed, n, rho):
    got = graphgen.generate_np(np.random.default_rng(seed), n, rho=rho)
    want = jax_core.generate_np(np.random.default_rng(seed), n, rho=rho)
    assert got.h.dtype == want.h.dtype == np.float32
    assert np.array_equal(got.h, want.h)
    assert np.array_equal(got.adjacency, want.adjacency)
    assert (got.n_edges, got.rho, got.density) == (want.n_edges, want.rho, want.density)


def test_paper_corpus_and_stats_match():
    got = graphgen.paper_corpus(seed=3, n_graphs=5, v_min=4, v_max=40)
    want = jax_core.paper_corpus(seed=3, n_graphs=5, v_min=4, v_max=40)
    assert all(np.array_equal(a.h, b.h) for a, b in zip(got, want))
    gs, ws = graphgen.graph_stats(got), jax_core.graph_stats(want)
    assert all(np.array_equal(gs[k], ws[k]) for k in ws)


def test_torch_generate_is_seeded_and_in_domain():
    def draw(seed):
        return graphgen.generate(torch.Generator().manual_seed(seed), 40, rho=30.0, alpha=9)

    (h, adj), (h2, adj2) = draw(5), draw(5)
    assert torch.equal(h, h2) and torch.equal(adj, adj2)
    assert not torch.equal(h, draw(6)[0])
    assert torch.all(torch.diagonal(h) == 0) and not adj.diagonal().any()
    edges = h[adj]
    assert torch.all((edges >= 1) & (edges <= 9) & (edges == edges.round()))
    off = ~adj & ~torch.eye(40, dtype=torch.bool)
    assert torch.all(torch.isinf(h[off]))


def test_convert_round_trips_f32_int32_and_bf16_bits():
    rng = np.random.default_rng(9)
    h = rng.uniform(1, 100, size=(12, 12)).astype(np.float32)
    h[0, 1] = np.inf
    pred = rng.integers(-1, 12, size=(12, 12)).astype(np.int32)
    for a in (h, pred):
        t = to_torch(a)
        back, kind = to_numpy(t)
        assert t.dtype == getattr(torch, str(a.dtype)) and kind == str(a.dtype)
        assert np.array_equal(back, a)
    hb = np.asarray(jnp.asarray(h, jnp.bfloat16))           # ml_dtypes bf16
    t = to_torch(hb)
    assert t.dtype == torch.bfloat16
    assert torch.equal(t, torch.from_numpy(h).to(torch.bfloat16))
    bits, kind = to_numpy(t)
    assert kind == "bfloat16" and np.array_equal(bits, hb.view(np.uint16))
    assert torch.equal(to_torch(bits, dtype="bfloat16"), t)
    with pytest.raises(TypeError):
        to_torch(h, dtype="bfloat16")
