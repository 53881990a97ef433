"""``repro_torch.solve_batch(hs, device="cpu")`` against per-graph
``repro_torch.solve`` and against ``repro.core.solve_batch``, the port's
``pad_batch`` / ``register_method`` / ``generate_batch`` and the paper's
corpus.  Mirrors ``tests/test_batch_apsp.py`` at ragged sizes up to 64.

Inputs come from ``generate_np`` (tropical, integer weights) or from
``tests/oracle.py::generate`` (in-domain values for the other semirings),
made with numpy from a seed.  The JAX side runs its chunked-XLA folds
without its autotune cache.  Tolerance: exact (``np.array_equal``) for
``dist`` and ``pred``: padding is inert, and every batched product folds
the same candidates as the per-graph one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import generate

import repro.core as jax_core
from repro.core import graphgen as jax_graphgen
import repro_torch
from repro_torch.core import (
    BATCH_METHODS,
    METHODS,
    InputValidationError,
    NegativeCycleError,
    generate_batch,
    generate_np,
    pad_batch,
    paper_corpus,
    register_method,
    solve,
    solve_batch,
    validate_tree,
)
from repro_torch.core import apsp as torch_apsp
from repro_torch.core.convert import to_numpy
from repro_torch.core.semiring import get_semiring

METHOD_KW = {
    "squaring": {},
    "squaring_3d": {},
    "classic": {},
    "blocked_fw": {"block_size": 16},
    "rkleene": {"base": 8},
}
RAGGED_SIZES = [4, 17, 33, 64, 7, 50]      # G = 6, sizes 4..64
SEMIRING_SIZES = [5, 12, 30]


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.setenv("REPRO_KERNELS", "xla")


@pytest.fixture(scope="module")
def ragged():
    rng = np.random.default_rng(0)
    return [generate_np(rng, n).h for n in RAGGED_SIZES]


def in_domain(sizes, semiring, seed=1):
    rng = np.random.default_rng(seed)
    if semiring == "tropical":
        return [generate_np(rng, n).h for n in sizes]
    return [generate(rng, n, semiring) for n in sizes]


def assert_batch_equal(got, want, with_pred):
    assert np.array_equal(got.sizes, np.asarray(want.sizes))
    assert np.array_equal(got.dist.numpy(), np.asarray(want.dist))
    if with_pred:
        assert np.array_equal(got.pred.numpy(), np.asarray(want.pred))
    else:
        assert got.pred is None


@pytest.mark.parametrize("method", sorted(METHOD_KW))
def test_batch_matches_solve_and_jax(method, ragged):
    kw = METHOD_KW[method]
    res = solve_batch(ragged, method=method, device="cpu", **kw)
    assert len(res) == len(ragged) and res.dist.shape == (len(ragged), 64, 64)
    assert res.method == method
    for i, h in enumerate(ragged):
        ref = solve(h, method=method, device="cpu", **kw)
        assert torch.equal(res.unpadded(i).dist, ref.dist), (method, i)
    assert_batch_equal(res, jax_core.solve_batch(ragged, method=method, **kw), False)


@pytest.mark.parametrize("method", ["squaring", "classic", "blocked_fw", "rkleene"])
def test_batch_pred_matches_solve_and_jax(method, ragged):
    kw = METHOD_KW[method]
    res = solve_batch(ragged, method=method, with_pred=True, device="cpu", **kw)
    for i, h in enumerate(ragged):
        ref = solve(h, method=method, with_pred=True, device="cpu", **kw)
        u = res.unpadded(i)
        assert torch.equal(u.dist, ref.dist) and torch.equal(u.pred, ref.pred), (method, i)
        assert validate_tree(h, u.dist, u.pred), (method, i)
    assert_batch_equal(res, jax_core.solve_batch(ragged, method=method, with_pred=True, **kw),
                       True)


@pytest.mark.parametrize("method", sorted(METHOD_KW))
@pytest.mark.parametrize("semiring", ["bottleneck", "reliability", "boolean"])
def test_batch_semirings_match_jax(semiring, method):
    """The other three semirings, with predecessors where the method
    carries them (``squaring_3d`` takes them on the squaring path)."""
    mats = in_domain(SEMIRING_SIZES, semiring)
    kw = METHOD_KW[method]
    res = solve_batch(mats, method=method, with_pred=True, semiring=semiring, device="cpu",
                      **kw)
    want = jax_core.solve_batch(mats, method=method, with_pred=True, semiring=semiring, **kw)
    assert_batch_equal(res, want, True)
    for i, h in enumerate(mats):
        ref = solve(h, method=method, with_pred=True, semiring=semiring, device="cpu", **kw)
        assert torch.equal(res.unpadded(i).dist, ref.dist)
        assert torch.equal(res.unpadded(i).pred, ref.pred)


@pytest.mark.parametrize("method", ["squaring", "blocked_fw", "rkleene"])
def test_bucketed_equals_single_stack(method, ragged):
    kw = METHOD_KW[method]
    a = solve_batch(ragged, method=method, with_pred=True, device="cpu", **kw)
    b = solve_batch(ragged, method=method, with_pred=True, bucket_by_size=True, device="cpu",
                    **kw)
    assert torch.equal(a.dist, b.dist) and torch.equal(a.pred, b.pred)
    assert np.array_equal(a.sizes, b.sizes)


@pytest.mark.parametrize("method", ["squaring", "blocked_fw"])
def test_bucketed_matches_jax(method, ragged):
    kw = METHOD_KW[method]
    got = solve_batch(ragged, method=method, bucket_by_size=True, n_max=70, device="cpu", **kw)
    want = jax_core.solve_batch(ragged, method=method, bucket_by_size=True, n_max=70, **kw)
    assert got.dist.shape == (len(ragged), 70, 70)
    assert_batch_equal(got, want, False)


@pytest.mark.parametrize("method", ["squaring", "blocked_fw", "rkleene"])
def test_batch_bf16_matches_jax(method, ragged):
    kw = METHOD_KW[method]
    for bucket in (False, True):
        got = solve_batch(ragged[:4], method=method, dtype=torch.bfloat16,
                          bucket_by_size=bucket, device="cpu", **kw)
        want = jax_core.solve_batch(ragged[:4], method=method, dtype=jnp.bfloat16,
                                    bucket_by_size=bucket, **kw)
        dist, kind = to_numpy(got.dist)
        assert kind == "bfloat16"
        assert np.array_equal(dist, np.asarray(want.dist).view(np.uint16)), bucket


def test_pad_batch_shapes_and_padding():
    rng = np.random.default_rng(1)
    mats = [generate_np(rng, n).h for n in (3, 9, 5)]
    stack, sizes = pad_batch(mats, n_max=16, device="cpu")
    assert stack.shape == (3, 16, 16) and stack.dtype == torch.float32
    assert list(sizes) == [3, 9, 5]
    s = stack.numpy()
    assert np.array_equal(s[0, :3, :3], mats[0])
    assert np.isinf(s[0, 3:, :3]).all() and np.isinf(s[0, :3, 3:]).all()
    assert (np.diag(s[0]) == 0).all()
    want, _ = jax_core.pad_batch(mats, n_max=16)
    assert np.array_equal(s, np.asarray(want))
    # a full-size float32 stack on the device passes through as itself
    stack2, sizes2 = pad_batch(stack, device="cpu")
    assert stack2 is stack and list(sizes2) == [16, 16, 16]
    with pytest.raises(ValueError):
        pad_batch(mats, n_max=8, device="cpu")
    with pytest.raises(ValueError):
        pad_batch([], device="cpu")
    with pytest.raises(ValueError):
        pad_batch(stack, [17, 3, 3], device="cpu")


@pytest.mark.parametrize("semiring", ["tropical", "bottleneck", "reliability", "boolean"])
def test_pad_batch_padding_is_the_semirings(semiring):
    mats = in_domain([3, 6], semiring)
    stack, _ = pad_batch(mats, semiring=semiring, device="cpu")
    want, _ = jax_core.pad_batch(mats, semiring=semiring)
    assert np.array_equal(stack.numpy(), np.asarray(want))
    sr = get_semiring(semiring)
    assert stack[0, 4, 4] == sr.one and stack[0, 0, 5] == sr.zero


def test_pad_batch_reinertizes_poisoned_padding():
    """A pre-stacked input whose padding region holds garbage (0.0
    off-diagonal = free phantom shortcuts under tropical) is re-inertized,
    not trusted."""
    rng = np.random.default_rng(3)
    n_true, edge = 6, 12
    graphs = [generate_np(rng, n_true).h for _ in range(2)]
    stack = np.zeros((2, edge, edge), np.float32)      # deliberately poisoned
    for i, h in enumerate(graphs):
        stack[i, :n_true, :n_true] = h
    sizes = [n_true, n_true]

    packed, out_sizes = pad_batch(stack, sizes, device="cpu")
    s = packed.numpy()
    assert s.shape == (2, edge, edge) and list(out_sizes) == sizes
    assert np.isinf(s[:, n_true:, :n_true]).all()      # rows re-inertized
    assert np.isinf(s[:, :n_true, n_true:]).all()      # cols re-inertized
    assert (np.diagonal(s, axis1=1, axis2=2)[:, n_true:] == 0).all()
    assert np.array_equal(s, np.asarray(jax_core.pad_batch(stack, sizes)[0]))

    for poisoned in (stack, torch.from_numpy(stack)):
        res = solve_batch(poisoned, sizes, method="classic", device="cpu")
        for i, h in enumerate(graphs):
            ref = solve(h, method="classic", device="cpu")
            assert torch.equal(res.unpadded(i).dist, ref.dist), i


@pytest.mark.parametrize("bucket", [False, True])
def test_solve_batch_accepts_stack_and_sizes(bucket):
    rng = np.random.default_rng(2)
    mats = [generate_np(rng, n).h for n in (6, 11)]
    stack, sizes = pad_batch(mats, n_max=16, device="cpu")
    res = solve_batch(stack, sizes, method="squaring", bucket_by_size=bucket, device="cpu")
    # the bucketed frame's edge is the largest graph's, unless n_max says
    assert res.dist.shape == ((2, 11, 11) if bucket else (2, 16, 16))
    want = jax_core.solve_batch(stack.numpy(), sizes, method="squaring", bucket_by_size=bucket)
    assert np.array_equal(res.dist.numpy(), np.asarray(want.dist))
    for i, m in enumerate(mats):
        ref = solve(m, method="squaring", device="cpu")
        assert torch.equal(res.unpadded(i).dist, ref.dist)


def test_solve_batch_leaves_a_full_stack_unchanged():
    """A full-size float32 stack on the device is the caller's tensor, so by
    default the in-place fused round copies it first."""
    rng = np.random.default_rng(4)
    stack = torch.from_numpy(np.stack([generate_np(rng, 20).h for _ in range(3)]))
    before = stack.clone()
    res = solve_batch(stack, method="blocked_fw", block_size=8, device="cpu")
    assert torch.equal(stack, before)
    for i in range(3):
        assert torch.equal(res.dist[i], solve(before[i], block_size=8, device="cpu").dist)


def test_solve_batch_unknown_method():
    with pytest.raises(ValueError, match="unknown APSP method"):
        solve_batch(np.zeros((2, 4, 4), np.float32), method="nope", device="cpu")


def test_solve_batch_validates():
    rng = np.random.default_rng(5)
    mats = [generate_np(rng, n).h for n in (5, 8)]
    mats[1][2, 3] = np.nan
    for bucket in (False, True):
        with pytest.raises(InputValidationError):
            solve_batch(mats, bucket_by_size=bucket, device="cpu")
    # a negative cycle in graph 1 only; the padding of graph 0 is not checked
    good = generate_np(rng, 5).h
    bad = generate_np(rng, 8).h
    bad[0, 1], bad[1, 0] = -5.0, 1.0
    for bucket in (False, True):
        with pytest.raises(NegativeCycleError):
            solve_batch([good, bad], bucket_by_size=bucket, device="cpu")
        solve_batch([good, bad], validate=False, bucket_by_size=bucket, device="cpu")
    solve_batch([good], n_max=8, device="cpu")


def test_register_method_drops_a_stale_batch_solver():
    calls = []

    def per_graph(h, with_pred, semiring=None, **kw):
        calls.append(tuple(h.shape))
        return METHODS["classic"](h, with_pred, semiring=semiring)

    def batched(hs, with_pred, **kw):
        raise AssertionError("stale batch solver")

    try:
        register_method("probe", per_graph, batched)
        assert BATCH_METHODS["probe"] is batched
        register_method("probe", per_graph)
        assert "probe" not in BATCH_METHODS
        rng = np.random.default_rng(6)
        mats = [generate_np(rng, n).h for n in (5, 9, 3)]
        res = solve_batch(mats, method="probe", with_pred=True, device="cpu")
        # the loop runs each padded slice, as jax.vmap does
        assert calls == [(9, 9)] * 3
        for i, h in enumerate(mats):
            ref = solve(h, method="classic", with_pred=True, device="cpu")
            assert torch.equal(res.unpadded(i).dist, ref.dist)
            assert torch.equal(res.unpadded(i).pred, ref.pred)
    finally:
        METHODS.pop("probe", None)
        BATCH_METHODS.pop("probe", None)


def test_bucket_rules_match_jax():
    from repro.core import apsp as jax_apsp

    for n in (1, 4, 8, 9, 17, 64, 65, 1000, 1024):
        assert torch_apsp._bucket_edge(n) == jax_apsp._bucket_edge(n)
    for c in (1, 2, 3, 5, 8, 9, 16, 17, 490):
        assert torch_apsp._bucket_count(c) == jax_apsp._bucket_count(c)


def test_generate_batch_invariants():
    gen = torch.Generator().manual_seed(3)
    sizes = [5, 12, 30]
    h, adj, out_sizes = generate_batch(gen, sizes, alpha=10)
    assert h.shape == (3, 30, 30) and adj.shape == (3, 30, 30)
    assert out_sizes.dtype == torch.int32 and out_sizes.tolist() == sizes
    h, adj = h.numpy(), adj.numpy()
    for i, n in enumerate(sizes):
        assert (np.diag(h[i]) == 0).all()
        assert not adj[i].diagonal().any()
        # outside the true block: phantom nodes, no edges
        off = ~np.eye(30, dtype=bool)
        outside = np.ones((30, 30), bool)
        outside[:n, :n] = False
        assert np.isinf(h[i][outside & off]).all()
        assert not adj[i][n:, :].any() and not adj[i][:, n:].any()
        # live entries: integer costs in [1, alpha], inf exactly off the edges
        live = adj[i]
        vals = h[i][live]
        assert ((vals >= 1) & (vals <= 10)).all() and np.array_equal(vals, np.round(vals))
        assert np.isinf(h[i][:n, :n][~live[:n, :n] & off[:n, :n]]).all()
    # one seed, one corpus; the solver takes the stack directly
    again = generate_batch(torch.Generator().manual_seed(3), sizes, alpha=10)[0]
    assert np.array_equal(again.numpy(), h)
    res = solve_batch(torch.from_numpy(h), out_sizes.numpy(), method="squaring", device="cpu")
    assert res.dist.shape == (3, 30, 30)
    for i, n in enumerate(sizes):
        ref = solve(h[i][:n, :n], device="cpu")
        assert torch.equal(res.unpadded(i).dist, ref.dist)


def test_generate_batch_fixed_rho_and_n_max():
    gen = torch.Generator().manual_seed(4)
    h, adj, _ = generate_batch(gen, [6, 6], n_max=10, rho=0.0)
    assert h.shape == (2, 10, 10) and not adj.any()
    assert torch.equal(h[0], torch.from_numpy(
        np.where(np.eye(10, dtype=bool), 0.0, np.inf).astype(np.float32)))


def test_paper_corpus_matches_jax():
    got = paper_corpus(seed=7, n_graphs=12, v_max=40)
    want = jax_graphgen.paper_corpus(seed=7, n_graphs=12, v_max=40)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert a.n_nodes == b.n_nodes and a.n_edges == b.n_edges and a.rho == b.rho
        assert np.array_equal(a.h, b.h) and np.array_equal(a.adjacency, b.adjacency)
    assert [g.n_edges for g in got] == sorted(g.n_edges for g in got)


def test_corpus_through_solve_batch():
    """A small corpus end to end: bucketed equals single stack equals the
    per-graph solve, and equals the JAX package's batch."""
    corpus = paper_corpus(seed=1, n_graphs=10, v_max=60)
    hs = [g.h for g in corpus]
    single = solve_batch(hs, with_pred=True, device="cpu")
    bucketed = solve_batch(hs, with_pred=True, bucket_by_size=True, device="cpu")
    assert torch.equal(single.dist, bucketed.dist) and torch.equal(single.pred, bucketed.pred)
    want = jax_core.solve_batch(hs, with_pred=True)
    assert_batch_equal(single, want, True)
    for i, h in enumerate(hs):
        assert torch.equal(single.unpadded(i).dist, repro_torch.solve(h, device="cpu").dist)
