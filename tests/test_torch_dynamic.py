"""The port's dynamic engine (``repro_torch.DynamicAPSP`` on the CPU)
against the JAX package's ``repro.core.DynamicAPSP`` on the same update
streams.

Both engines start from one numpy cost matrix and take the same batches
(``generate_edge_updates`` from one seed: the port's copy gives the same
arrays as the JAX one).  After every update the two must hold the same
``dist``, ``pred``, ``h``, info dict, ``stats`` and ``version``.
Tolerance: exact (``np.array_equal``; bf16 compared as its bit view).
Integer tropical weights and reliability products are one rounded
operation a candidate under a selective ⊕, and the JAX package's own
backends agree bit for bit, so every decision (thresholds, row lists, pass
counts) falls the same way in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import DynamicAPSP as JaxDynamicAPSP
from repro.core import solve as jax_solve
from repro.core.dynamic import UpdateJournal as JaxUpdateJournal
from repro.core.graphgen import generate_edge_updates as jax_generate_edge_updates
from repro.core.graphgen import generate_np
from repro.kernels import ops as jax_ops
from repro_torch import DynamicAPSP, UpdateError, UpdateJournal, generate_edge_updates
from repro_torch.core import dynamic as port_dynamic
from repro_torch.core.convert import to_numpy
from repro_torch.kernels import ops

SIZES = (24, 37, 64)


def host(a):
    """A JAX array or a port tensor as a host array, bf16 as its bit view."""
    if isinstance(a, torch.Tensor):
        return to_numpy(a)[0]
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def engines(h, *, dtype=None, **kw):
    """The JAX engine and the port's on the CPU, built alike."""
    jkw, pkw = dict(kw), dict(kw)
    if dtype is not None:
        jkw["dtype"], pkw["dtype"] = jnp.bfloat16, torch.bfloat16
    return JaxDynamicAPSP(h, **jkw), DynamicAPSP(h, device="cpu", **pkw)


def assert_same_state(jeng, peng, where=""):
    assert np.array_equal(host(jeng.dist), host(peng.dist)), where
    assert (jeng.pred is None) == (peng.pred is None), where
    if jeng.pred is not None:
        assert np.array_equal(host(jeng.pred), host(peng.pred)), where
    assert np.array_equal(jeng.h, peng.h), where
    assert jeng.stats == peng.stats, where
    assert jeng.version == peng.version, where


def apply(jeng, peng, u, v=None, w=None):
    """One batch to both engines; their info dicts and states must agree."""
    ji = jeng.update(u, v, w)
    pi = peng.update(u, v, w)
    assert ji == pi
    assert_same_state(jeng, peng, ji)
    return pi


def _worsen(rng, h, k):
    """Worsen k existing finite edges (integer deltas keep tropical exact)."""
    fin = np.argwhere(np.isfinite(h) & (h > 0))
    idx = fin[rng.choice(len(fin), size=min(k, len(fin)), replace=False)]
    u, v = idx[:, 0].astype(np.int32), idx[:, 1].astype(np.int32)
    return u, v, (h[u, v] + rng.integers(50, 300, size=len(u))).astype(np.float32)


def _reliability(rng, n):
    p = np.zeros((n, n), np.float32)
    edge = rng.uniform(size=(n, n)) < 0.4
    np.fill_diagonal(edge, False)
    p[edge] = rng.uniform(0.05, 0.95, size=int(edge.sum()))
    np.fill_diagonal(p, 1.0)
    return p


def test_update_stream_is_the_jax_one():
    h = generate_np(np.random.default_rng(0), 50, rho=30.0).h
    for wf in (0.0, 0.5, 1.0):
        got = generate_edge_updates(np.random.default_rng(1), h, 16, worsen_frac=wf)
        want = jax_generate_edge_updates(np.random.default_rng(1), h, 16, worsen_frac=wf)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("worsen_frac", [0.0, 0.5, 1.0])
def test_streams_match_jax(n, with_pred, donate, worsen_frac):
    rng = np.random.default_rng(n + 10 * with_pred + 100 * int(2 * worsen_frac))
    h = generate_np(rng, n, rho=40.0).h
    jeng, peng = engines(h, with_pred=with_pred, donate=donate, block_size=16)
    assert_same_state(jeng, peng)
    for _ in range(4):
        apply(jeng, peng, *generate_edge_updates(rng, peng.h, int(rng.integers(1, 9)),
                                                 worsen_frac=worsen_frac))
    ref = jax_solve(peng.h, with_pred=with_pred, block_size=16)
    assert np.array_equal(host(peng.dist), np.asarray(ref.dist))
    if with_pred:
        assert repro_torch.validate_tree(peng.h, peng.dist, peng.pred)


@pytest.mark.parametrize("with_pred", [False, True])
def test_worsening_row_resolve_matches_jax(with_pred):
    rng = np.random.default_rng(3)
    jeng, peng = engines(generate_np(rng, 48, rho=40.0).h, with_pred=with_pred,
                         block_size=16, resolve_threshold=1.0, row_threshold=1.0)
    for _ in range(5):
        info = apply(jeng, peng, *_worsen(rng, peng.h, int(rng.integers(1, 6))))
        assert info["path"] in ("row_resolve", "noop")
    assert peng.stats["row_resolve"] >= 1 and peng.stats["row_iters"] >= 1


def test_reliability_matches_jax():
    rng = np.random.default_rng(4)
    jeng, peng = engines(_reliability(rng, 24), semiring="reliability", block_size=8,
                         resolve_threshold=1.0, row_threshold=1.0)
    for step in range(6):
        h = peng.h
        fin = np.argwhere((h > 0) & (h < 1.0))
        i, j = map(int, fin[int(rng.integers(0, len(fin)))])
        w = float(h[i, j]) * 0.25 if step % 2 == 0 else min(0.99, float(h[i, j]) + 0.5)
        apply(jeng, peng, [(i, j, w)])
    assert peng.stats["row_resolve"] >= 1 and peng.stats["rank_k"] >= 1


@pytest.mark.parametrize("with_pred", [False, True])
def test_bf16_tropical_engine_matches_jax(with_pred):
    rng = np.random.default_rng(5)
    h = generate_np(rng, 37, rho=40.0).h
    h[np.isfinite(h)] *= 3.7                       # weights that bf16 rounds
    np.fill_diagonal(h, 0.0)
    jeng, peng = engines(h, dtype="bf16", with_pred=with_pred, block_size=16,
                         resolve_threshold=1.0)
    assert peng.dist.dtype == torch.bfloat16
    for _ in range(4):
        apply(jeng, peng, *generate_edge_updates(rng, peng.h, 6, worsen_frac=0.5))
        assert peng.dist.dtype == torch.bfloat16
    assert peng.stats["rank_k"] >= 1 and peng.stats["row_resolve"] + peng.stats["warm_resolve"] >= 1


@pytest.mark.parametrize("semiring", ["bottleneck", "boolean"])
def test_plateau_fallback_matches_jax(semiring):
    rng = np.random.default_rng(6)
    g = generate_np(rng, 20, rho=40.0)
    if semiring == "bottleneck":
        h = np.where(np.isfinite(g.h), g.h, -np.inf).astype(np.float32)
        np.fill_diagonal(h, np.inf)
        batches = [[(0, 5, 120.0)], [(1, 2, 3.0)], [(0, 5, 120.0)]]
    else:
        h = np.isfinite(g.h).astype(np.float32)
        batches = [[(0, 5, 1.0)], [(1, 2, 0.0)], [(0, 5, 1.0)]]
    jeng, peng = engines(h, semiring=semiring, with_pred=True, block_size=8)
    for batch in batches:
        info = apply(jeng, peng, batch)
        assert info["path"] in ("full_resolve", "noop")
    assert peng.stats["full_resolve"] >= 1
    with pytest.raises(ValueError, match="plateau"):
        peng.path(0, 1)


def _probe(h, batch, **kw):
    """(affected_frac, affected_rows) of a worsening batch on a fresh pair."""
    jeng, peng = engines(h, resolve_threshold=1.0, row_threshold=1.0, **kw)
    info = apply(jeng, peng, *batch)
    return info["affected_frac"], info["affected_rows"]


@pytest.mark.parametrize("with_pred", [False, True])
def test_threshold_boundaries_force_each_path(with_pred):
    rng = np.random.default_rng(7)
    n = 40
    h = generate_np(rng, n, rho=30.0).h
    kw = dict(with_pred=with_pred, block_size=16)
    batch = None
    for _ in range(20):
        cand = _worsen(rng, h, 3)
        frac, r = _probe(h, cand, **kw)
        if r > 1:
            batch = cand
            break
    assert batch is not None
    seen = {}
    for resolve, row in (
        (frac, 1.0),                       # frac == threshold: not above it
        (np.nextafter(frac, 0.0), 1.0),    # just below frac: the full solver
        (1.0, r / n),                      # r == threshold * n: the rows
        (1.0, (r - 0.5) / n),              # just below: the warm re-solve
    ):
        jeng, peng = engines(h, resolve_threshold=float(resolve), row_threshold=float(row), **kw)
        seen[(resolve, row)] = apply(jeng, peng, *batch)["path"]
    assert list(seen.values()) == ["row_resolve", "full_resolve", "row_resolve", "warm_resolve"]

    jeng, peng = engines(h, **kw)
    paths = set()
    u, v, w = batch
    paths.add(apply(jeng, peng, u, v, peng.h[u, v])["path"])                # same weights
    paths.add(apply(jeng, peng, *generate_edge_updates(rng, peng.h, 4))["path"])
    ud, vd, wd = generate_edge_updates(rng, peng.h, 3)
    uw, vw, ww = _worsen(rng, peng.h, 2)
    jm, pm = engines(peng.h, resolve_threshold=1.0, row_threshold=1.0, **kw)
    paths.add(apply(jm, pm, np.r_[uw, ud], np.r_[vw, vd], np.r_[ww, wd])["path"])
    assert {"noop", "rank_k"} <= paths
    assert paths & {"row_resolve+rank_k", "warm_resolve+rank_k"}


def test_rollback_leaves_state_unchanged(monkeypatch):
    rng = np.random.default_rng(8)
    h = generate_np(rng, 37, rho=40.0).h
    jeng, peng = engines(h, with_pred=True, block_size=16, resolve_threshold=1.0,
                         row_threshold=1.0)
    batch = _worsen(rng, peng.h, 3)
    d0, p0, h0 = peng.dist.clone(), peng.pred.clone(), peng.h
    stats0, version0 = dict(peng.stats), peng.version

    def boom(*args, **kwargs):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(port_dynamic, "_row_close", boom)
    with pytest.raises(RuntimeError, match="injected"):
        peng.update(*batch)
    assert np.array_equal(peng.h, h0) and torch.equal(peng.dist, d0)
    assert torch.equal(peng.pred, p0)
    assert peng.stats == stats0 and peng.version == version0
    monkeypatch.undo()
    apply(jeng, peng, *batch)                     # the retry applies the whole delta

    # a mixed batch whose decrease phase raises keeps the committed worsening
    monkeypatch.setattr(port_dynamic, "_rank_k_fixpoint", boom)
    uw, vw, ww = _worsen(rng, peng.h, 2)
    ud, vd, wd = generate_edge_updates(rng, peng.h, 2)
    before = peng.h
    with pytest.raises(RuntimeError, match="injected"):
        peng.update(np.r_[uw, ud], np.r_[vw, vd], np.r_[ww, wd])
    assert np.array_equal(peng.h[uw, vw], ww)
    assert np.array_equal(peng.h[ud, vd], before[ud, vd])
    ref = jax_solve(peng.h, block_size=16)
    assert np.array_equal(host(peng.dist), np.asarray(ref.dist))


@pytest.mark.parametrize("donate", [False, True])
def test_donate_decides_what_old_handles_show(donate):
    rng = np.random.default_rng(9)
    peng = DynamicAPSP(generate_np(rng, 37, rho=40.0).h,
                       with_pred=True, donate=donate, block_size=16, device="cpu",
                       resolve_threshold=1.0)
    for batch in (generate_edge_updates(rng, peng.h, 6),
                  generate_edge_updates(rng, peng.h, 6, worsen_frac=1.0)):
        d_handle, p_handle = peng.dist, peng.pred
        d_before, p_before = d_handle.clone(), p_handle.clone()
        info = peng.update(*batch)
        assert info["path"] != "noop" and not torch.equal(peng.dist, d_before)
        if donate:        # in place: the old handles are the engine's tensors
            assert d_handle is peng.dist and p_handle is peng.pred
        else:             # the old handles keep their values
            assert torch.equal(d_handle, d_before) and torch.equal(p_handle, p_before)


def test_validation_errors_match_jax():
    rng = np.random.default_rng(10)
    jeng, peng = engines(generate_np(rng, 16, rho=40.0).h, block_size=8)
    for bad in (
        ([(1.7, 2, 3.0)],),
        (np.array([0.5]), np.array([2]), np.array([3.0])),
        ([(4, 4, 1.0)],),
        ([(0, 99, 1.0)],),
        ([(0, 3, -1.0)],),
        ([(0, 3, np.nan)],),
        (np.array([0, 1]), np.array([2]), np.array([3.0])),
    ):
        with pytest.raises(ValueError) as want:
            jeng.update(*bad)
        with pytest.raises(UpdateError) as got:
            peng.update(*bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="triples"):
        peng.update([(1, 2)])
    assert_same_state(jeng, peng)
    apply(jeng, peng, [(2, 3, 50.0), (2, 3, 7.0)])         # last write wins
    assert peng.h[2, 3] == 7.0
    assert apply(jeng, peng, [(2, 3, 7.0)])["path"] == "noop"
    assert apply(jeng, peng, [])["path"] == "noop"
    apply(jeng, peng, np.array([1.0]), np.array([2.0]), np.array([3.0]))
    with pytest.raises(ValueError, match="square"):
        DynamicAPSP(np.zeros((3, 4), np.float32), device="cpu")


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rank_k_update_matches_jax(with_pred, dtype):
    rng = np.random.default_rng(11)
    g = generate_np(rng, 40, rho=30.0)
    res = jax_solve(g.h, with_pred=True, block_size=16)
    dist, pred = np.asarray(res.dist), np.asarray(res.pred)
    u, v, w = generate_edge_updates(rng, g.h, 8)
    dist, pred = dist.copy(), pred.copy()
    jd = jnp.asarray(dist).astype(dtype)
    # as the JAX engine runs it: under jit, where a bf16 x is not rounded
    rank_k = jax.jit(lambda d, uu, vv, ww, p: jax_ops.rank_k_update(d, uu, vv, ww, pred=p))
    want = rank_k(jd, jnp.asarray(u), jnp.asarray(v), jnp.asarray(w).astype(dtype),
                  jnp.asarray(pred) if with_pred else None)
    td = getattr(torch, dtype)
    got = ops.rank_k_update(torch.from_numpy(dist).to(td), torch.from_numpy(u),
                            torch.from_numpy(v), torch.from_numpy(w).to(td),
                            pred=torch.from_numpy(pred) if with_pred else None)
    assert np.array_equal(host(got[0]), host(want[0]))
    assert not np.array_equal(host(got[0]), host(jd))          # the pass moved
    assert not with_pred or np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_journal_replays_across_packages(tmp_path, direction):
    rng = np.random.default_rng(12)
    h = generate_np(rng, 37, rho=40.0).h
    path = str(tmp_path / "journal.jsonl")
    kw = dict(with_pred=True, block_size=16)
    if direction == "jax_to_port":
        writer = JaxDynamicAPSP(h, journal=JaxUpdateJournal(path), **kw)
    else:
        writer = DynamicAPSP(h, journal=UpdateJournal(path), device="cpu", **kw)
    for wf in (0.0, 0.5, 1.0, 0.5):
        writer.update(*generate_edge_updates(rng, writer.h, 6, worsen_frac=wf))
    writer.journal.close()
    if direction == "jax_to_port":
        reader, journal = DynamicAPSP(h, device="cpu", **kw), UpdateJournal(path)
    else:
        reader, journal = JaxDynamicAPSP(h, **kw), JaxUpdateJournal(path)
    assert journal.replay_onto(reader) == len(journal) >= 4
    assert np.array_equal(reader.h, writer.h)
    assert np.array_equal(host(reader.dist), host(writer.dist))
    assert np.array_equal(host(reader.pred), host(writer.pred))
    assert reader.version == writer.version and reader.stats == writer.stats
    journal.close()
    with open(path, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    assert all(line.startswith('{"seq": ') for line in lines)


def test_paths_probe_snapshot_and_state_match_jax():
    n = 10
    h = np.full((n, n), np.inf, np.float32)
    np.fill_diagonal(h, 0.0)
    for i in range(n - 1):
        h[i, i + 1] = 1.0
    jeng, peng = engines(h, with_pred=True, block_size=8)
    for i, j, ml in ((0, n - 1, None), (0, n - 1, 3), (n - 1, 0, None), (4, 4, None)):
        assert peng.path(i, j, max_len=ml) == jeng.path(i, j, max_len=ml)
    apply(jeng, peng, [(0, n - 1, 1.0)])
    assert peng.path(0, n - 1) == jeng.path(0, n - 1) == [0, n - 1]
    assert peng.health_probe() == jeng.health_probe()
    snap = peng.snapshot()
    apply(jeng, peng, [(2, 7, 1.0)])
    assert not np.array_equal(snap["dist"].numpy(), host(peng.dist))
    back = DynamicAPSP(snap["h"], with_pred=True, block_size=8, device="cpu", state=snap)
    assert back.version == snap["version"]
    assert torch.equal(back.dist, snap["dist"]) and torch.equal(back.pred, snap["pred"])
    jstate = jeng.snapshot()                      # a JAX snapshot installs too
    other = DynamicAPSP(jstate["h"], with_pred=True, block_size=8, device="cpu", state=jstate)
    assert np.array_equal(host(other.dist), host(jeng.dist))
    with pytest.raises(ValueError, match="pred"):
        DynamicAPSP(h, with_pred=True, device="cpu", state={"dist": h, "version": 1})
    without = DynamicAPSP(h, device="cpu", block_size=8)
    with pytest.raises(ValueError, match="with_pred=False"):
        without.path(0, 1)
    poisoned = peng.snapshot()
    poisoned["dist"][0, 3] = float("nan")
    bad = DynamicAPSP(h, device="cpu", state=poisoned, with_pred=True)
    assert bad.health_probe()["domain_violations"] == 1 and not bad.health_probe()["ok"]


def test_engine_names_no_device_and_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DynamicAPSP(generate_np(np.random.default_rng(0), 8).h)
