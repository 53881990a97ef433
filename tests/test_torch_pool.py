"""The port's serving tier (``repro_torch.launch``) on the CPU: the supervised
``EnginePool`` against the JAX package's on one seeded request stream, the
batched cross-graph drain (``apply_updates_batched``) against the JAX one,
and the JAX suite's pool, fault and executor tests
(``tests/test_resilience.py``, ``tests/test_executor.py``) on the port.

Parity: in sync mode with ``deadline_s=0`` (no timing enters a decision)
and the same ``FaultSpec`` seed, both pools must give the same answers
(values, source, staleness, shed, deadline_missed, slot state, version),
the same ``state_counts()``, the same non-timing summary fields, and each
slot the same ``dist`` / ``pred`` / ``version``.  Tolerance: exact
(``np.array_equal``; bf16 state compared as its bit view, bf16 answers as
float32, which is what the port answers with).  Async tests check
invariants, not parity; each closes its pool in a ``finally`` and bounds
every wait.
"""

import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DynamicAPSP as JaxDynamicAPSP
from repro.core import apply_updates_batched as jax_apply_updates_batched
from repro.core.graphgen import generate_np
from repro.launch.faults import FaultInjector as JaxFaultInjector
from repro.launch.faults import FaultSpec as JaxFaultSpec
from repro.launch.pool import EnginePool as JaxEnginePool
from repro_torch.core import (
    DynamicAPSP,
    UpdateJournal,
    apply_updates_batched,
    domain_violations,
    generate_edge_updates,
    solve,
)
from repro_torch.core.convert import to_numpy
from repro_torch.launch import (
    Counters,
    EnginePool,
    FaultInjector,
    FaultSpec,
    InjectedCrash,
    SlotState,
)

pytestmark = pytest.mark.resilience

SUMMARY_KEYS = ("pool", "slots", "states", "faults_injected", "transitions", "recoveries",
                "live_bytes", "mem_budget_bytes")


@pytest.fixture(autouse=True)
def _own_autotune_caches(tmp_path, monkeypatch):
    """Both packages' autotune caches in a fresh file: a cache left on the
    host must not change the block sizes the solves run at."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "port-autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax-autotune.json"))


def graph(n=16, seed=0):
    return generate_np(np.random.default_rng(seed), n, rho=60.0).h


def host(a):
    """A JAX array or a port tensor as a host array, bf16 as its bit view."""
    if isinstance(a, torch.Tensor):
        return to_numpy(a)[0]
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def make_pool(n=16, graphs=1, seed=0, **kw):
    pool = EnginePool(method="blocked_fw", solve_kw={"block_size": 8},
                      seed=seed, device="cpu", **kw)
    for gid in range(graphs):
        pool.admit(gid, graph(n, seed + gid))
    return pool


def updates(n, count, seed, lo=0.5, hi=8.0):
    """``count`` random non-self-loop edge updates as (u, v, w) arrays."""
    r = np.random.default_rng(seed)
    u = r.integers(0, n, count)
    v = r.integers(0, n, count)
    v = np.where(v == u, (v + 1) % n, v)
    w = r.uniform(lo, hi, count).astype(np.float32)
    return u.astype(np.int32), v.astype(np.int32), w


# ---------------------------------------------------------------------------
# parity with the JAX pool on one seeded request stream
# ---------------------------------------------------------------------------

SCENARIOS = {
    # LRU eviction and re-admission: three slots, room for two engines
    "eviction": dict(graphs=3, pool=dict(mem_budget_bytes=2 * 16 * 16 * 4)),
    # drift planted in a live state, caught by verify and re-solved
    "drift": dict(graphs=2, verify_every=5, drift_at=(7, 19)),
    # the batched cross-graph drain: backlog over the watermark drains all
    "batched": dict(graphs=3, pool=dict(backlog_watermark=2)),
    # independent chaos kinds, a memory budget the mem kind squeezes
    "chaos": dict(graphs=2, spec="nan:0.2,crash:0.15:3,poison:0.15,mem:0.3:0.5",
                  pool=dict(mem_budget_bytes=2 * 16 * 16 * 4, backlog_watermark=3)),
}


def _run_stream(pkg, scenario, with_pred, bf16, seed=5, n=16, requests=40):
    """Drive one pool of ``pkg`` ("jax" or "port") through the scenario's
    seeded stream; returns (answers, pool)."""
    sc = SCENARIOS[scenario]
    spec_text = sc.get("spec", "")
    solve_kw = {"block_size": 8}
    if pkg == "jax":
        if bf16:
            solve_kw["dtype"] = jnp.bfloat16
        inj = JaxFaultInjector(JaxFaultSpec.parse(spec_text), seed=seed)
        pool = JaxEnginePool(method="blocked_fw", with_pred=with_pred, solve_kw=solve_kw,
                             injector=inj, seed=seed, deadline_s=0.0,
                             backoff_base_s=1e-4, **sc.get("pool", {}))
    else:
        if bf16:
            solve_kw["dtype"] = torch.bfloat16
        inj = FaultInjector(FaultSpec.parse(spec_text), seed=seed)
        pool = EnginePool(method="blocked_fw", with_pred=with_pred, solve_kw=solve_kw,
                          injector=inj, seed=seed, deadline_s=0.0, backoff_base_s=1e-4,
                          device="cpu", **sc.get("pool", {}))
    rng = np.random.default_rng(seed)
    for gid in range(sc["graphs"]):
        pool.admit(gid, graph(n, 100 + gid))
    answers = []
    for req in range(requests):
        gid = int(rng.integers(0, sc["graphs"]))
        slot = pool.slots[gid]
        if req in sc.get("drift_at", ()) and slot.engine is not None:
            slot.engine._dist = slot.engine._dist + 7.0
        if rng.uniform() < 0.5:
            h = slot.engine.h if slot.engine is not None else slot._h
            u, v, w = generate_edge_updates(rng, h, int(rng.integers(1, 5)),
                                            worsen_frac=0.1)
            pool.submit_update(gid, u, v, w)
            if pool.backlog() > pool.backlog_watermark:
                pool.drain_all()
        else:
            r = pool.query(gid, rng.integers(0, n, 4), rng.integers(0, n, 4))
            answers.append((np.asarray(r.values, np.float32), r.source, r.staleness,
                            r.slot_state, r.shed, r.deadline_missed, r.version))
        if sc.get("verify_every") and (req + 1) % sc["verify_every"] == 0:
            rep = pool.verify(gid)
            answers.append(("verify", rep["ok"], rep["recovered"], rep["state"]))
    pool.recover_all(readmit=True)
    return answers, pool


@pytest.mark.parametrize("scenario,with_pred,bf16", [
    ("eviction", False, False),
    ("drift", False, False),
    ("batched", False, False),
    ("batched", True, False),
    ("batched", False, True),
    ("chaos", False, False),
    ("chaos", True, False),
])
def test_pool_matches_jax_on_one_stream(scenario, with_pred, bf16):
    jans, jpool = _run_stream("jax", scenario, with_pred, bf16)
    pans, ppool = _run_stream("port", scenario, with_pred, bf16)
    try:
        assert len(jans) == len(pans)
        for ja, pa in zip(jans, pans):
            if isinstance(ja[0], str):
                assert ja == pa
                continue
            assert np.array_equal(ja[0], pa[0], equal_nan=True), (ja, pa)
            assert ja[1:] == pa[1:], (ja, pa)
        assert jpool.state_counts() == ppool.state_counts()
        js, ps = jpool.summary(), ppool.summary()
        for key in SUMMARY_KEYS:
            assert js[key] == ps[key], key
        for gid, jslot in jpool.slots.items():
            pslot = ppool.slots[gid]
            assert jslot.state == pslot.state
            assert (jslot.engine is None) == (pslot.engine is None)
            if jslot.engine is not None:
                assert np.array_equal(host(jslot.engine.dist), host(pslot.engine.dist))
                if with_pred:
                    assert np.array_equal(host(jslot.engine.pred), host(pslot.engine.pred))
                assert jslot.engine.version == pslot.engine.version
                assert np.array_equal(jslot.engine.h, pslot.engine.h)
        if scenario == "batched":
            assert ps["pool"]["drain_batched"] >= 1
        if scenario == "eviction":
            assert ps["slots"]["evictions"] >= 1
        if scenario == "drift":
            assert ps["pool"]["verify_drift"] >= 1
        if scenario == "chaos":
            assert sum(ps["faults_injected"].values()) > 0
            assert ps["pool"]["poisoned_served"] == 0
    finally:
        jpool.close()
        ppool.close()


# ---------------------------------------------------------------------------
# apply_updates_batched against the JAX batched drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("mixed", [False, True])
def test_apply_updates_batched_matches_jax(tmp_path, with_pred, mixed):
    """Three engines a step: decrease batches go through one (G, n, n)
    fixpoint; a batch with a worsening (``mixed``) is deferred untouched.
    Infos, deferred lists, states, versions, stats and journal records must
    agree."""
    rng = np.random.default_rng(3)
    hs = [graph(24, 40 + g) for g in range(3)]
    jj = [JaxDynamicAPSP(h, with_pred=with_pred, block_size=8) for h in hs]
    pj = [UpdateJournal(str(tmp_path / f"p{g}.wal")) for g in range(3)]
    pe = [DynamicAPSP(h, with_pred=with_pred, block_size=8, device="cpu", journal=j)
          for h, j in zip(hs, pj)]
    from repro.core.dynamic import UpdateJournal as JaxUpdateJournal

    jjour = [JaxUpdateJournal(str(tmp_path / f"j{g}.wal")) for g in range(3)]
    for e, j in zip(jj, jjour):
        e.journal = j
    seen_batched = 0
    for step in range(4):
        batches = []
        for g, e in enumerate(jj):
            u, v, w = generate_edge_updates(rng, e.h, 1 + 3 * g)
            if mixed and step == 1 and g == 2:     # worsen an existing edge too
                i, j = np.argwhere(np.isfinite(e.h) & (e.h > 0))[0]
                u, v = np.append(u, np.int32(i)), np.append(v, np.int32(j))
                w = np.append(w, np.float32(e.h[i, j] + 100.0))
            batches.append((u, v, w))
        jinfos, jdef = jax_apply_updates_batched(jj, batches)
        pinfos, pdef = apply_updates_batched(pe, batches)
        assert jinfos == pinfos and jdef == pdef
        seen_batched += sum(1 for i in pinfos if i and i.get("batched"))
        for a, b in zip(jj, pe):
            assert np.array_equal(host(a.dist), host(b.dist))
            if with_pred:
                assert np.array_equal(host(a.pred), host(b.pred))
            assert a.version == b.version and a.stats == b.stats
            assert np.array_equal(a.h, b.h)
        if mixed and step == 1:
            assert pdef == [2]
    assert seen_batched > 0
    for a, b in zip(jjour, pj):
        strip = [{k: r[k] for k in ("v0", "u", "v", "w")} for r in a.records()]
        assert strip == [{k: r[k] for k in ("v0", "u", "v", "w")} for r in b.records()]
        a.close()
        b.close()


def test_apply_updates_batched_bf16_matches_jax():
    rng = np.random.default_rng(9)
    hs = [graph(20, 60 + g) for g in range(2)]
    jj = [JaxDynamicAPSP(h, block_size=8, dtype=jnp.bfloat16) for h in hs]
    pe = [DynamicAPSP(h, block_size=8, dtype=torch.bfloat16, device="cpu") for h in hs]
    for _ in range(3):
        batches = [generate_edge_updates(rng, e.h, 4) for e in jj]
        ji, jd = jax_apply_updates_batched(jj, batches)
        pi, pd = apply_updates_batched(pe, batches)
        assert ji == pi and jd == pd
        for a, b in zip(jj, pe):
            assert np.array_equal(host(a.dist), host(b.dist)) and a.version == b.version


def test_apply_updates_batched_equals_sequential_updates():
    """The batched drain leaves each engine as ``update`` leaves its twin:
    dist, pred, version and stats (the rank-k pass counts ride along)."""
    rng = np.random.default_rng(1)
    hs = [graph(32, 70 + g) for g in range(4)]
    batched = [DynamicAPSP(h, with_pred=True, block_size=8, device="cpu") for h in hs]
    twins = [DynamicAPSP(h, with_pred=True, block_size=8, device="cpu") for h in hs]
    batches = [generate_edge_updates(rng, h, 6) for h in hs]
    infos, deferred = apply_updates_batched(batched, batches)
    assert deferred == [] and all(i["batched"] == 4 for i in infos)
    for eng, twin, batch, info in zip(batched, twins, batches, infos):
        ti = twin.update(*batch)
        assert torch.equal(eng.dist, twin.dist) and torch.equal(eng.pred, twin.pred)
        assert eng.version == twin.version
        assert info["k_padded"] == ti["k_padded"]
        # the group shares its pass count (converged graphs ride as no-ops)
        assert info["passes"] >= ti["passes"]


def test_apply_updates_batched_group_failure_defers_untouched(monkeypatch):
    import repro_torch.core.dynamic as dyn

    hs = [graph(16, g) for g in range(2)]
    engs = [DynamicAPSP(h, block_size=8, device="cpu") for h in hs]
    before = [(e.dist.clone(), e.h.copy(), e.version) for e in engs]

    def boom(*args, **kwargs):
        raise RuntimeError("injected batched dispatch failure")

    monkeypatch.setattr(dyn, "_rank_k_fixpoint_batch", boom)
    infos, deferred = apply_updates_batched(engs, [([0], [1], [0.5]), ([2], [3], [0.5])])
    assert deferred == [0, 1] and infos == [None, None]
    for e, (d, h, v) in zip(engs, before):
        assert torch.equal(e.dist, d) and np.array_equal(e.h, h) and e.version == v


# ---------------------------------------------------------------------------
# the launch counters under threads
# ---------------------------------------------------------------------------

def test_launch_counter_bumps_lose_nothing_across_threads():
    import sys

    from repro_torch.kernels import _counts

    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_counts.bump(counts, "k")
                                                    for _ in range(5000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts["k"] == 40_000


# ---------------------------------------------------------------------------
# fault-spec grammar + injector determinism (tests/test_resilience.py)
# ---------------------------------------------------------------------------

def test_fault_spec_parse_roundtrip():
    s = FaultSpec.parse("nan:0.1,crash:0.2:3,latency:0.3:25,mem:0.05:0.25")
    assert s.nan == 0.1 and s.crash == 0.2 and s.crash_count == 3
    assert s.latency == 0.3 and s.latency_ms == 25.0
    assert s.mem == 0.05 and s.mem_frac == 0.25
    assert s.any() and not FaultSpec.parse("").any()
    assert not FaultSpec.parse(None).any()


@pytest.mark.parametrize("bad", [
    "nan", "explode:0.5", "nan:1.5", "nan:0.1:7", "crash:0.1:2:9", "latency:abc",
])
def test_fault_spec_parse_rejects(bad):
    with pytest.raises(ValueError):
        FaultSpec.parse(bad)


def test_injector_deterministic_and_streams_independent():
    spec = FaultSpec.parse("nan:0.3,latency:0.4:0")

    def trace(s):
        inj = FaultInjector(s, seed=7)
        return [(inj.corrupt_update(np.ones(4, np.float32))[1], inj.maybe_latency() > 0)
                for _ in range(50)]

    assert trace(spec) == trace(spec)
    nan_only = [a for a, _ in trace(FaultSpec.parse("nan:0.3"))]
    assert nan_only == [a for a, _ in trace(spec)]


def test_injector_streams_are_the_jax_ones():
    """One seed fires the same faults at the same opportunities in both
    packages, every kind."""
    text = ("nan:0.3,crash:0.2:2,poison:0.25,mem:0.3:0.5,backend_loss:0.2:2,"
            "cache_storm:0.2:2,crash_restore:0.3,latency:0.2:0")

    def trace(inj, poisoned):
        out = []
        for _ in range(40):
            inj.begin_drain()
            out.append(inj.corrupt_update(np.ones(5, np.float32))[1])
            try:
                inj.maybe_crash()
                out.append("ok")
            except RuntimeError as e:
                out.append(str(e))
            out.append(inj.maybe_mem_squeeze(1000))
            out.append(inj.maybe_crash_restore())
            out.append(inj.maybe_poison_state(poisoned))
        return out, inj.counts.as_dict()

    class _Eng:
        def __init__(self, d):
            self.n, self._dist = 6, d

    j = trace(JaxFaultInjector(JaxFaultSpec.parse(text), seed=11), _Eng(jnp.zeros((6, 6))))
    p = trace(FaultInjector(FaultSpec.parse(text), seed=11), _Eng(torch.zeros(6, 6)))
    assert j == p


def test_injector_sticky_crash_count():
    inj = FaultInjector(FaultSpec(crash=1.0, crash_count=3), seed=0)
    for _ in range(3):
        with pytest.raises(InjectedCrash):
            inj.maybe_crash()
    assert inj.counts["crash"] == 1


def test_poison_writes_a_clone():
    """The poison never changes a tensor handed out before it (a snapshot,
    a caller's handle), as JAX's functional ``.at[].set``."""
    eng = DynamicAPSP(graph(), block_size=8, device="cpu")
    handle = eng.dist
    inj = FaultInjector(FaultSpec(poison=1.0), seed=0)
    i, j = inj.maybe_poison_state(eng)
    assert torch.isnan(eng.dist[i, j]) and i != j
    assert not torch.isnan(handle).any()


# ---------------------------------------------------------------------------
# slot lifecycle under faults (tests/test_resilience.py)
# ---------------------------------------------------------------------------

def test_crash_beyond_retries_quarantines_then_recovers():
    inj = FaultInjector(FaultSpec(), seed=0)
    inj._pending_crashes = 4
    pool = make_pool(max_retries=2, injector=inj)
    slot = pool.slots[0]
    pool.submit_update(0, [0], [1], [0.5])
    infos = pool.drain(0)
    assert infos[0].get("path") != "failed"
    assert slot.stats["quarantines"] == 1
    assert slot.stats["retries"] == 4
    assert slot.state == SlotState.HEALTHY
    trans = [(e["from"], e["to"]) for e in pool.events if "from" in e]
    assert (SlotState.HEALTHY, SlotState.QUARANTINED) in trans
    assert any("recovery_s" in e for e in pool.events)
    assert float(slot.engine.h[0, 1]) == 0.5
    ref = solve(slot.engine.h, method="blocked_fw", block_size=8, device="cpu")
    assert torch.equal(slot.engine.dist, ref.dist)


def test_persistent_crash_stays_quarantined_and_requeues():
    inj = FaultInjector(FaultSpec(crash=1.0), seed=0)
    pool = make_pool(max_retries=1, injector=inj)
    slot = pool.slots[0]
    pool.submit_update(0, [0], [1], [0.5])
    infos = pool.drain(0)
    assert infos[0]["path"] == "failed"
    assert slot.state == SlotState.QUARANTINED
    assert len(slot.pending) == 1
    assert pool.stats["updates_failed"] == 1
    r = pool.query(0, np.array([0]), np.array([1]))
    assert r.source == "snapshot" and r.staleness >= 1
    inj.spec = FaultSpec()
    pool.drain(0)
    assert slot.state == SlotState.HEALTHY and not slot.pending
    assert float(slot.engine.h[0, 1]) == 0.5


def test_out_of_memory_is_retried_as_transient(monkeypatch):
    """``torch.cuda.OutOfMemoryError`` is a ``RuntimeError``: the pool's
    bounded retry takes it as it takes an XLA runtime error in JAX."""
    assert issubclass(torch.cuda.OutOfMemoryError, RuntimeError)
    pool = make_pool()
    slot = pool.slots[0]
    real = slot.engine.update
    fired = {"n": 0}

    def oom_once(*a, **kw):
        if fired["n"] == 0:
            fired["n"] += 1
            raise torch.cuda.OutOfMemoryError("injected out of memory")
        return real(*a, **kw)

    monkeypatch.setattr(slot.engine, "update", oom_once)
    pool.submit_update(0, [0], [1], [0.5])
    infos = pool.drain(0)
    assert infos[0]["path"] == "rank_k" and slot.stats["retries"] == 1
    assert slot.state == SlotState.HEALTHY


def test_injected_nan_update_rejected_slot_stays_healthy():
    inj = FaultInjector(FaultSpec(nan=1.0), seed=0)
    pool = make_pool(injector=inj)
    pool.submit_update(0, [0], [1], [0.5])
    infos = pool.drain(0)
    assert infos[0]["path"] == "rejected"
    assert pool.slots[0].state == SlotState.HEALTHY
    assert pool.stats["updates_rejected"] == 1
    assert not bool(domain_violations(pool.slots[0].engine.dist, "tropical").any())


def test_poisoned_state_probed_degraded_and_recovered():
    inj = FaultInjector(FaultSpec(poison=1.0), seed=0)
    pool = make_pool(injector=inj)
    slot = pool.slots[0]
    pool.submit_update(0, [0], [1], [0.5])
    pool.drain(0)
    assert slot.stats["probe_failures"] >= 1
    assert slot.state == SlotState.HEALTHY
    assert not torch.isnan(slot.engine.dist).any()
    trans = [(e["from"], e["to"]) for e in pool.events if "from" in e]
    assert (SlotState.HEALTHY, SlotState.DEGRADED) in trans


def test_query_blocks_poison_and_serves_snapshot():
    pool = make_pool()
    slot = pool.slots[0]
    slot.engine._dist = slot.engine._dist.clone()
    slot.engine._dist[0, 5] = float("nan")
    r = pool.query(0, np.array([0]), np.array([5]))
    assert r.source == "snapshot" and not np.isnan(r.values).any()
    assert isinstance(r.values, np.ndarray)
    assert pool.stats["poison_blocked"] == 1
    assert pool.stats["poisoned_served"] == 0
    assert slot.state == SlotState.HEALTHY


def test_query_against_quarantined_slot_uses_snapshot_with_staleness():
    pool = make_pool()
    slot = pool.slots[0]
    slot._transition(SlotState.QUARANTINED, "forced by test")
    pool.submit_update(0, [0], [1], [0.5])
    r = pool.query(0, np.array([1]), np.array([2]))
    assert r.source in ("live", "snapshot")
    if r.source == "snapshot":
        assert r.staleness >= 1 and r.slot_state != SlotState.HEALTHY


def test_snapshot_staleness_counts_versions_behind():
    pool = make_pool()
    slot = pool.slots[0]
    v0 = slot.snapshot["version"]
    slot.engine.update([(0, 1, 0.25)])
    slot.engine.update([(1, 2, 0.25)])
    assert slot.engine.version == v0 + 2
    assert slot.staleness() == 2
    slot._commit_snapshot()
    assert slot.staleness() == 0


def test_deadline_miss_falls_back_to_snapshot():
    inj = FaultInjector(FaultSpec(latency=1.0, latency_ms=80.0), seed=0)
    pool = make_pool(injector=inj, deadline_s=0.01)
    try:
        r = pool.query(0, np.array([0]), np.array([1]))
        assert r.deadline_missed and r.source == "snapshot"
        assert pool.stats["deadline_misses"] == 1
    finally:
        pool.close()


def test_backlog_watermark_sheds_to_snapshot():
    pool = make_pool(backlog_watermark=0)
    pool.submit_update(0, [0], [1], [0.5])
    r = pool.query(0, np.array([2]), np.array([3]))
    assert r.shed and r.source == "snapshot" and r.staleness >= 1
    assert pool.stats["queries_shed"] == 1
    pool.drain_all()
    assert pool.query(0, np.array([2]), np.array([3])).source == "live"


# ---------------------------------------------------------------------------
# memory budget: LRU eviction + deterministic re-admission
# ---------------------------------------------------------------------------

def test_lru_eviction_and_deterministic_readmission():
    n = 16
    pool = make_pool(n=n, graphs=1, mem_budget_bytes=n * n * 4)
    pool.admit(1, graph(n, 1))
    s0, s1 = pool.slots[0], pool.slots[1]
    assert s0.state == SlotState.EVICTED and s0.engine is None
    assert s1.state == SlotState.HEALTHY
    r = pool.query(0, np.array([0]), np.array([1]))
    assert r.source == "snapshot" and r.slot_state == SlotState.EVICTED
    pool.submit_update(0, [2], [3], [0.125])
    pool.drain(0)
    assert s0.engine is not None
    assert s0.stats["readmissions"] == 1
    assert s1.state == SlotState.EVICTED
    ref = solve(s0.engine.h, method="blocked_fw", block_size=8, device="cpu")
    assert torch.equal(s0.engine.dist, ref.dist)
    assert s0.engine.version > 0


def test_device_bytes_count_four_bytes_an_entry_in_bf16_too():
    pool = EnginePool(method="blocked_fw", with_pred=True, device="cpu",
                      solve_kw={"block_size": 8, "dtype": torch.bfloat16})
    pool.admit(0, graph(16))
    assert pool.slots[0].device_bytes() == 2 * 16 * 16 * 4
    assert pool.live_bytes() == 2 * 16 * 16 * 4


def test_versions_monotone_across_eviction():
    pool = make_pool()
    slot = pool.slots[0]
    slot.engine.update([(0, 1, 0.5)])
    v = slot.engine.version
    slot.evict()
    slot.readmit()
    assert slot.engine.version > v


# ---------------------------------------------------------------------------
# drift detection (verify) + coalescing
# ---------------------------------------------------------------------------

def test_verify_detects_drift_and_resolves():
    pool = make_pool()
    slot = pool.slots[0]
    slot.engine._dist = slot.engine._dist + 7.0
    report = pool.verify(0)
    assert not report["ok"] and report["recovered"]
    assert pool.stats["verify_drift"] == 1
    assert slot.stats["drift_detected"] == 1
    assert slot.state == SlotState.HEALTHY


def test_drain_coalesces_batches_last_wins():
    pool = make_pool()
    slot = pool.slots[0]
    pool.submit_update(0, [0], [1], [0.75])
    pool.submit_update(0, [0], [1], [0.25])
    infos = pool.drain(0)
    assert len(infos) == 1
    assert pool.stats["drain_coalesced"] == 1
    assert float(slot.engine.h[0, 1]) == 0.25


def test_drain_per_batch_fallback_keeps_clean_batches():
    pool = make_pool()
    pool.submit_update(0, [0], [1], [np.nan])
    pool.submit_update(0, [1], [2], [0.5])
    infos = pool.drain(0)
    assert pool.stats["drain_fallbacks"] == 1
    assert [i["path"] == "rejected" for i in infos] == [True, False]
    assert float(pool.slots[0].engine.h[1, 2]) == 0.5


# ---------------------------------------------------------------------------
# update atomicity under retry + batched drains
# ---------------------------------------------------------------------------

def test_update_atomic_under_midflight_crash_retry(monkeypatch):
    """A crash after the engine started a batch must not lose the batch on
    retry: ``h`` rolls back, so the retried batch re-applies for real."""
    import repro_torch.core.dynamic as dyn

    pool = make_pool()
    slot = pool.slots[0]
    real = dyn._rank_k_fixpoint
    fired = {"n": 0}

    def crash_once(*args, **kwargs):
        if fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("injected mid-update crash")
        return real(*args, **kwargs)

    monkeypatch.setattr(dyn, "_rank_k_fixpoint", crash_once)
    info = slot.apply_update(np.array([0], np.int32), np.array([1], np.int32),
                             np.array([0.5], np.float32))
    assert fired["n"] == 1
    assert slot.stats["retries"] == 1
    assert info["path"] == "rank_k"
    assert float(slot.engine.h[0, 1]) == 0.5
    ref = solve(slot.engine.h, method="blocked_fw", block_size=8, device="cpu")
    assert torch.equal(slot.engine.dist, ref.dist)


def test_update_state_unchanged_when_dispatch_raises(monkeypatch):
    """The engine-level half of atomicity: if the dispatch raises, ``h``
    rolls back and the engine still matches its own closure."""
    import repro_torch.core.dynamic as dyn

    eng = DynamicAPSP(graph(), block_size=8, device="cpu")
    h_before = eng.h.copy()

    def boom(*args, **kwargs):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(dyn, "_rank_k_fixpoint", boom)
    with pytest.raises(RuntimeError, match="injected"):
        eng.update([(0, 1, 0.5)])
    assert np.array_equal(eng.h, h_before)
    assert torch.equal(eng.dist, solve(eng.h, block_size=8, device="cpu").dist)


def test_health_probe_bf16_tolerance():
    eng = DynamicAPSP(graph(24, seed=5), block_size=8, dtype=torch.bfloat16, device="cpu")
    assert eng.dist.dtype == torch.bfloat16
    assert eng.health_probe(256, np.random.default_rng(0))["ok"]
    eng.update([(0, 1, 0.25)])
    assert eng.health_probe(256, np.random.default_rng(1))["ok"]


def test_drain_all_batches_same_shape_slots():
    pool = make_pool(n=16, graphs=3)
    rng = np.random.default_rng(7)
    expect = {}
    for gid in range(3):
        h = pool.slots[gid].engine.h
        u, v, w = generate_edge_updates(rng, h, 4)
        h2 = np.array(h)
        h2[u, v] = np.minimum(h2[u, v], w)
        expect[gid] = h2
        pool.submit_update(gid, u, v, w)
    pool.drain_all()
    assert pool.stats["drain_batched"] == 1
    for gid in range(3):
        slot = pool.slots[gid]
        assert slot.state == SlotState.HEALTHY and not slot.pending
        assert slot.stats["updates_applied"] == 1
        ref = solve(expect[gid], method="blocked_fw", block_size=8, device="cpu")
        assert torch.equal(slot.engine.dist, ref.dist)


def test_drain_all_batched_defers_worsenings_to_sequential():
    pool = make_pool(n=16, graphs=3)
    rng = np.random.default_rng(11)
    for gid in range(3):
        h = pool.slots[gid].engine.h
        u, v, w = generate_edge_updates(rng, h, 4)
        if gid == 0:
            fin = np.argwhere(np.isfinite(h) & (h > 0))
            i, j = fin[0]
            u, v = np.array([i], np.int32), np.array([j], np.int32)
            w = np.array([float(h[i, j]) + 100.0], np.float32)
        pool.submit_update(gid, u, v, w)
    pool.drain_all()
    assert pool.stats["drain_batched"] == 1
    for gid in range(3):
        slot = pool.slots[gid]
        assert slot.state == SlotState.HEALTHY and not slot.pending
        ref = solve(slot.engine.h, method="blocked_fw", block_size=8, device="cpu")
        assert torch.equal(slot.engine.dist, ref.dist)


def test_drain_all_under_chaos_skips_batched_path():
    inj = FaultInjector(FaultSpec(nan=0.0, crash=0.5, crash_count=1), seed=3)
    pool = make_pool(n=16, graphs=2, injector=inj, max_retries=3)
    for gid in range(2):
        pool.submit_update(gid, [0], [1], [0.5])
    pool.drain_all()
    assert pool.stats["drain_batched"] == 0


def test_chaos_run_zero_poison_and_full_recovery():
    inj = FaultInjector(
        FaultSpec.parse("nan:0.2,crash:0.15:3,poison:0.15,latency:0.1:5"), seed=42)
    pool = make_pool(n=16, graphs=2, injector=inj, deadline_s=0.2,
                     backlog_watermark=3, seed=42)
    try:
        rng = np.random.default_rng(42)
        for _ in range(60):
            gid = int(rng.integers(0, 2))
            if rng.uniform() < 0.5:
                slot = pool.slots[gid]
                h = slot.engine.h if slot.engine is not None else slot._h
                u, v, w = generate_edge_updates(rng, h, 3)
                pool.submit_update(gid, u, v, w)
                if pool.backlog() > pool.backlog_watermark:
                    pool.drain_all()
            else:
                r = pool.query(gid, rng.integers(0, 16, 4), rng.integers(0, 16, 4))
                assert not bool(domain_violations(r.values, "tropical").any())
                if r.source == "snapshot":
                    assert r.staleness >= 0 and r.slot_state in SlotState.ALL
        pool.recover_all(readmit=True)
        summary = pool.summary()
        assert summary["pool"]["poisoned_served"] == 0
        assert summary["states"][SlotState.DEGRADED] == 0
        assert summary["states"][SlotState.QUARANTINED] == 0
        assert sum(inj.counts.values()) > 0
        for gid in (0, 1):
            assert pool.verify(gid)["ok"]
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# crash + restore (tests/test_executor.py)
# ---------------------------------------------------------------------------

def test_crash_restore_bit_exact_vs_uncrashed_twin(tmp_path):
    n = 16
    pool = make_pool(n, durability_dir=str(tmp_path), checkpoint_every=2)
    try:
        twin = DynamicAPSP(graph(n), method="blocked_fw", block_size=8, device="cpu")
        u, v, w = updates(n, 9, seed=3)
        for k in range(9):
            pool.submit_update(0, [int(u[k])], [int(v[k])], [float(w[k])])
            pool.drain(0)
            twin.update([int(u[k])], [int(v[k])], [float(w[k])])
        slot = pool.slots[0]
        assert slot.stats["checkpoints"] >= 2
        live = slot.engine.dist.clone()
        v_live = slot.engine.version
        slot.crash()
        assert slot.engine is None and slot.snapshot is None
        assert slot.state == SlotState.QUARANTINED
        assert slot.restore()
        assert slot.state == SlotState.HEALTHY
        assert slot.engine.version == v_live == twin.version
        assert torch.equal(slot.engine.dist, live)
        assert torch.equal(slot.engine.dist, twin.dist)
        assert np.array_equal(slot.engine.h, twin.h)
        assert slot.stats["restores"] == 1
        assert slot.stats["replayed_records"] >= 1
    finally:
        pool.close()


def test_restore_without_checkpoint_cold_builds(tmp_path):
    pool = make_pool(12, durability_dir=str(tmp_path), checkpoint_every=0)
    try:
        slot = pool.slots[0]
        shutil.rmtree(slot._ck_dir)
        slot.crash()
        assert slot.restore()
        assert slot.state == SlotState.HEALTHY
        assert slot.stats["cold_rebuilds"] == 1
    finally:
        pool.close()


def test_crashed_slot_update_path_restores(tmp_path):
    pool = make_pool(12, durability_dir=str(tmp_path))
    try:
        slot = pool.slots[0]
        slot.crash()
        pool.submit_update(0, [0], [1], [0.75])
        infos = pool.drain(0)
        assert infos and infos[0].get("path") != "failed"
        assert slot.state == SlotState.HEALTHY
        assert slot.stats["restores"] == 1
        assert float(slot.engine.h[0, 1]) == 0.75
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# correlated fault kinds
# ---------------------------------------------------------------------------

def test_fault_spec_parses_correlated_kinds():
    s = FaultSpec.parse("backend_loss:0.3:4,cache_storm:0.2:5,crash_restore:0.25")
    assert s.backend_loss == 0.3 and s.backend_count == 4
    assert s.cache_storm == 0.2 and s.storm_count == 5
    assert s.crash_restore == 0.25
    with pytest.raises(ValueError, match="no parameter"):
        FaultSpec.parse("crash_restore:0.5:2")


def test_backend_loss_window_fails_every_attempt():
    inj = FaultInjector(FaultSpec(backend_loss=1.0, backend_count=3), seed=0)
    inj.begin_drain()
    assert inj.backend_down()
    for _ in range(3):
        with pytest.raises(InjectedCrash, match="backend loss"):
            inj.maybe_crash()
    assert not inj.backend_down()
    inj.maybe_crash()
    assert inj.counts["backend_denied"] == 3
    assert inj.counts["backend_loss"] == 1


def test_cache_storm_charges_latency_penalty():
    inj = FaultInjector(FaultSpec(cache_storm=1.0, storm_count=2, latency_ms=1.0), seed=0)
    inj.begin_drain()
    assert inj.maybe_latency() > 0
    assert inj.maybe_latency() > 0
    assert inj.maybe_latency() == 0.0
    assert inj.counts["storm_recompiles"] == 2


def test_correlated_schedule_is_seed_deterministic():
    def run(seed):
        inj = FaultInjector(FaultSpec(backend_loss=0.4, cache_storm=0.4, crash_restore=0.4),
                            seed=seed)
        out = []
        for _ in range(30):
            inj.begin_drain()
            out.append((inj.backend_down(), inj.maybe_crash_restore()))
            while inj.backend_down():
                with pytest.raises(InjectedCrash):
                    inj.maybe_crash()
        return out, inj.counts.as_dict()

    a, ca = run(7)
    b, cb = run(7)
    c, _ = run(8)
    assert a == b and ca == cb
    assert a != c


def test_backend_loss_quarantines_multiple_slots_then_pool_heals(tmp_path):
    inj = FaultInjector(FaultSpec(backend_loss=1.0, backend_count=100), seed=0)
    pool = make_pool(12, graphs=2, max_retries=1, injector=inj, durability_dir=str(tmp_path))
    try:
        for gid in range(2):
            pool.submit_update(gid, [0], [1], [0.5])
        pool.drain_all()
        assert all(s.state == SlotState.QUARANTINED for s in pool.slots.values())
        assert all(s.pending for s in pool.slots.values())
        inj.spec = FaultSpec()
        inj._backend_left = 0
        pool.recover_all()
        for gid in range(2):
            slot = pool.slots[gid]
            assert slot.state == SlotState.HEALTHY
            assert float(slot.engine.h[0, 1]) == 0.5
            assert pool.verify(gid)["ok"]
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# background executor (invariants, not parity)
# ---------------------------------------------------------------------------

def test_async_submit_is_enqueue_and_flush_applies():
    pool = make_pool(12, async_updates=True)
    try:
        pool.submit_update(0, [0], [1], [0.5])
        assert pool.flush(timeout=30.0)
        slot = pool.slots[0]
        assert float(slot.engine.h[0, 1]) == 0.5
        assert slot.pending == []
        assert pool.executor.backlog() == 0
        assert pool.executor.stats["drains"] >= 1
        assert pool.executor.stats["drain_errors"] == 0
    finally:
        pool.close()


def test_executor_enqueue_dedups_and_stop_drops_queue():
    pool = make_pool(12, async_updates=True)
    try:
        ex = pool.executor
        with ex._cond:
            assert ex.enqueue(0) is True
            assert ex.enqueue(0) is False
        assert ex.flush(timeout=30.0)
        ex.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            ex.enqueue(0)
    finally:
        pool.close()


def test_async_drain_all_enqueues_backlog():
    pool = make_pool(12, graphs=2, async_updates=True)
    try:
        for gid in range(2):
            pool.submit_update(gid, [0], [1], [0.25])
        pool.drain_all()
        assert pool.flush(timeout=30.0)
        for gid in range(2):
            assert float(pool.slots[gid].engine.h[0, 1]) == 0.25
            assert pool.verify(gid)["ok"]
    finally:
        pool.close()


def test_async_queries_racing_drain_no_torn_reads(tmp_path):
    """Queries hammer a slot while background drains mutate it: every answer
    is the exact state of some committed version, tagged live only at
    staleness 0."""
    n = 16
    pool = make_pool(n, async_updates=True, durability_dir=str(tmp_path),
                     backlog_watermark=10_000)
    stop = threading.Event()
    t = None
    try:
        slot = pool.slots[0]
        h0 = slot._h.copy()
        u, v, w = updates(n, 30, seed=5)
        qi = np.arange(n, dtype=np.int64)
        qj = (qi + 3) % n
        answers = []

        def reader():
            while not stop.is_set():
                r = pool.query(0, qi, qj)
                answers.append((r.version, r.source, r.staleness, r.values.copy()))

        t = threading.Thread(target=reader)
        t.start()
        for k in range(30):
            pool.submit_update(0, [int(u[k])], [int(v[k])], [float(w[k])])
        assert pool.flush(timeout=60.0)
        stop.set()
        t.join(30.0)
        assert not t.is_alive()
        r = pool.query(0, qi, qj)
        answers.append((r.version, r.source, r.staleness, r.values.copy()))

        dist_at = {}
        twin = DynamicAPSP(h0, method="blocked_fw", block_size=8, device="cpu")
        dist_at[twin.version] = twin.dist.numpy()[qi, qj].copy()
        for rec in slot.journal.records():
            twin.update(np.asarray(rec["u"], np.int32), np.asarray(rec["v"], np.int32),
                        np.asarray(rec["w"], np.float32))
            dist_at[twin.version] = twin.dist.numpy()[qi, qj].copy()
        assert twin.version == slot.engine.version
        assert answers
        for version, source, staleness, values in answers:
            assert version in dist_at, f"answer at uncommitted version {version}"
            assert np.array_equal(values, dist_at[version])
            if source == "live":
                assert staleness == 0
        assert answers[-1][0] == slot.engine.version and answers[-1][1] == "live"
        assert pool.stats["poisoned_served"] == 0
    finally:
        stop.set()
        if t is not None:
            t.join(30.0)
        pool.close()


def test_async_correlated_chaos_zero_poisoned(tmp_path):
    n = 12
    inj = FaultInjector(FaultSpec(backend_loss=0.25, backend_count=4, cache_storm=0.25,
                                  storm_count=3, latency_ms=1.0, crash_restore=0.3), seed=11)
    pool = make_pool(n, graphs=3, seed=1, injector=inj, max_retries=2,
                     async_updates=True, durability_dir=str(tmp_path),
                     checkpoint_every=2, backlog_watermark=10_000)
    try:
        u, v, w = updates(n, 30, seed=6)
        bad = 0
        for k in range(30):
            gid = k % 3
            pool.submit_update(gid, [int(u[k])], [int(v[k])], [float(w[k])])
            r = pool.query(gid, [0], [n - 1])
            if r.source == "live" and r.staleness != 0:
                bad += 1
        assert pool.flush(timeout=120.0)
        pool.recover_all()
        assert bad == 0
        assert pool.stats["poisoned_served"] == 0
        drills = pool.stats["crash_restores"]
        for gid in range(3):
            slot = pool.slots[gid]
            assert slot.state == SlotState.HEALTHY
            assert pool.verify(gid)["ok"]
            twin = DynamicAPSP(graph(n, 1 + gid), method="blocked_fw", block_size=8,
                               device="cpu")
            sel = np.arange(30) % 3 == gid
            for uu, vv, ww in zip(u[sel], v[sel], w[sel]):
                twin.update([int(uu)], [int(vv)], [float(ww)])
            np.testing.assert_allclose(slot.engine.dist.numpy(), twin.dist.numpy(),
                                       rtol=1e-5, atol=1e-5)
        assert drills >= 1
        assert sum(s.stats["restores"] for s in pool.slots.values()) >= drills
    finally:
        pool.close()


def _slow_slot(slot, seconds):
    import time as _time

    orig = slot.live_values

    def slow(qi, qj):
        _time.sleep(seconds)
        return orig(qi, qj)

    slot.live_values = slow


def test_per_slot_readers_isolate_slow_dispatch():
    pool = make_pool(12, graphs=2, deadline_s=0.05)
    try:
        for gid in range(2):
            pool.query(gid, [0], [5], deadline_s=0)
        _slow_slot(pool.slots[0], 0.5)
        r0 = pool.query(0, [0], [5])
        assert r0.deadline_missed and r0.source == "snapshot"
        r1 = pool.query(1, [0], [5])
        assert not r1.deadline_missed and r1.source == "live"
    finally:
        pool.close()


def test_shared_reader_pool_still_serializes():
    pool = make_pool(12, graphs=2, deadline_s=0.05, reader_workers=1)
    try:
        for gid in range(2):
            pool.query(gid, [0], [5], deadline_s=0)
        _slow_slot(pool.slots[0], 0.5)
        r0 = pool.query(0, [0], [5])
        assert r0.deadline_missed
        r1 = pool.query(1, [0], [5])
        assert r1.deadline_missed and r1.source == "snapshot"
    finally:
        pool.close()


def test_counters_threaded_increments_lose_nothing():
    c = Counters({"x": 0})
    threads = [threading.Thread(target=lambda: [c.inc("x") for _ in range(10_000)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    assert c["x"] == 80_000


def test_counters_refuse_subscript_store():
    c = Counters({"x": 1})
    with pytest.raises(TypeError):
        c["x"] = 2
    with pytest.raises(TypeError):
        c["x"] += 1
    assert c["x"] == 1
    assert dict(c.items()) == {"x": 1}
    assert c.get("missing") == 0 and "missing" not in c


def test_pool_summary_counts_consistent_under_async_load():
    pool = make_pool(12, async_updates=True, executor_workers=2)
    try:
        u, v, w = updates(12, 20, seed=9)
        for k in range(20):
            pool.submit_update(0, [int(u[k])], [int(v[k])], [float(w[k])])
            pool.query(0, [0], [1])
        assert pool.flush(timeout=60.0)
        s = pool.summary()
        assert s["pool"]["updates_submitted"] == 20
        assert s["pool"]["queries_live"] + s["pool"]["queries_snapshot"] == 20
        assert s["executor"]["drain_errors"] == 0
    finally:
        pool.close()


def test_pool_names_no_device_and_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the pool would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnginePool(method="blocked_fw")
