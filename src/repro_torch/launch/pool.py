"""Supervised engine pool: the resilient serving tier over ``DynamicAPSP``,
ported from ``repro.launch.pool``.

This module puts every persistent engine behind a health-checked :class:`EngineSlot`
with an explicit lifecycle and a pool-level supervisor
(:class:`EnginePool`) that owns admission, deadlines, memory budget, and
recovery policy.

Slot lifecycle (one-way arrows are the supervisor's transitions)::

    warming ──solve+probe ok──> healthy
    healthy ──probe fail / drift / blocked poison──> degraded
    degraded ──re-solve + probe ok──> healthy
    degraded / crash-retries-exhausted──> quarantined
    quarantined ──full rebuild + probe ok──> healthy
    healthy ──LRU under memory budget──> evicted
    evicted ──deterministic re-admission (next update/drain)──> warming
    healthy ──crash drill (durable slots)──> quarantined ──restore──> healthy

Protection layers, outermost first:

* **Validation boundary** — NaN / out-of-domain update weights raise a
  typed ``UpdateError`` *before* touching engine state (the slot stays
  healthy; the batch is dropped and counted).
* **Health probes** — after every applied update the slot runs
  ``DynamicAPSP.health_probe`` (domain leaks, edge dominance, triangle
  spot checks).  A failed probe transitions to *degraded*: the slot keeps
  answering from its last-known-good snapshot while the supervisor
  re-solves.
* **Bounded retry** — transient apply failures (``InjectedCrash`` under
  chaos, any ``RuntimeError`` from the runtime) retry with exponential
  backoff + seeded jitter up to ``max_retries``, then quarantine + full
  rebuild.
* **Snapshots** — every healthy commit double-buffers a host-side
  last-known-good ``(dist, pred)`` copy (donation-aware: the engine's
  donating updates consume *device* buffers, never these host arrays;
  readers always see a fully-committed buffer because commit builds the
  standby copy first and swaps a reference last).  Degraded / quarantined
  / evicted / shed / deadline-missed answers come from the snapshot with
  an explicit staleness tag — a bounded-staleness answer instead of
  blocking on a full O(n³) re-solve.
* **Admission control** — queries are shed to the snapshot path when the
  pending-update backlog exceeds ``backlog_watermark``; update batches
  queue per slot and are coalesced into one rank-k dispatch at drain.
  ``drain_all`` goes one level further: healthy same-shape slots are
  stacked into one (G, n, n) rank-k fixpoint per tick (cross-graph
  batching), with any deferred slot falling back to its sequential drain.
* **Deadlines** — per-query budget enforced by a timeout wrapper around
  the live dispatch; a miss is answered from the snapshot and counted,
  never blocked on.  Readers are sized per slot by default
  (``reader_workers=0``) — one slow query cannot deadline-miss every
  other graph by hogging a single shared worker.
* **Memory budget** — live device state (``dist``/``pred`` per engine) is
  the scarce resource: admissions beyond ``mem_budget_bytes`` evict the
  least-recently-used healthy slot (snapshot + cost matrix are retained
  host-side), and eviction is *deterministically re-admissible* — the next
  update or drain rebuilds the engine from the retained cost matrix and
  replays the queued batches, converging to the same state as if never
  evicted.

**Concurrency.**  With ``async_updates=True`` the pool runs a
:class:`repro_torch.launch.executor.UpdateExecutor`: ``submit_update`` and
``drain_all`` become enqueues, background workers run the drains, and the
query path never touches the live engine — it reads the last *published*
snapshot reference (the same double-buffered commit; the reference swap
is atomic under the GIL) and tags the answer with its exact staleness:
``(engine version − published version) + queued batches + in-flight
batches``.  A staleness-0 answer from a healthy slot is current-version
exact and reported as ``source="live"``.  All slot mutation (build /
apply / evict / crash / restore) is serialized by a per-slot re-entrant
lock; the read path takes no lock.

**Durability.**  With ``durability_dir`` set, every slot owns a
write-ahead update journal (``repro_torch.core.UpdateJournal``, fsync
per committed phase) and periodic atomic engine checkpoints
(``repro_torch.checkpoint.save_engine_checkpoint``: dist/pred/h/version/
semiring/dtype, step == version).  A crashed slot (``crash_restore``
chaos drill, or a real restart pointed at the same directory) restores
via ``load_engine_checkpoint`` + journal replay of records with
``v0 >= checkpoint version`` — bit-exact to the uncrashed state, never an
O(n³) cold re-solve.  Checkpoints truncate the journal behind them.

The pool guarantees **zero poisoned answers**: every returned value either
came from a probe-committed snapshot or passed the live-path domain check;
anything else is blocked, counted, and triggers degradation + recovery.

Where the port differs from the JAX pool:

* The engines live on ``device`` (the card unless the caller names
  another).  ``DynamicAPSP.snapshot`` holds CPU tensors; answers are numpy
  arrays, bf16 state answered as float32 (numpy has no bf16; the values
  are those JAX's bf16 arrays hold).
* A live read gathers the queried entries on the device and syncs once.
* ``torch.cuda.OutOfMemoryError`` is a ``RuntimeError``: the retry path
  treats it as transient, as the JAX pool treats an XLA runtime error.
* ``device_bytes`` counts 4 bytes an entry, bf16 too, as the JAX pool
  does, so budgets evict the same slots in both packages.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import load_engine_checkpoint, save_engine_checkpoint
from repro_torch.core import (
    DynamicAPSP,
    UpdateError,
    UpdateJournal,
    apply_updates_batched,
    domain_violations,
    get_semiring,
    solve,
)
from repro_torch.core.semiring import SemiringLike, default_device

from .executor import UpdateExecutor
from .faults import FaultInjector, InjectedCrash
from .stats import Counters

__all__ = ["SlotState", "EngineSlot", "EnginePool", "QueryResult"]


def _values(t: torch.Tensor) -> np.ndarray:
    """Answered or compared state as a host array, bf16 as float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _index(q, device) -> torch.Tensor:
    """Query node ids as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(q, dtype=np.int64), device=device)


class SlotState:
    """Slot lifecycle states (plain strings so they serialize as-is)."""

    WARMING = "warming"
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    QUARANTINED = "quarantined"
    EVICTED = "evicted"

    ALL = (WARMING, HEALTHY, DEGRADED, QUARANTINED, EVICTED)


@dataclass
class QueryResult:
    """One answered distance query.

    ``source`` is ``"live"`` (fresh engine state, or a published snapshot
    at staleness 0 in async mode — current-version exact either way) or
    ``"snapshot"`` (last-known-good); ``staleness`` counts state versions
    the answer is behind the slot's authoritative cost matrix (0 = fresh;
    queued and in-flight update batches count too).  ``version`` is the
    engine version the answer reflects (None on the sync live path, which
    predates versioned answers).  ``shed`` marks an admission-control
    answer, ``deadline_missed`` a timeout fallback.  Every snapshot answer
    carries ``staleness``/flags — that tag is the degraded-answer contract
    the chaos smoke asserts on.
    """

    values: np.ndarray
    source: str
    staleness: int
    slot_state: str
    shed: bool = False
    deadline_missed: bool = False
    latency_s: float = 0.0
    version: Optional[int] = None


class EngineSlot:
    """One supervised persistent graph: engine + lifecycle + snapshot.

    All state mutation (build / apply / evict / readmit / recover / crash
    / restore / snapshot commit) happens under ``_lock`` (re-entrant: the
    recovery paths nest).  Readers — the async query path, ``staleness``,
    summaries — deliberately take no lock: they read the published
    snapshot *reference* (swapped atomically) and GIL-atomic counters, so
    a slow drain can never block an answer.
    """

    def __init__(
        self,
        gid: int,
        h: np.ndarray,
        *,
        method: str = "blocked_fw",
        with_pred: bool = False,
        semiring: SemiringLike = "tropical",
        solve_kw: Optional[Dict] = None,
        max_retries: int = 2,
        backoff_base_s: float = 0.005,
        probe_samples: int = 64,
        injector: Optional[FaultInjector] = None,
        seed: int = 0,
        events: Optional[List[Dict]] = None,
        durability_dir: Optional[str] = None,
        device=None,
    ):
        self.gid = gid
        self._device = torch.device(default_device(device))
        self._h = np.array(h, np.float32)        # host-side, authoritative
        self._method = method
        self._with_pred = bool(with_pred)
        self._sr = get_semiring(semiring)
        self._solve_kw = dict(solve_kw or {})
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.probe_samples = int(probe_samples)
        self.injector = injector or FaultInjector()
        self._rng = np.random.default_rng(seed)
        self.events = events if events is not None else []

        self.state = SlotState.WARMING
        self.engine: Optional[DynamicAPSP] = None
        self.pending: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.last_access = 0
        self._unhealthy_since: Optional[float] = None
        self._evicted_version = 0
        self._lock = threading.RLock()
        self._inflight = 0                       # batches popped but not yet committed
        self._reader: Optional[ThreadPoolExecutor] = None
        # double-buffered last-known-good snapshot: commit writes the
        # standby dict, then swaps the *reference* — a concurrent reader
        # holds either the old or the new fully-built snapshot, never a
        # half-written one
        self._snapshot: Optional[Dict] = None
        # durability: write-ahead journal + checkpoint dir per slot
        self.journal: Optional[UpdateJournal] = None
        self._ck_dir: Optional[str] = None
        if durability_dir:
            os.makedirs(durability_dir, exist_ok=True)
            self._ck_dir = os.path.join(durability_dir, f"g{gid:04d}")
            self.journal = UpdateJournal(
                os.path.join(durability_dir, f"g{gid:04d}.wal")
            )
        self.stats = Counters({
            "updates_applied": 0, "updates_rejected": 0, "retries": 0,
            "probe_failures": 0, "quarantines": 0, "evictions": 0,
            "readmissions": 0, "deadline_misses": 0, "drift_detected": 0,
            "poison_blocked": 0, "checkpoints": 0, "crashes": 0,
            "restores": 0, "replayed_records": 0,
        })

    @property
    def durable(self) -> bool:
        return self._ck_dir is not None

    # -- lifecycle ----------------------------------------------------------

    def _transition(self, new: str, reason: str) -> None:
        old = self.state
        if new == old:
            return
        now = time.monotonic()
        if old == SlotState.HEALTHY:
            self._unhealthy_since = now
        event = {"t": now, "gid": self.gid, "from": old, "to": new,
                 "reason": reason}
        if new == SlotState.HEALTHY and self._unhealthy_since is not None:
            event["recovery_s"] = now - self._unhealthy_since
            self._unhealthy_since = None
        self.state = new
        self.events.append(event)

    def build(self) -> None:
        """Cold solve from the authoritative cost matrix, probe, commit.
        A cold build starts a new incarnation: durable slots clear the
        journal (its records belong to discarded state) and checkpoint the
        fresh state so restore is possible from the first update on."""
        with self._lock:
            self._transition(SlotState.WARMING, "build")
            self.engine = DynamicAPSP(
                self._h, method=self._method, with_pred=self._with_pred,
                semiring=self._sr, journal=self.journal, device=self._device,
                **self._solve_kw,
            )
            self.engine._version = self._evicted_version + 1   # versions stay monotone across rebuilds
            probe = self.engine.health_probe(self.probe_samples, self._rng)
            if not probe["ok"]:
                self.stats.inc("probe_failures")
                self._transition(SlotState.QUARANTINED, f"build probe failed: {probe}")
                return
            self._commit_snapshot()
            self._transition(SlotState.HEALTHY, "build + probe ok")
            if self.durable:
                self.journal.clear()
                self.checkpoint()

    def _commit_snapshot(self) -> None:
        new = self.engine.snapshot()             # fully built before the swap
        self._snapshot = new

    @property
    def snapshot(self) -> Optional[Dict]:
        return self._snapshot

    @property
    def n(self) -> int:
        return self._h.shape[0]

    def device_bytes(self) -> int:
        """Resident device state: (dist + pred) — the budgeted resource,
        at 4 bytes an entry whatever the dtype (the JAX pool's count)."""
        if self.engine is None:
            return 0
        per = self.n * self.n * 4
        return per * (2 if self._with_pred else 1)

    def staleness(self) -> int:
        """State versions the snapshot is behind (queued and in-flight
        batches included)."""
        snap = self._snapshot
        if snap is None:
            return len(self.pending) + self._inflight
        eng = self.engine
        head = eng.version if eng is not None else self._evicted_version
        return (
            max(head - snap["version"], 0) + len(self.pending) + self._inflight
        )

    # -- recovery policy ----------------------------------------------------

    def evict(self) -> None:
        """Drop the device engine under memory pressure; snapshot and cost
        matrix stay host-side, so the slot still answers (stale) queries
        and re-admits deterministically."""
        with self._lock:
            if self.engine is None:
                return
            self._h = self.engine.h              # authoritative costs survive the engine
            self._evicted_version = self.engine.version
            self.engine = None
            self.stats.inc("evictions")
            self._transition(SlotState.EVICTED, "memory budget (LRU)")
            # eviction is a policy action, not a fault: its later re-admission
            # must not inflate the fault-recovery-time metric
            self._unhealthy_since = None

    def readmit(self) -> None:
        """Deterministic re-admission after eviction: rebuild from the
        retained cost matrix (queued updates replay at the next drain)."""
        with self._lock:
            self.stats.inc("readmissions")
            self.build()

    def recover(self) -> bool:
        """Re-solve-on-drift / quarantine recovery: full re-solve from the
        authoritative costs, re-probe, commit on success.  Returns healthy.
        A crashed durable slot (no engine, no snapshot) restores from its
        checkpoint + journal instead of cold-building."""
        with self._lock:
            if self.engine is None:
                if self.durable and self._snapshot is None:
                    return self.restore()
                self.readmit()
                return self.state == SlotState.HEALTHY
            self.engine.solve_full()
            probe = self.engine.health_probe(self.probe_samples, self._rng)
            if probe["ok"]:
                self._commit_snapshot()
                self._transition(SlotState.HEALTHY, "recovered (full re-solve + probe ok)")
                return True
            # a full solve from clean inputs still probing bad: quarantine —
            # serve the snapshot, never the state
            self.stats.inc("probe_failures")
            self.stats.inc("quarantines")
            self._transition(SlotState.QUARANTINED, f"recovery probe failed: {probe}")
            return False

    # -- durability (crash / restore / checkpoint) ---------------------------

    def checkpoint(self) -> Optional[str]:
        """Atomic durable snapshot of the engine state; truncates the
        journal behind it (records at ``v0 < version`` are folded in)."""
        with self._lock:
            if not self.durable or self.engine is None:
                return None
            path = save_engine_checkpoint(self._ck_dir, self.engine)
            self.journal.truncate(self.engine.version)
            self.stats.inc("checkpoints")
            return path

    def crash(self) -> None:
        """Simulated process crash: every in-RAM artifact is dropped —
        engine, published snapshot, authority over ``h`` — leaving only
        the durable checkpoint + journal.  Pending batches are retained
        under the client-redelivery assumption (an acked update is in the
        journal; an unacked one is the client's to resend)."""
        with self._lock:
            self.engine = None
            self._snapshot = None
            self.stats.inc("crashes")
            self._transition(SlotState.QUARANTINED, "simulated process crash")

    def restore(self) -> bool:
        """Crash recovery for durable slots: load the latest checkpoint,
        rebuild the engine from its state (no cold solve), replay journal
        records past the checkpoint version to bit-exact head state,
        probe, republish.  Falls back to a cold build when no checkpoint
        was ever written.  Returns healthy."""
        with self._lock:
            if not self.durable:
                raise RuntimeError(f"slot {self.gid} has no durability dir")
            try:
                st = load_engine_checkpoint(self._ck_dir)
            except FileNotFoundError:
                # no checkpoint was ever written for this slot: a cold
                # build is the recovery, and the counter records that the
                # durable path degraded to one
                self.stats.inc("cold_rebuilds")
                self.build()
                return self.state == SlotState.HEALTHY
            eng = DynamicAPSP(
                st["h"], method=self._method, with_pred=self._with_pred,
                semiring=self._sr, state=st, device=self._device, **self._solve_kw,
            )
            replayed = self.journal.replay_onto(eng, min_version=st["version"])
            eng.journal = self.journal
            self.engine = eng
            self._h = eng.h
            self.stats.inc("restores")
            self.stats.inc("replayed_records", replayed)
            probe = eng.health_probe(self.probe_samples, self._rng)
            if not probe["ok"]:
                self.stats.inc("probe_failures")
                self._transition(
                    SlotState.QUARANTINED, f"restore probe failed: {probe}"
                )
                return False
            self._commit_snapshot()
            self._transition(
                SlotState.HEALTHY,
                f"restored from checkpoint v{st['version']} + {replayed} journal records",
            )
            return True

    # -- updates ------------------------------------------------------------

    def apply_update(self, u: np.ndarray, v: np.ndarray, w: np.ndarray) -> Dict:
        """Apply one (possibly coalesced) update batch through the full
        protection stack: validation, injected chaos, bounded retry with
        backoff + jitter, post-update probe, snapshot commit."""
        with self._lock:
            if self.engine is None:
                if self.durable and self._snapshot is None:
                    self.restore()
                else:
                    self.readmit()
            self.injector.maybe_latency()
            w, injected_nan = self.injector.corrupt_update(w)
            try:
                info = self._apply_with_retry(u, v, w)
            except UpdateError:
                # poisoned batch rejected at the validation boundary: engine
                # state untouched, slot stays in its current state
                self.stats.inc("updates_rejected")
                raise
            self.stats.inc("updates_applied")
            if self.injector.maybe_poison_state(self.engine) is not None:
                info["poison_injected"] = True
            probe = self.engine.health_probe(self.probe_samples, self._rng)
            if not probe["ok"]:
                self.stats.inc("probe_failures")
                self._transition(
                    SlotState.DEGRADED,
                    f"post-update probe failed: "
                    f"domain={probe['domain_violations']} "
                    f"edge={probe['edge_violations']} "
                    f"tri={probe['triangle_violations']}",
                )
                self.recover()
            else:
                self._commit_snapshot()
                if self.state != SlotState.HEALTHY:
                    self._transition(SlotState.HEALTHY, "update + probe ok")
            info["injected_nan"] = injected_nan
            info["slot_state"] = self.state
            return info

    def _apply_with_retry(self, u, v, w) -> Dict:
        # retrying a whole batch is safe: updates are "set edge (u,v) to w"
        # requests, so re-applying after a partial failure is idempotent
        attempt = 0
        recovered_once = False
        while True:
            try:
                self.injector.maybe_crash()
                return self.engine.update(u, v, w)
            except RuntimeError as e:
                # transient fault (InjectedCrash under chaos, a CUDA runtime
                # error or torch.cuda.OutOfMemoryError otherwise): bounded retry
                # with exponential backoff + jitter, then quarantine + full
                # rebuild — recover() re-solves so a broken engine heals
                self.stats.inc("retries")
                attempt += 1
                if attempt > self.max_retries:
                    self.stats.inc("quarantines")
                    self._transition(
                        SlotState.QUARANTINED,
                        f"{attempt} consecutive apply failures ({e})",
                    )
                    if recovered_once or not self.recover():
                        # a persistent fault, not a transient one: stay
                        # quarantined and surface it — the pool requeues the
                        # batch and serves snapshots until the fault clears
                        raise
                    recovered_once = True
                    attempt = 0              # recovered: one fresh retry budget
                    continue
                backoff = self.backoff_base_s * (2 ** (attempt - 1))
                time.sleep(backoff * (1.0 + 0.25 * float(self._rng.uniform())))

    # -- queries ------------------------------------------------------------

    def snapshot_answer(self, qi, qj, **flags) -> QueryResult:
        """Bounded-staleness answer from the last-known-good snapshot."""
        snap = self._snapshot
        if snap is None:
            raise RuntimeError(
                f"slot {self.gid} has no committed snapshot to degrade to"
            )
        return QueryResult(
            values=_values(snap["dist"][_index(qi, "cpu"), _index(qj, "cpu")]),
            source="snapshot",
            staleness=self.staleness(),
            slot_state=self.state,
            version=snap["version"],
            **flags,
        )

    def live_values(self, qi, qj) -> np.ndarray:
        """Fresh values off the live engine (called under the pool's
        deadline wrapper; includes any injected latency spike): gathered on
        the device, one sync to bring them to the host."""
        self.injector.maybe_latency()
        return _values(self.engine.dist[_index(qi, self._device), _index(qj, self._device)])

    def reader(self) -> ThreadPoolExecutor:
        """This slot's deadline-read worker (lazy), one a slot: with one
        shared worker, a single slow dispatch would queue every other
        slot's live reads behind it."""
        if self._reader is None:
            self._reader = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"slot{self.gid}-read"
            )
        return self._reader

    def close(self) -> None:
        if self._reader is not None:
            self._reader.shutdown(wait=False)
            self._reader = None
        if self.journal is not None:
            self.journal.close()


class EnginePool:
    """Supervisor over :class:`EngineSlot`\\ s: admission, scheduling,
    deadlines, memory budget, verification, and aggregate accounting.
    The engines live on ``device``, the card unless the caller names
    another.

    ``async_updates=True`` starts the background
    :class:`~repro_torch.launch.executor.UpdateExecutor` (``executor_workers``
    threads): submits and ``drain_all`` enqueue, queries read published
    snapshots, ``flush`` is the barrier.  ``durability_dir`` makes every
    slot journaled + checkpointed (``checkpoint_every`` successful drains
    per checkpoint; 0 = only the build-time checkpoint).
    ``reader_workers`` sizes the sync-path deadline readers (0 = one
    dedicated worker per slot; N > 0 = one shared N-worker pool).
    """

    def __init__(
        self,
        *,
        method: str = "blocked_fw",
        with_pred: bool = False,
        semiring: SemiringLike = "tropical",
        solve_kw: Optional[Dict] = None,
        max_retries: int = 2,
        backoff_base_s: float = 0.005,
        deadline_s: float = 0.0,
        mem_budget_bytes: int = 0,
        backlog_watermark: int = 8,
        probe_samples: int = 64,
        injector: Optional[FaultInjector] = None,
        seed: int = 0,
        async_updates: bool = False,
        executor_workers: int = 1,
        reader_workers: int = 0,
        durability_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        device=None,
    ):
        self._device = torch.device(default_device(device))
        self._method = method
        self._with_pred = bool(with_pred)
        self._sr = get_semiring(semiring)
        self._solve_kw = dict(solve_kw or {})
        self._max_retries = int(max_retries)
        self._backoff_base_s = float(backoff_base_s)
        self.deadline_s = float(deadline_s)
        self.mem_budget_bytes = int(mem_budget_bytes)
        self.backlog_watermark = int(backlog_watermark)
        self._probe_samples = int(probe_samples)
        self.injector = injector or FaultInjector()
        self._seed = seed
        self.reader_workers = int(reader_workers)
        self.durability_dir = durability_dir
        self.checkpoint_every = int(checkpoint_every)
        self.slots: Dict[int, EngineSlot] = {}
        self.events: List[Dict] = []
        self._clock = itertools.count(1)         # GIL-atomic logical LRU clock
        self._executor: Optional[ThreadPoolExecutor] = None
        self._drains_since_ckpt: Dict[int, int] = {}
        self.stats = Counters({
            "queries_live": 0, "queries_snapshot": 0, "queries_shed": 0,
            "deadline_misses": 0, "poisoned_served": 0, "poison_blocked": 0,
            "updates_submitted": 0, "updates_rejected": 0,
            "updates_failed": 0, "drain_coalesced": 0, "drain_fallbacks": 0,
            "drain_batched": 0,
            "over_budget_admissions": 0,
            "verify_drift": 0, "verify_ok": 0,
            "crash_restores": 0,
        })
        self.executor: Optional[UpdateExecutor] = None
        if async_updates:
            self.executor = UpdateExecutor(self, workers=executor_workers)

    # -- admission / memory budget ------------------------------------------

    def admit(self, gid: int, h: np.ndarray) -> EngineSlot:
        """Admit one persistent graph under the memory budget (evicting LRU
        slots if needed) and warm it (cold solve + probe + snapshot)."""
        slot = EngineSlot(
            gid, h,
            method=self._method, with_pred=self._with_pred, semiring=self._sr,
            solve_kw=self._solve_kw, max_retries=self._max_retries,
            backoff_base_s=self._backoff_base_s,
            probe_samples=self._probe_samples, injector=self.injector,
            seed=self._seed + gid, events=self.events,
            durability_dir=self.durability_dir, device=self._device,
        )
        self.slots[gid] = slot
        self._touch(slot)
        self._ensure_budget(slot)
        slot.build()
        return slot

    def _touch(self, slot: EngineSlot) -> None:
        slot.last_access = next(self._clock)

    def live_bytes(self) -> int:
        return sum(s.device_bytes() for s in self.slots.values())

    def _need_bytes(self, slot: EngineSlot) -> int:
        per = slot.n * slot.n * 4
        return per * (2 if self._with_pred else 1)

    def _ensure_budget(self, target: EngineSlot) -> None:
        """Evict least-recently-used live slots until ``target``'s engine
        fits the (possibly chaos-squeezed) budget.  A victim whose lock is
        held (mid-drain on an executor worker) is skipped rather than
        waited on — blocking here while holding ``target``'s lock would be
        a lock-ordering deadlock."""
        budget = self.injector.maybe_mem_squeeze(self.mem_budget_bytes)
        if budget <= 0:
            return
        need = self._need_bytes(target)
        skipped: set = set()
        while self.live_bytes() + need - target.device_bytes() > budget:
            victims = [
                s for s in self.slots.values()
                if s is not target and s.engine is not None
                and s.gid not in skipped
            ]
            if not victims:
                # nothing evictable: serve over budget rather than refuse
                self.stats.inc("over_budget_admissions")
                return
            victims.sort(key=lambda s: s.last_access)
            victim = victims[0]
            if victim._lock.acquire(blocking=False):
                try:
                    victim.evict()
                finally:
                    victim._lock.release()
            else:
                skipped.add(victim.gid)

    # -- update scheduling ---------------------------------------------------

    def submit_update(self, gid: int, u, v, w) -> None:
        """Queue one edge-update batch for ``gid``.  Sync pools apply it at
        the next drain (queries against a backlogged pool shed to
        snapshots); async pools also hand the slot to the background
        executor."""
        self.stats.inc("updates_submitted")
        slot = self.slots[gid]
        batch = (
            np.asarray(u, np.int32), np.asarray(v, np.int32),
            np.asarray(w, np.float32),
        )
        with slot._lock:
            slot.pending.append(batch)
        if self.executor is not None:
            self.executor.enqueue(gid)

    def backlog(self) -> int:
        return sum(len(s.pending) for s in self.slots.values())

    def drain(self, gid: int) -> List[Dict]:
        """Apply ``gid``'s queued update batches, coalescing them into one
        rank-k dispatch (duplicate edges resolve last-wins inside the
        engine, matching sequential semantics).  A poisoned coalesced batch
        falls back to per-batch application so one bad batch can't veto its
        clean neighbors.  Correlated chaos fires here: ``begin_drain``
        may open a backend-loss / cache-storm window, and durable slots
        may take the crash-restore drill before applying."""
        slot = self.slots[gid]
        self._touch(slot)
        self.injector.begin_drain()
        with slot._lock:
            if slot.durable and self.injector.maybe_crash_restore():
                slot.crash()
                slot.restore()
                self.stats.inc("crash_restores")
            if not slot.pending:
                return []
            if slot.engine is None:
                self._ensure_budget(slot)
                if slot.durable and slot._snapshot is None:
                    slot.restore()
                else:
                    slot.readmit()
            batches = slot.pending
            slot._inflight += len(batches)       # staleness covers popped batches
            slot.pending = []
            try:
                infos = self._drain_batches(slot, batches)
            finally:
                slot._inflight -= len(batches)
            self._maybe_checkpoint(slot)
            return infos

    def _drain_batches(self, slot: EngineSlot, batches: List) -> List[Dict]:
        if len(batches) > 1:
            self.stats.inc("drain_coalesced")
            u = np.concatenate([b[0] for b in batches])
            v = np.concatenate([b[1] for b in batches])
            w = np.concatenate([b[2] for b in batches])
            try:
                return [slot.apply_update(u, v, w)]
            except UpdateError:
                # fall through to per-batch application: drop only the
                # poisoned batch(es), keep the rest
                self.stats.inc("drain_fallbacks")
            except RuntimeError as e:
                # persistent apply fault (slot now quarantined): requeue and
                # serve snapshots until the fault clears
                self.stats.inc("updates_failed")
                slot.pending = batches + slot.pending
                return [{"path": "failed", "error": str(e),
                         "slot_state": slot.state}]
        infos = []
        for i, (u, v, w) in enumerate(batches):
            try:
                infos.append(slot.apply_update(u, v, w))
            except UpdateError as e:
                self.stats.inc("updates_rejected")
                infos.append({"path": "rejected", "error": str(e),
                              "slot_state": slot.state})
            except RuntimeError as e:
                self.stats.inc("updates_failed")
                slot.pending = batches[i:] + slot.pending
                infos.append({"path": "failed", "error": str(e),
                              "slot_state": slot.state})
                break
        return infos

    def _maybe_checkpoint(self, slot: EngineSlot) -> None:
        if (
            not slot.durable or self.checkpoint_every <= 0
            or slot.state != SlotState.HEALTHY
        ):
            return
        n = self._drains_since_ckpt.get(slot.gid, 0) + 1
        if n >= self.checkpoint_every:
            slot.checkpoint()
            n = 0
        self._drains_since_ckpt[slot.gid] = n

    def drain_all(self, batched: bool = True) -> None:
        """Drain every slot's queue.  Async pools *enqueue* every backlogged
        slot on the background executor and return immediately (use
        :meth:`flush` for the barrier).  Sync pools drain on the caller
        thread; when ``batched`` (the default) and no chaos is configured,
        healthy same-shape slots are coalesced into one stacked (G, ·, ·)
        rank-k dispatch per tick via
        :func:`repro_torch.core.apply_updates_batched` — one batched
        fixpoint over the whole group instead of G sequential dispatches.
        Slots the batcher defers (worsenings, plateau semirings, validation
        errors) requeue their original batches and fall back to the
        per-slot :meth:`drain` path, so semantics match the unbatched loop
        exactly.  Under fault injection the batched path is skipped
        entirely: chaos hooks (crash, latency, corruption) are wired into
        the per-slot apply stack and must keep firing per update."""
        if self.executor is not None:
            for gid, slot in list(self.slots.items()):
                if slot.pending:
                    self.executor.enqueue(gid)
            return
        self._drain_all_sync(batched)

    def _drain_all_sync(self, batched: bool = True) -> None:
        if not batched or self.injector.spec.any():
            for gid in list(self.slots):
                self.drain(gid)
            return
        groups: Dict[Tuple[int, str], List[EngineSlot]] = {}
        rest: List[int] = []
        for gid, slot in list(self.slots.items()):
            if (
                slot.pending
                and slot.engine is not None
                and slot.state == SlotState.HEALTHY
            ):
                key = (slot.n, str(slot.engine.dist.dtype))
                groups.setdefault(key, []).append(slot)
            else:
                rest.append(gid)
        for gid in rest:
            self.drain(gid)
        for members in groups.values():
            if len(members) < 2:
                for slot in members:
                    self.drain(slot.gid)
                continue
            popped: List[Tuple[EngineSlot, List]] = []
            coalesced = []
            for slot in members:
                self._touch(slot)
                slot._lock.acquire()
                bs = slot.pending
                slot._inflight += len(bs)
                slot.pending = []
                popped.append((slot, bs))
                coalesced.append((
                    np.concatenate([b[0] for b in bs]),
                    np.concatenate([b[1] for b in bs]),
                    np.concatenate([b[2] for b in bs]),
                ))
            try:
                infos, deferred = apply_updates_batched(
                    [slot.engine for slot, _ in popped], coalesced
                )
                self.stats.inc("drain_batched")
                deferred_set = set(deferred)
                for i, (slot, bs) in enumerate(popped):
                    if i in deferred_set:
                        # the batcher never touched this engine: requeue the
                        # original batches and run the sequential path (which
                        # handles worsenings, rejections, and retries)
                        slot.pending = bs + slot.pending
                        continue
                    if len(bs) > 1:
                        self.stats.inc("drain_coalesced")
                    slot.stats.inc("updates_applied")
                    probe = slot.engine.health_probe(slot.probe_samples, slot._rng)
                    if not probe["ok"]:
                        slot.stats.inc("probe_failures")
                        slot._transition(
                            SlotState.DEGRADED,
                            f"post-batched-drain probe failed: "
                            f"domain={probe['domain_violations']} "
                            f"edge={probe['edge_violations']} "
                            f"tri={probe['triangle_violations']}",
                        )
                        slot.recover()
                    else:
                        slot._commit_snapshot()
                        if slot.state != SlotState.HEALTHY:
                            slot._transition(SlotState.HEALTHY, "batched drain + probe ok")
                    self._maybe_checkpoint(slot)
            finally:
                for slot, bs in popped:
                    slot._inflight -= len(bs)
                    slot._lock.release()
            for i, (slot, _) in enumerate(popped):
                if i in set(deferred):
                    self.drain(slot.gid)

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Barrier: every queued update applied (async: waits out the
        executor; sync: drains inline).  Returns False on timeout."""
        if self.executor is None:
            self._drain_all_sync()
            return True
        self.drain_all()
        return self.executor.flush(timeout)

    # -- queries ------------------------------------------------------------

    def query(self, gid: int, qi, qj, deadline_s: Optional[float] = None) -> QueryResult:
        """Answer a distance query under the full protection stack.

        Sync pools: admission control (shed to snapshot over the backlog
        watermark), drain-then-serve otherwise, per-query deadline around
        the live dispatch, domain check on every live answer (poison is
        blocked, degraded, and answered from the snapshot instead).

        Async pools: never touch the live engine — read the last
        *published* snapshot reference (atomic swap at commit), tag with
        exact staleness; staleness 0 from a healthy slot is
        current-version exact (``source="live"``)."""
        t0 = time.perf_counter()
        slot = self.slots[gid]
        self._touch(slot)
        if self.executor is not None:
            return self._query_published(slot, qi, qj, t0)
        deadline = self.deadline_s if deadline_s is None else float(deadline_s)

        if self.backlog() > self.backlog_watermark:
            self.stats.inc("queries_shed")
            r = slot.snapshot_answer(qi, qj, shed=True)
            r.latency_s = time.perf_counter() - t0
            return r
        self.drain(gid)
        if slot.state != SlotState.HEALTHY or slot.engine is None:
            self.stats.inc("queries_snapshot")
            r = slot.snapshot_answer(qi, qj)
            r.latency_s = time.perf_counter() - t0
            return r

        values, missed = self._live_with_deadline(slot, qi, qj, deadline)
        if missed:
            r = slot.snapshot_answer(qi, qj, deadline_missed=True)
            r.latency_s = time.perf_counter() - t0
            return r
        if bool(domain_violations(values, self._sr).any()):
            # a poisoned live answer: block it, degrade, recover, serve the
            # last-known-good snapshot instead
            self.stats.inc("poison_blocked")
            slot.stats.inc("poison_blocked")
            slot._transition(SlotState.DEGRADED, "poisoned live answer blocked")
            slot.recover()
            r = slot.snapshot_answer(qi, qj)
            r.latency_s = time.perf_counter() - t0
            return r
        self.stats.inc("queries_live")
        return QueryResult(
            values=values, source="live", staleness=0,
            slot_state=slot.state, latency_s=time.perf_counter() - t0,
        )

    def _query_published(self, slot: EngineSlot, qi, qj, t0: float) -> QueryResult:
        """Lock-free read of the published snapshot (async mode)."""
        shed = self.backlog() > self.backlog_watermark
        pub = slot._snapshot
        if pub is None:
            # mid crash-restore drill: wait for the republish under the
            # slot lock (the only blocking case, and it ends in a fresh
            # reference or a quarantined slot with no state to serve)
            with slot._lock:
                pub = slot._snapshot
            if pub is None:
                raise RuntimeError(
                    f"slot {slot.gid} has no published state to serve"
                )
        values = _values(pub["dist"][_index(qi, "cpu"), _index(qj, "cpu")])
        if bool(domain_violations(values, self._sr).any()):
            # published state is probe-committed, so this should be
            # unreachable — but the zero-poisoned-answers invariant is
            # checked on every served value, not assumed
            self.stats.inc("poison_blocked")
            slot.stats.inc("poison_blocked")
            with slot._lock:
                slot._transition(SlotState.DEGRADED, "poisoned published answer blocked")
                slot.recover()
                pub = slot._snapshot
            values = _values(pub["dist"][_index(qi, "cpu"), _index(qj, "cpu")])
        # exact staleness relative to the reference we actually answered
        # from (the snapshot may have been swapped since we grabbed pub)
        eng = slot.engine
        head = eng.version if eng is not None else slot._evicted_version
        stale = (
            max(head - pub["version"], 0) + len(slot.pending) + slot._inflight
        )
        if shed:
            self.stats.inc("queries_shed")
        if stale == 0 and not shed and slot.state == SlotState.HEALTHY:
            self.stats.inc("queries_live")
            return QueryResult(
                values=values, source="live", staleness=0,
                slot_state=slot.state, version=pub["version"],
                latency_s=time.perf_counter() - t0,
            )
        self.stats.inc("queries_snapshot")
        return QueryResult(
            values=values, source="snapshot", staleness=stale,
            slot_state=slot.state, shed=shed, version=pub["version"],
            latency_s=time.perf_counter() - t0,
        )

    def _live_with_deadline(self, slot, qi, qj, deadline_s):
        """Run the live read, optionally under a timeout wrapper.  On a
        miss the in-flight dispatch is abandoned (it completes in the
        worker and is discarded) and the caller falls back to the
        snapshot — a late answer is a wrong answer under an SLO.  Readers
        are per-slot by default (``reader_workers=0``) so one slow
        dispatch cannot queue other slots' reads behind it; a positive
        ``reader_workers`` opts into one shared pool of that size."""
        if deadline_s <= 0:
            return slot.live_values(qi, qj), False
        if self.reader_workers > 0:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.reader_workers,
                    thread_name_prefix="pool-deadline",
                )
            ex = self._executor
        else:
            ex = slot.reader()
        fut = ex.submit(slot.live_values, qi, qj)
        try:
            return fut.result(timeout=deadline_s), False
        except FutureTimeout:
            fut.cancel()                   # a queued (not yet running) call is dropped
            slot.stats.inc("deadline_misses")
            self.stats.inc("deadline_misses")
            return None, True

    # -- verification / recovery --------------------------------------------

    def verify(self, gid: int) -> Dict:
        """Differential drift check: engine state vs a cold full solve of
        the authoritative cost matrix.  Drift transitions the slot to
        degraded, triggers re-solve-on-drift, and re-verifies; the report
        says whether recovery restored agreement."""
        slot = self.slots[gid]
        self.drain(gid)
        if self.executor is not None:
            self.executor.flush()
        with slot._lock:
            if slot.engine is None:
                self._ensure_budget(slot)
                if slot.durable and slot._snapshot is None:
                    slot.restore()
                else:
                    slot.readmit()
            ref = solve(
                slot.engine.h, method=self._method, with_pred=False,
                semiring=self._sr, validate=False, device=self._device, **self._solve_kw,
            )
            ok = bool(np.allclose(
                _values(slot.engine.dist), _values(ref.dist),
                rtol=1e-5, atol=1e-5, equal_nan=False,
            ))
            report = {"gid": gid, "ok": ok, "recovered": None,
                      "state": slot.state}
            if ok:
                self.stats.inc("verify_ok")
                return report
            self.stats.inc("verify_drift")
            slot.stats.inc("drift_detected")
            slot._transition(SlotState.DEGRADED, "verify drift vs cold solve")
            slot.recover()
            report["recovered"] = bool(np.allclose(
                _values(slot.engine.dist), _values(ref.dist),
                rtol=1e-5, atol=1e-5, equal_nan=False,
            )) if slot.engine is not None else False
            report["state"] = slot.state
            return report

    def recover_all(self, readmit: bool = False) -> None:
        """Drain every queue and recover every degraded / quarantined slot;
        ``readmit=True`` also rebuilds evicted slots (end-of-run check that
        the whole pool can return to healthy).  Async pools flush the
        executor first so recovery sees the settled state."""
        if self.executor is not None:
            self.flush(timeout=60.0)
        self._drain_all_sync()
        for slot in self.slots.values():
            with slot._lock:
                if slot.state in (SlotState.DEGRADED, SlotState.QUARANTINED):
                    slot.recover()
                elif readmit and slot.state == SlotState.EVICTED:
                    self._ensure_budget(slot)
                    slot.readmit()

    def checkpoint_all(self) -> int:
        """Checkpoint every durable healthy slot; returns how many."""
        n = 0
        for slot in self.slots.values():
            if slot.durable and slot.engine is not None:
                if slot.checkpoint() is not None:
                    n += 1
        return n

    # -- accounting ---------------------------------------------------------

    def recovery_times(self) -> List[float]:
        return [e["recovery_s"] for e in self.events if "recovery_s" in e]

    def state_counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SlotState.ALL}
        for slot in self.slots.values():
            out[slot.state] += 1
        return out

    def summary(self) -> Dict:
        """Aggregate report: pool stats + per-slot stats + lifecycle +
        injected-fault counts + recovery times."""
        slot_stats: Dict[str, int] = {}
        for slot in self.slots.values():
            for k, v in slot.stats.items():
                slot_stats[k] = slot_stats.get(k, 0) + v
        rec = self.recovery_times()
        out = {
            "pool": dict(self.stats),
            "slots": slot_stats,
            "states": self.state_counts(),
            "faults_injected": dict(self.injector.counts),
            "transitions": len([e for e in self.events if "from" in e]),
            "recoveries": len(rec),
            "recovery_s_max": max(rec) if rec else 0.0,
            "live_bytes": self.live_bytes(),
            "mem_budget_bytes": self.mem_budget_bytes,
        }
        if self.executor is not None:
            out["executor"] = dict(self.executor.stats)
        return out

    def close(self) -> None:
        if self.executor is not None:
            self.executor.stop()
            self.executor = None
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        for slot in self.slots.values():
            slot.close()
