"""Deterministic fault injection (chaos layer) for the serving tier,
ported from ``repro.launch.faults``.

The resilient pool (``repro_torch.launch.pool``) is only trustworthy if its
failure paths are *exercised*, not just written — this module injects the
faults the pool claims to survive, seeded so every chaos run is exactly
reproducible (same spec + seed + request stream => same faults at the same
requests).  The streams are the JAX package's: the same seed fires the
same faults in both packages.  ``python -m repro_torch.launch.serve
--fault-spec`` drives it.

Fault-spec grammar::

    spec      := entry ("," entry)*
    entry     := kind ":" rate [":" param]
    kind      := "nan" | "crash" | "latency" | "poison" | "mem"
               | "backend_loss" | "cache_storm" | "crash_restore"
    rate      := float in [0, 1]    (per-opportunity probability)
    param     := kind-specific number

    nan:R          an update batch gets one weight replaced by NaN
                   (must be *rejected* at the validation boundary)
    crash:R[:C]    applying an update raises InjectedCrash; C = consecutive
                   failures per injection (default 1; > max_retries forces
                   the quarantine path)
    latency:R[:MS] a latency spike of MS milliseconds (default 20) before a
                   dispatch (exercises deadlines / degraded answers)
    poison:R       one off-diagonal entry of the *solved state* is
                   overwritten with NaN after a successful update (a
                   simulated kernel fault; must be caught by health probes,
                   never served)
    mem:R[:F]      the pool's memory budget is transiently scaled by F
                   (default 0.5) for one admission decision (forces LRU
                   eviction + later re-admission)

**Correlated kinds**: real outages are correlated — a backend dies under
every graph at once, a kernel-cache flush makes every next dispatch pay the
rebuild.  Their opportunity point is the top of a pool drain
(:meth:`FaultInjector.begin_drain`), their blast radius is cross-slot,
counted in attempts (not wall-clock) so chaos runs stay deterministic:

    backend_loss:R[:A]   whole-backend loss mid-drain: the next A engine
                         apply attempts raise, across ALL slots (default 6)
    cache_storm:R[:K]    cache invalidation storm: the next K dispatches
                         each pay the ``latency_ms`` penalty (default K=8;
                         shares latency's MS param).  A latency charge
                         only: the kernels' build is not touched.
    crash_restore:R      process-crash drill: the pool crashes one durable
                         slot (drops its in-RAM engine + snapshot) and
                         restores it from checkpoint + journal replay

Example: ``nan:0.15,crash:0.1:3,latency:0.1:30,poison:0.08,mem:0.05:0.5``
or correlated: ``backend_loss:0.3:6,cache_storm:0.2:8,crash_restore:0.25``.

Each injection point draws from its *own* seeded generator, so enabling one
fault kind never shifts another kind's schedule.  The injector is
thread-safe: the background update executor, per-slot deadline readers and
the caller all hit the same instance, so every RNG draw and sticky-window
decrement happens under one lock and the counters are
:class:`repro_torch.launch.stats.Counters`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from .stats import Counters

__all__ = ["FaultSpec", "FaultInjector", "InjectedCrash", "NULL_INJECTOR"]


class InjectedCrash(RuntimeError):
    """A chaos-injected transient failure of one engine operation.  The
    pool treats it like any transient update failure: bounded retry with
    backoff, then quarantine."""


@dataclass(frozen=True)
class FaultSpec:
    """Parsed fault rates + parameters (see module docstring grammar)."""

    nan: float = 0.0
    crash: float = 0.0
    crash_count: int = 1
    latency: float = 0.0
    latency_ms: float = 20.0
    poison: float = 0.0
    mem: float = 0.0
    mem_frac: float = 0.5
    backend_loss: float = 0.0
    backend_count: int = 6
    cache_storm: float = 0.0
    storm_count: int = 8
    crash_restore: float = 0.0

    KINDS = (
        "nan", "crash", "latency", "poison", "mem",
        "backend_loss", "cache_storm", "crash_restore",
    )

    @classmethod
    def parse(cls, text: Optional[str]) -> "FaultSpec":
        """Parse the ``kind:rate[:param]`` grammar; '' / None => no faults."""
        if not text:
            return cls()
        kw: Dict[str, float] = {}
        for entry in text.split(","):
            parts = [p.strip() for p in entry.split(":")]
            if len(parts) < 2 or parts[0] not in cls.KINDS:
                raise ValueError(
                    f"bad fault-spec entry {entry!r}: expected "
                    f"kind:rate[:param] with kind in {cls.KINDS}"
                )
            kind = parts[0]
            try:
                rate = float(parts[1])
                param = float(parts[2]) if len(parts) > 2 else None
            except ValueError:
                raise ValueError(f"bad number in fault-spec entry {entry!r}") from None
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate out of [0, 1] in fault-spec entry {entry!r}")
            if len(parts) > 3:
                raise ValueError(f"too many fields in fault-spec entry {entry!r}")
            kw[kind] = rate
            if param is not None:
                if kind == "crash":
                    kw["crash_count"] = int(param)
                elif kind == "latency":
                    kw["latency_ms"] = param
                elif kind == "mem":
                    kw["mem_frac"] = param
                elif kind == "backend_loss":
                    kw["backend_count"] = int(param)
                elif kind == "cache_storm":
                    kw["storm_count"] = int(param)
                else:
                    raise ValueError(
                        f"fault kind {kind!r} takes no parameter ({entry!r})"
                    )
        return cls(**kw)

    def any(self) -> bool:
        return any(getattr(self, k) > 0 for k in self.KINDS)


@dataclass
class FaultInjector:
    """Seeded injector: one independent generator per fault kind, a counter
    per kind in ``counts``, and an ``events`` log the benchmarks read to
    align injected faults with recovery times."""

    spec: FaultSpec = field(default_factory=FaultSpec)
    seed: int = 0

    def __post_init__(self):
        root = np.random.default_rng(self.seed)
        self._rng = {
            kind: np.random.default_rng(root.integers(0, 2**63))
            for kind in FaultSpec.KINDS
        }
        self.counts = Counters({k: 0 for k in FaultSpec.KINDS})
        self.events: list = []
        self._pending_crashes = 0
        self._backend_left = 0      # correlated window: apply attempts left
        self._storm_left = 0        # correlated window: dispatches left
        # numpy Generators and the sticky-window counters are not
        # thread-safe; the executor, deadline readers, and the caller all
        # share this injector
        self._lock = threading.Lock()

    def _fire(self, kind: str) -> bool:
        rate = getattr(self.spec, kind)
        if rate <= 0.0:
            return False
        with self._lock:
            if self._rng[kind].uniform() >= rate:
                return False
            self.events.append({"t": time.monotonic(), "kind": kind})
        self.counts.inc(kind)
        return True

    # -- injection points (called by the pool) ------------------------------

    def corrupt_update(self, w: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Maybe replace one update weight with NaN; returns (w', injected)."""
        if w.size and self._fire("nan"):
            w = w.copy()
            w[int(self._rng["nan"].integers(0, w.size))] = np.nan
            return w, True
        return w, False

    def maybe_crash(self) -> None:
        """Raise :class:`InjectedCrash` at the injected schedule.  One
        injection yields ``crash_count`` consecutive raises, so a count
        above the pool's ``max_retries`` exercises the quarantine path.
        An open whole-backend-loss window (see :meth:`begin_drain`) takes
        precedence: it fails *every* slot's attempts until it drains."""
        with self._lock:
            if self._backend_left > 0:
                self._backend_left -= 1
                backend = True
            else:
                backend = False
        if backend:
            self.counts.inc("backend_denied")
            raise InjectedCrash("backend loss: all engines unavailable")
        with self._lock:
            if self._pending_crashes > 0:
                self._pending_crashes -= 1
                raise InjectedCrash("injected crash (sticky)")
        if self._fire("crash"):
            with self._lock:
                self._pending_crashes = max(int(self.spec.crash_count) - 1, 0)
            raise InjectedCrash("injected crash")

    def maybe_latency(self) -> float:
        """Maybe sleep a spike; returns the injected seconds (0 if none).
        An open cache-storm window charges the ``latency_ms`` penalty to
        every dispatch until its budget drains, independent of the latency
        draw."""
        s = 0.0
        with self._lock:
            if self._storm_left > 0:
                self._storm_left -= 1
                storm = True
            else:
                storm = False
        if storm:
            self.counts.inc("storm_recompiles")
            s += self.spec.latency_ms / 1e3
        elif self._fire("latency"):
            s += self.spec.latency_ms / 1e3
        if s:
            time.sleep(s)
        return s

    # -- correlated kinds: per-drain opportunity points ---------------------

    def begin_drain(self) -> None:
        """Correlated-failure opportunity at the top of a pool drain: maybe
        open a whole-backend-loss window (next ``backend_count`` apply
        attempts raise, across all slots) or a cache invalidation storm
        (next ``storm_count`` dispatches pay the ``latency_ms`` penalty).
        Windows are counted in attempts, not wall-clock, so chaos schedules
        stay deterministic for a given seed + request stream."""
        if self._fire("backend_loss"):
            with self._lock:
                self._backend_left = max(int(self.spec.backend_count), 1)
        if self._fire("cache_storm"):
            with self._lock:
                self._storm_left = max(int(self.spec.storm_count), 1)

    def maybe_crash_restore(self) -> bool:
        """Per-drain decision to run the crash-restore drill on one durable
        slot (the pool picks the victim and drives the restore)."""
        return self._fire("crash_restore")

    def backend_down(self) -> bool:
        """True while a whole-backend-loss window is open."""
        with self._lock:
            return self._backend_left > 0

    def maybe_poison_state(self, engine) -> Optional[Tuple[int, int]]:
        """Maybe overwrite one off-diagonal solved-state entry with NaN (a
        simulated kernel fault downstream of validation); returns the
        poisoned index or None."""
        if not self._fire("poison"):
            return None
        n = engine.n
        rng = self._rng["poison"]
        i = int(rng.integers(0, n))
        j = int((i + 1 + rng.integers(0, n - 1)) % n)
        # into a clone, as JAX's functional ``.at[].set``: no tensor handed
        # out earlier (a snapshot, a caller's handle) changes
        engine._dist = engine._dist.clone()
        engine._dist[i, j] = float("nan")
        return (i, j)

    def maybe_mem_squeeze(self, budget_bytes: int) -> int:
        """Maybe scale a memory budget for one admission decision."""
        if budget_bytes > 0 and self._fire("mem"):
            return max(int(budget_bytes * self.spec.mem_frac), 1)
        return budget_bytes


#: shared no-op injector (all rates zero) for pools without chaos.
NULL_INJECTOR = FaultInjector(FaultSpec(), seed=0)
