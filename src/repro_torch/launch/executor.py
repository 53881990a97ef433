"""Background update executor: the serving tier's write path off the read
path, ported from ``repro.launch.executor``.

A synchronous pool applies update batches on the caller thread at drain
time, so a query either pays for the drain inline or sheds to a snapshot.
:class:`UpdateExecutor` moves the apply work to background worker threads:
``submit_update`` / ``drain_all`` become an *enqueue*, workers call
``pool.drain(gid)`` (the full protection stack — validation, chaos,
bounded retry, probes, snapshot commit — unchanged), and each successful
drain publishes the slot's new state by the atomic snapshot-reference
swap.  Live reads never wait on an in-flight pass: the query path reads the
last *published* reference and tags the answer with its exact staleness.

The drains' kernels run on the worker thread's current CUDA stream, the
device's default stream, as the caller's do; the kernel wrappers' launch
counters are bumped under one lock (``repro_torch.kernels._counts``).

Scheduling is a deduplicated FIFO of slot ids under one condition
variable: a gid queues at most once (an in-flight drain re-queues itself
only if new batches arrived while it ran), so a hot graph cannot starve
the queue, and per-slot ordering is preserved because the pool's drain
pops the whole pending list under the slot lock.  ``flush`` is the
barrier the sync world needs: it waits until the queue is empty *and* no
worker holds a drain.

Worker failures cannot take the loop down: ``pool.drain`` already routes
engine faults (requeue + quarantine + recovery), so an exception escaping
it is a bug — it is recorded (count + traceback) and the worker moves on.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Optional

from .stats import Counters

__all__ = ["UpdateExecutor"]

_HEALTHY = "healthy"      # SlotState.HEALTHY (a string, to avoid a cycle with .pool)


class UpdateExecutor:
    """Deduplicated FIFO of slot drains over ``workers`` background threads.

    The executor owns no engine state and no locks of its own beyond the
    queue condition — all slot mutation happens inside ``pool.drain``
    under the per-slot lock, so executor workers, the caller thread, and
    deadline readers compose without lock-ordering constraints.
    """

    def __init__(self, pool, workers: int = 1):
        self._pool = pool
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._queued: set = set()
        self._inflight: set = set()
        self._stopped = False
        self.last_error: Optional[str] = None
        self.stats = Counters({
            "enqueued": 0, "drains": 0, "requeues": 0, "drain_errors": 0,
        })
        self._threads = [
            threading.Thread(
                target=self._run, daemon=True, name=f"update-exec-{i}"
            )
            for i in range(max(int(workers), 1))
        ]
        for t in self._threads:
            t.start()

    # -- producer side -------------------------------------------------------

    def enqueue(self, gid: int) -> bool:
        """Schedule a drain of ``gid``; returns False if it was already
        queued (the pending batches it carries will be drained by the
        queued pass — drains pop the whole pending list)."""
        with self._cond:
            if self._stopped:
                raise RuntimeError("executor is stopped")
            if gid in self._queued:
                return False
            self._queue.append(gid)
            self._queued.add(gid)
            self._cond.notify()
        self.stats.inc("enqueued")
        return True

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty and no drain is in flight;
        returns False on timeout (the chaos smoke treats that as a
        deadlock and fails fast)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._queue or self._inflight:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining)
        return True

    def backlog(self) -> int:
        with self._cond:
            return len(self._queue) + len(self._inflight)

    def stop(self, timeout: float = 5.0) -> None:
        """Stop workers after the current drains finish; queued-but-unstarted
        gids are dropped (their batches stay in ``slot.pending`` for a
        later synchronous drain)."""
        with self._cond:
            self._stopped = True
            self._queue.clear()
            self._queued.clear()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)

    # -- worker side ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait()
                if self._stopped:
                    return
                gid = self._queue.popleft()
                self._queued.discard(gid)
                self._inflight.add(gid)
            try:
                self._pool.drain(gid)
                self.stats.inc("drains")
            except Exception:
                # pool.drain routes every expected fault itself (requeue +
                # quarantine + recovery); an escape is a bug — record it
                # for the summary and keep the worker alive
                self.stats.inc("drain_errors")
                self.last_error = traceback.format_exc()
            finally:
                with self._cond:
                    self._inflight.discard(gid)
                    self._cond.notify_all()
            self._maybe_requeue(gid)

    def _maybe_requeue(self, gid: int) -> None:
        # batches that arrived while the drain ran (or that a crash-restore
        # drill left queued) still need a pass; an unhealthy slot is left
        # for recover_all so a persistent fault cannot spin the worker
        slot = self._pool.slots.get(gid)
        if slot is None:
            return
        with self._cond:
            stopped = self._stopped
        if not stopped and slot.pending and slot.state == _HEALTHY:
            if self.enqueue(gid):
                self.stats.inc("requeues")
