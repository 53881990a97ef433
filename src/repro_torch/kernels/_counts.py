"""The kernel wrappers' launch counters, bumped under one lock.

Each wrapper adds one to its count where it launches its kernel.  The
serving tier launches kernels from background drain threads as well as the
caller's, and ``counts[name] += 1`` is a read-modify-write that loses
increments when two threads interleave, so every count goes through
:func:`bump` (``fw_round.rounds``, a module-level int, takes :data:`lock`
itself).
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["lock", "bump"]

lock = threading.Lock()


def bump(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]`` under :data:`lock`."""
    with lock:
        counts[name] += 1
