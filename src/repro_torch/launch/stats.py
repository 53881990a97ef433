"""Thread-safe counter maps for the serving tier, ported from
``repro.launch.stats``.

The serving tier has three mutation sources — the caller, the per-slot
deadline readers and the background update executor — and
``stats["x"] += 1`` is a read-modify-write that loses increments when a
thread switch falls between its load and its store.  The chaos smoke gates
on these counters, so a lost ``poison_blocked`` increment is not cosmetic.

:class:`Counters` is a locked counter map whose only mutation primitive is
the atomic :meth:`inc`.  It reads like a dict (``keys`` / ``items`` /
``get`` / ``[]`` / ``in`` / ``dict(c)``), so summaries and tests read it
unchanged.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Iterator, Mapping, Tuple, Union

__all__ = ["Counters"]


class Counters:
    """A locked string->int counter map with atomic increments.

    Mutation goes through :meth:`inc` only — there is deliberately no
    ``__setitem__``, so the non-atomic ``c[k] += 1`` pattern raises
    ``TypeError`` at the store.
    """

    __slots__ = ("_lock", "_d")

    def __init__(self, initial: Union[Mapping[str, int], Iterable[Tuple[str, int]]] = ()):
        self._lock = threading.Lock()
        self._d: Dict[str, int] = dict(initial)

    def inc(self, key: str, n: int = 1) -> int:
        """Atomically add ``n`` to ``key`` (creating it at 0); returns the
        new value."""
        with self._lock:
            v = self._d.get(key, 0) + n
            self._d[key] = v
            return v

    # -- read-side dict protocol (snapshots, never live views) --------------

    def __getitem__(self, key: str) -> int:
        with self._lock:
            return self._d[key]

    def get(self, key: str, default: int = 0) -> int:
        with self._lock:
            return self._d.get(key, default)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._d

    def keys(self):
        with self._lock:
            return list(self._d.keys())

    def items(self):
        with self._lock:
            return list(self._d.items())

    def values(self):
        with self._lock:
            return list(self._d.values())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._d)

    def __repr__(self) -> str:
        return f"Counters({self.as_dict()!r})"
