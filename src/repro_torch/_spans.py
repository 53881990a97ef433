"""Named spans of the program's phases, on ``torch.profiler``'s own timeline.

``with span("repro_torch.<phase>"):`` marks one phase of a call.  With no
profiler running, ``span`` returns one shared no-op context: the cost is
one flag check.  Under a running profiler it opens a ``RecordFunction``
range, which the profiler keeps in memory beside its device records and
writes out on their clock when it stops, so each stretch in which the
device sat idle can be put down to the phase the host was in.  A span's
parent is the innermost span around it on the calling thread, and the
request it serves is the caller's enclosing range.

Spans sit once a phase (one a call, or one a bucket), never once a graph
or a row: a loop's body runs inside its phase's span.
"""

from __future__ import annotations

import contextlib

import torch

_NOOP = contextlib.nullcontext()
# is a profiler collecting on this thread
_on = torch._C._autograd._profiler_enabled
# the profiler's cheapest range: a C context manager, no dispatcher op
_range = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that records ``name`` as a range while a profiler runs,
    and the shared no-op otherwise."""
    if not _on():
        return _NOOP
    return _range(name)
