"""The traced run's record, and the arithmetic every reader shares.

A traced run profiles the first steps of its window with
``torch.profiler`` (CPU and CUDA activity).  The profiler can lose the
first records of a trace, so the first ``lead`` steps only open it; the
traced stretch runs from the start of the next step to the end of the last
traced one.  :func:`capture` keeps, relative to the stretch's start (ns):

* ``device``: every device operation (kernel, copy, fill) that overlaps
  it, ``[name, start, duration]``, clipped to it;
* ``host``: every host event of the stepping thread that overlaps it
  (operators, runtime calls, the harness's spans);
* ``t1``: its length, and ``steps``: the steps in it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

STEP_SPAN = "apspbench.step"
# a breakdown's operation names are cut to this many characters
NAME_CHARS = 160


def capture(prof, lead: int) -> Optional[dict]:
    """The record of a finished profile whose steps ran under
    ``record_function(STEP_SPAN)``; None if it holds no step."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
                   for e in evs
                   if e.device_type() == DeviceType.CPU and e.name() == STEP_SPAN)
    if not spans:
        return None
    use = spans[lead:] or spans
    t0, t1, tid = use[0][0], use[-1][1], use[0][2]

    def inside(e):
        s = e.start_ns()
        return s < t1 and s + e.duration_ns() > t0

    device, host = [], []
    for e in evs:
        if not inside(e):
            continue
        s = e.start_ns() - t0
        if e.device_type() == DeviceType.CUDA:
            if e.name() == STEP_SPAN or e.is_user_annotation():
                continue     # the span's mirror on the device timeline, no operation
            a, b = max(s, 0), min(s + e.duration_ns(), t1 - t0)
            device.append([e.name(), a, b - a])
        elif e.device_type() == DeviceType.CPU and e.start_thread_id() == tid:
            host.append([e.name(), s, e.duration_ns()])
    return {"t1": t1 - t0, "steps": len(use), "device": device, "host": host}


def _union(tr: dict) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for _, s, d in sorted(tr["device"], key=lambda e: e[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [(a, b) for a, b in out]


def busy_s(tr: dict) -> float:
    """Seconds of the stretch in which some device operation ran."""
    return sum(b - a for a, b in _union(tr)) / 1e9


def window_s(tr: dict) -> float:
    return tr["t1"] / 1e9


def idle_share(tr: dict) -> Optional[float]:
    """Percent of the stretch in which no device operation ran."""
    if not tr["device"] or tr["t1"] <= 0:
        return None
    return 100.0 * (1.0 - busy_s(tr) / window_s(tr))


def device_ops(tr: dict) -> Dict[str, float]:
    """Seconds by device operation name."""
    out: Dict[str, float] = defaultdict(float)
    for name, _, d in tr["device"]:
        out[name] += d / 1e9
    return dict(out)


def gaps(tr: dict) -> List[Tuple[int, int]]:
    """The idle stretches between device operations, [start, end) in ns."""
    out, at = [], 0
    for a, b in _union(tr):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if tr["t1"] > at:
        out.append((at, tr["t1"]))
    return out


def idle_by_host(tr: dict) -> Dict[str, float]:
    """Idle seconds by what the host was doing in the middle of each gap:
    the innermost host event there (operator, runtime call or span)."""
    host = sorted(tr["host"], key=lambda e: (e[1], -e[2]))
    out: Dict[str, float] = defaultdict(float)
    stack: List[list] = []
    nxt = 0
    for a, b in sorted(gaps(tr), key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while nxt < len(host) and host[nxt][1] <= mid:
            stack.append(host[nxt])
            nxt += 1
        inner = [e for e in stack if e[1] + e[2] > mid]
        stack = inner
        label = inner[-1][0] if inner else "outside any recorded host event"
        out[label] += (b - a) / 1e9
    return dict(out)


def breakdown(tr: dict) -> dict:
    """The ten device operations that took most time and the ten host
    activities under which the device sat idle longest, in seconds."""
    ops = sorted(device_ops(tr).items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by_host(tr).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in idle]}
