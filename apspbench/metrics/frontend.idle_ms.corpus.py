"""Device-idle ms a corpus in the front end, by the program's spans: the
idle stretches of the traced steps (``trace.gaps``) whose midpoint lies in
a ``repro_torch.*`` span and in no ``repro_torch.dispatch`` span (the NaN
check, the bucketing, the pads, the scatters, the cycle check).  None
when the record holds no program span."""

from apspbench import trace

PREFIX, DISPATCH = "repro_torch.", "repro_torch.dispatch"


def split(tr):
    """Idle ns by where the host was at each gap's midpoint: ``front`` (in
    a program span, in no dispatch span), ``rounds`` (in a dispatch span),
    ``outside`` (in no program span).  The innermost-event rule of
    ``trace.idle_by_host``, restricted to program spans."""
    spans = sorted((e for e in tr["host"] if e[0].startswith(PREFIX)),
                   key=lambda e: (e[1], -e[2]))
    if not spans:
        return None
    out = {"front": 0, "rounds": 0, "outside": 0}
    stack, nxt = [], 0
    for a, b in sorted(trace.gaps(tr), key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while nxt < len(spans) and spans[nxt][1] <= mid:
            stack.append(spans[nxt])
            nxt += 1
        stack = [e for e in stack if e[1] + e[2] > mid]
        if not stack:
            out["outside"] += b - a
        elif any(e[0] == DISPATCH for e in stack):
            out["rounds"] += b - a
        else:
            out["front"] += b - a
    return out


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["device"]:
        return None
    ns = split(tr)
    return None if ns is None else ns["front"] / 1e6 / tr["steps"]
