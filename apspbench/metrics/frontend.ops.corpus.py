"""PyTorch operators the front end dispatches a corpus, by the program's
spans: the outermost ``aten::`` host events (inside no other ``aten::``
event) that start inside a ``repro_torch.*`` span and outside every
``repro_torch.dispatch`` span, over the traced steps: the work of the
front end's per-graph loops.  None when the record holds no program
span."""

PREFIX, DISPATCH = "repro_torch.", "repro_torch.dispatch"


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    host = sorted(tr["host"], key=lambda e: (e[1], -e[2]))
    if not any(e[0].startswith(PREFIX) for e in host):
        return None
    n, stack = 0, []
    for e in host:
        stack = [x for x in stack if x[1] + x[2] > e[1]]
        if e[0].startswith("aten::"):
            names = [x[0] for x in stack]
            if (not any(x.startswith("aten::") for x in names)
                    and any(x.startswith(PREFIX) for x in names) and DISPATCH not in names):
                n += 1
        stack.append(e)
    return n / tr["steps"]
