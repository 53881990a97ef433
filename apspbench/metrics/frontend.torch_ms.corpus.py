"""Device ms a corpus in operations outside the program's kernels (the
front end's copies, fills and reductions: every device operation whose
name is not in the ``repro_torch::`` namespace) over the traced steps."""


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["device"]:
        return None
    ns = sum(d for name, _, d in tr["device"] if "repro_torch::" not in name)
    return ns / 1e6 / tr["steps"]
