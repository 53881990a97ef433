"""Device ms a step in host-to-device copies over the traced steps: the
engine's upload of its cost matrix ``h`` (kept on the host) at every
re-close, beside the few update edges."""


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["device"]:
        return None
    ns = sum(d for name, _, d in tr["device"] if "HtoD" in name)
    return ns / 1e6 / tr["steps"]
