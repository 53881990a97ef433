"""Throughput of a corpus job: graphs solved over the window."""


def read(rec):
    return rec["steps"] * rec["items_per_step"] / rec["window_s"] if rec["steps"] else None
