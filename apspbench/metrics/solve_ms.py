"""Time to an all-pairs answer: the window over the solves completed in it."""


def read(rec):
    return 1e3 * rec["window_s"] / rec["steps"] if rec["steps"] else None
