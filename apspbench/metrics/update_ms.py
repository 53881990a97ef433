"""Time to keep the answer current: the window over the update batches
completed in it."""


def read(rec):
    return 1e3 * rec["window_s"] / rec["steps"] if rec["steps"] else None
