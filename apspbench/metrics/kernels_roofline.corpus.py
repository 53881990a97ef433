"""The kernels' share of their roofline: the problem's own (min, +)
candidates in the traced steps over the card's peak times the device time
of every operation in them (``peaks``), in percent."""

from apspbench import trace


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr["device"] or not rec["work_per_step"]:
        return None
    work = rec["work_per_step"] * tr["steps"]
    return 100.0 * work / (rec["peak_candidates_per_s"] * trace.busy_s(tr))
