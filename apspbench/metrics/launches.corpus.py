"""Kernel launches a step, by the program's own counters (``fw_round``'s
rounds and the ``minplus``, ``fw_block`` and ``row_close`` launches)."""


def read(rec):
    n = sum(rec["counters"].values())
    return n / rec["steps"] if n and rec["steps"] else None
