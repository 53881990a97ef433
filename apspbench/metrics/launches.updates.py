"""Kernel launches a step, by the program's own counters (``fw_round``'s
rounds and the ``minplus``, ``fw_block`` and ``row_close`` launches; not
the loop's ``engine.*``, ``path.*`` and ``affected_rows.*`` counts)."""


def read(rec):
    n = sum(v for k, v in rec["counters"].items() if "." not in k)
    return n / rec["steps"] if n and rec["steps"] else None
