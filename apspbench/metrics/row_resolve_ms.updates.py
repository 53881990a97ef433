"""Host ms a step of the steps whose raise the engine re-closed by rows
(path ``row_resolve+rank_k``), each timed to its synchronise: the window's
time without the warm re-solves, whose squarings vary by edge."""


def read(rec):
    c = rec["counters"]
    n = c.get("path.row_resolve+rank_k", 0)
    return c["path_ms.row_resolve+rank_k"] / n if n else None
