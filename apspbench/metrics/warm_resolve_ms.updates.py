"""Host ms a step of the steps whose raise went past ``row_threshold`` and
the engine re-solved warm (path ``warm_resolve+rank_k``), each timed to its
synchronise."""


def read(rec):
    c = rec["counters"]
    n = c.get("path.warm_resolve+rank_k", 0)
    return c["path_ms.warm_resolve+rank_k"] / n if n else None
