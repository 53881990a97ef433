"""Fixpoint passes a step, by the engine's own counters: the row re-close's
passes (``DynamicAPSP.stats["row_iters"]``), the warm re-solve's squarings
(``warm_iters``) and the rank-k passes (``rank_k_passes``) over the window."""


def read(rec):
    c = rec["counters"]
    if "engine.row_iters" not in c or not rec["steps"]:
        return None
    return (c["engine.row_iters"] + c["engine.warm_iters"] + c["engine.rank_k_passes"]) \
        / rec["steps"]
