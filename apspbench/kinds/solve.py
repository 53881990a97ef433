"""Kind ``solve``: ``program.solve(h, **solve_kw)`` on one graph of the
configuration, again and again.

Each step keeps a few of its answer's rows, drawn from the seed for every
step; after the window they are judged against the reference's rows of the
same sources, and the last answer whole against the Bellman equations of
its graph (``reference.apsp``); with predecessors, each one must witness
its distance.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from apspbench import graphs, peaks, reference
from apspbench.kinds import PICK_TABLE, check


class SolveLoop:
    """One (V, V) graph of ``G = f(V, rho, alpha)``, solved each step."""

    def __init__(self, program, cfg: dict, traffic: dict, seed: int, device):
        self.program, self.device = program, device
        n = int(cfg["V"])
        self.h = graphs.paper_graph(graphs.torch_generator(seed, device), n,
                                    cfg["rho"], int(cfg["alpha"]))
        self.kw = dict(traffic.get("solve_kw", {}))
        self.with_pred = bool(self.kw.get("with_pred", False))
        rng = graphs.numpy_rng(seed, 1)
        pool = int(traffic["check_sources"])
        self.sources = torch.as_tensor(rng.choice(n, pool, replace=False), device=device)
        self.picks = torch.as_tensor(
            rng.integers(0, pool, (PICK_TABLE, int(traffic["check_rows_per_step"]))),
            device=device)
        self.kept: List = []
        self.last = None
        self.items_per_step = 1
        self.work_per_step = peaks.solve_work(n)

    def _solve(self):
        return self.program.solve(self.h, device=self.device, **self.kw)

    def warm(self) -> None:
        # two steps, the last answer held while the next is made, as in the
        # window: the allocator then holds both generations
        for _ in range(2):
            self.last = self._solve()

    def step(self, i: int) -> None:
        r = self._solve()
        slot = i % PICK_TABLE
        idx = self.sources[self.picks[slot]]
        self.kept.append((slot, r.dist.index_select(0, idx),
                          r.pred.index_select(0, idx) if self.with_pred else None))
        self.last = r

    def judge(self) -> Dict[str, Dict[str, float]]:
        h = self.h
        edges = reference.in_edges(h)
        ref = reference.sssp_rows(h, self.sources, edges)
        rows_off, pred_rows_off, failed = 0, 0, 0
        for slot, dist, pred in self.kept:
            at = self.picks[slot]
            off = int((dist.float() != ref[at]).sum())
            if pred is not None:
                p_off = reference.pred_off(ref[at], pred, h, self.sources[at])
                pred_rows_off += p_off
                off += p_off
            rows_off += off
            failed += off > 0
        checks = {"rows_off": check(rows_off, 0),
                  "last_bellman_off": check(
                      reference.bellman_off(self.last.dist, h, edges=edges), 0)}
        if self.with_pred:
            checks["pred_rows_off"] = check(pred_rows_off, 0)
            checks["last_pred_off"] = check(
                reference.pred_off(self.last.dist, self.last.pred, h), 0)
        self.failed = failed
        return checks


Loop = SolveLoop
