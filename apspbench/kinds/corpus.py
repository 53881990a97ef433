"""Kind ``corpus``: ``program.solve_batch(stack, sizes, **solve_kw)`` on
the configuration's corpus, again and again.

Each step keeps a few (graph, source) rows of its answer, drawn from the
seed for every step; after the window they are judged against the
reference's rows, and the last answer's every graph against its Bellman
equations; with predecessors, each one must witness its distance.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from apspbench import graphs, peaks, reference
from apspbench.kinds import PICK_TABLE, check


class CorpusLoop:
    """The configuration's corpus as one padded stack, solved each step."""

    def __init__(self, program, cfg: dict, traffic: dict, seed: int, device):
        self.program, self.device = program, device
        self.stack, self.sizes = graphs.corpus(
            graphs.torch_generator(seed, device), int(cfg["n_graphs"]), int(cfg["v_min"]),
            int(cfg["v_max"]), float(cfg["rho_max"]), int(cfg["alpha"]))
        self.kw = dict(traffic.get("solve_kw", {}))
        self.with_pred = bool(self.kw.get("with_pred", False))
        rng = graphs.numpy_rng(seed, 1)
        g = len(self.sizes)
        pool = min(int(traffic["check_sources"]), g)
        # the pool of (graph, source) rows, the largest graph among them
        chosen = rng.choice(g, pool, replace=False)
        if int(np.argmax(self.sizes)) not in chosen:
            chosen[0] = int(np.argmax(self.sizes))
        self.pool_g = chosen.astype(np.int64)
        self.pool_s = np.array([rng.integers(0, self.sizes[x]) for x in chosen], np.int64)
        self.g_dev = torch.as_tensor(self.pool_g, device=device)
        self.s_dev = torch.as_tensor(self.pool_s, device=device)
        self.picks = rng.integers(0, pool, (PICK_TABLE, int(traffic["check_rows_per_step"])))
        self.picks_dev = torch.as_tensor(self.picks, device=device)
        self.kept: List = []
        self.last = None
        self.items_per_step = g
        self.work_per_step = peaks.corpus_work(self.sizes)

    def _solve(self):
        return self.program.solve_batch(self.stack, self.sizes, device=self.device, **self.kw)

    def warm(self) -> None:
        for _ in range(2):       # as kinds/solve.py's warm
            self.last = self._solve()

    def step(self, i: int) -> None:
        r = self._solve()
        slot = i % PICK_TABLE
        at = self.picks_dev[slot]
        g, s = self.g_dev[at], self.s_dev[at]
        self.kept.append((slot, r.dist[g, s], r.pred[g, s] if self.with_pred else None))
        self.last = r

    def judge(self) -> Dict[str, Dict[str, float]]:
        refs = []
        for g, s in zip(self.pool_g, self.pool_s):
            k = int(self.sizes[g])
            h = self.stack[g, :k, :k]
            refs.append(reference.sssp_rows(h, torch.tensor([s]))[0])
        rows_off, pred_rows_off, failed = 0, 0, 0
        for slot, dist, pred in self.kept:
            off = 0
            for q, e in enumerate(self.picks[slot]):
                g, s = int(self.pool_g[e]), int(self.pool_s[e])
                k = int(self.sizes[g])
                off += int((dist[q, :k].float() != refs[e]).sum())
                if pred is not None:
                    p_off = reference.pred_off(refs[e][None], pred[q, :k][None],
                                               self.stack[g, :k, :k], torch.tensor([s]))
                    pred_rows_off += p_off
                    off += p_off
            rows_off += off
            failed += off > 0
        bell, pred_off = 0, 0
        for g, k in enumerate(self.sizes):
            k = int(k)
            h = self.stack[g, :k, :k]
            d = self.last.dist[g, :k, :k]
            bell += reference.bellman_off(d, h)
            if self.with_pred:
                pred_off += reference.pred_off(d, self.last.pred[g, :k, :k], h)
        checks = {"rows_off": check(rows_off, 0), "last_bellman_off": check(bell, 0)}
        if self.with_pred:
            checks["pred_rows_off"] = check(pred_rows_off, 0)
            checks["last_pred_off"] = check(pred_off, 0)
        self.failed = failed
        return checks


Loop = CorpusLoop
