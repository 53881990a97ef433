"""The one traffic generator: closed loops over the program's entry points.

A traffic file (``traffic/<mix>.json``) names its ``kind`` and its
parameters; the kind is one of the classes below, which build the cell's
inputs from the configuration and the seed, run one step of the loop, and
after the window judge what the steps produced against the plain
reference.  One client waits for each answer before it sends the next.

* ``solve``: ``program.solve(h, **solve_kw)`` on one graph of the
  configuration, again and again.
* ``corpus``: ``program.solve_batch(stack, sizes, **solve_kw)`` on the
  configuration's corpus.

What each step's answer is judged by: a few of its rows, drawn from the
seed for every step, against the reference's rows of the same sources,
and the last answer whole against the Bellman equations of its graph
(``reference.apsp``); with predecessors, each one must witness its
distance.  Every comparison is exact: the costs are integers, and every
distance is a float32 integer.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import graphs, peaks, reference

# rows of the sample table: step i keeps the rows of picks[i % PICK_TABLE]
PICK_TABLE = 4096


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check(value, limit) -> Dict[str, float]:
    return {"value": value, "limit": limit}


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
        for _ in range(2):       # as SolveLoop.warm
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


KINDS = {"solve": SolveLoop, "corpus": CorpusLoop}
