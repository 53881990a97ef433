"""Kind ``updates``: ``program.DynamicAPSP(h, **engine_kw)`` kept current
under a steady stream of single-edge raises and put-backs, one batch a
step.

The stream: existing edges drawn uniformly, their weights raised and put
back.  An edge's affected share is the share of sources i that reach v
with ``d[i, u] + h[u, v] = d[i, v]``, the sources whose shortest paths a
raise of (u, v) can lengthen; it sets the engine's work and its path (a
row re-close, or past ``row_threshold`` a warm re-solve).  Drawn uniformly
it ranges from no source to nearly all, so set-up makes every seed's
stream the same draw by its quantiles: ``sample`` edges drawn uniformly
from the seed, sorted by affected share and cut into ``strata`` equal
strata, and the ``edges_per_stratum`` edges at each stratum's midpoint (a
stratified sample of the uniform draw).  The shares come from the plain
reference's distances into each edge's two endpoints (Bellman-Ford on the
reversed graph), so the stream follows from the seed alone and not from
the program; that time is the reference's and is kept apart from set-up
(``reference_s``).  Each edge's raise is an integer in ``raise``, drawn
after.

A cycle takes one edge of every stratum in order of share, the next cycle
the next edge of each.  Step c raises edge ``(c - 1) % k`` of that order
(k = strata * edges_per_stratum) and puts back the edge step c - 1 raised
at its original cost: one batch of 1 + 1 updates, ``eng.update(u, v, w)``,
timed to its synchronise.  Set-up runs steps 0 (a top-stratum raise alone,
the heaviest path) and 1 (a lowest-stratum raise); the window runs whole
cycles (``cycle_steps``), so every window walks every stratum equally
often.  After step c the graph is the configuration's with one edge
raised, so there are k states.

Judgement: each step keeps ``check_rows_per_step`` rows of the engine's
``dist`` (and ``pred``) from a pool of ``check_sources`` seeded sources,
and ``check_affected_per_step`` rows drawn from the sources its raise
affects (the reference's own tight set of that edge), and which edge its
state raised.  After the window they are judged against the reference's
rows of that state's graph, and the last state whole against its graph's
Bellman equations; with predecessors, each one must witness its distance.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from apspbench import graphs, reference
from apspbench.kinds import PICK_TABLE, check, sync

# candidate edges judged at once in set-up: 2 reversed Bellman-Ford sources each
CHUNK = 256
# the engine's counters (``DynamicAPSP.stats``) kept, as their window's delta
STATS = ("rank_k", "row_resolve", "warm_resolve", "full_resolve", "noop",
         "rank_k_passes", "row_iters", "warm_iters")


def tight_sources(h: torch.Tensor, u: torch.Tensor, v: torch.Tensor, edges_rev) -> torch.Tensor:
    """(k, n) bool: per edge (u, v), the sources i that reach v and whose
    distance ``d[i, v]`` equals ``d[i, u] + h[u, v]``, by the reference's
    distances into u and v (rows of the reversed graph's answer)."""
    k = u.numel()
    into = reference.sssp_rows(h.T, torch.cat([u, v]), edges_rev)       # (2k, n)
    du, dv = into[:k], into[k:]
    return torch.isfinite(dv) & (du + h[u, v][:, None] == dv)


def draw_table(h: torch.Tensor, rng: np.random.Generator, sample: int, strata: int,
               per_stratum: int):
    """The stratified table: ``sample`` distinct existing edges drawn
    uniformly from ``rng``, sorted by affected share, cut into ``strata``
    equal strata, and the ``per_stratum`` edges at each stratum's midpoint.
    Returns u, v (int64), their shares and their tight sets ((k, n) bool,
    on the host), k = strata * per_stratum, in the order the steps take
    them: set j (the j-th edge of every stratum) after set j - 1, each set
    in order of share."""
    n = h.shape[-1]
    edge = torch.isfinite(h)
    edge.fill_diagonal_(False)
    uv = torch.nonzero(edge).cpu().numpy()
    del edge
    m = min(sample, len(uv))
    if m < strata * per_stratum:
        raise RuntimeError(f"the graph has {len(uv)} edges (V = {n}); the table needs "
                           f"{strata * per_stratum}")
    at = rng.choice(len(uv), m, replace=False)
    edges_rev = reference.in_edges(h.T)
    share = np.empty(m)
    for c0 in range(0, m, CHUNK):
        u = torch.as_tensor(uv[at[c0:c0 + CHUNK], 0], device=h.device)
        v = torch.as_tensor(uv[at[c0:c0 + CHUNK], 1], device=h.device)
        share[c0:c0 + CHUNK] = tight_sources(h, u, v, edges_rev).sum(dim=1).cpu().numpy() / n
    order = np.argsort(share, kind="stable")
    mid = ((np.arange(strata) + 0.5) * m / strata).astype(np.int64)
    offset = np.arange(per_stratum) - (per_stratum - 1) // 2
    pick = order[(offset[:, None] + mid[None, :]).ravel()]
    u, v = uv[at[pick], 0], uv[at[pick], 1]
    tight = tight_sources(h, torch.as_tensor(u, device=h.device),
                          torch.as_tensor(v, device=h.device), edges_rev).cpu()
    return u, v, share[pick], tight


class UpdatesLoop:
    """One engine over a (V, V) graph of ``G = f(V, rho, alpha)``, one
    raise and one put-back a step."""

    def __init__(self, program, cfg: dict, traffic: dict, seed: int, device):
        self.device = device
        n = int(cfg["V"])
        h = graphs.paper_graph(graphs.torch_generator(seed, device), n, cfg["rho"],
                               int(cfg["alpha"]))
        kw = dict(traffic.get("engine_kw", {}))
        self.with_pred = bool(kw.get("with_pred", False))
        self.eng = program.DynamicAPSP(h, device=device, **kw)
        strata = int(traffic["strata"])
        rows = strata * int(traffic["edges_per_stratum"])
        rng = graphs.numpy_rng(seed, 2)
        t = time.perf_counter()
        self.tu, self.tv, self.share, tight = draw_table(
            h, rng, int(traffic["sample"]), strata, int(traffic["edges_per_stratum"]))
        self.reference_s = time.perf_counter() - t
        lo, hi = traffic["raise"]
        self.base_w = h[torch.as_tensor(self.tu, device=device),
                        torch.as_tensor(self.tv, device=device)].cpu().numpy()
        self.raised_w = self.base_w + rng.integers(lo, hi, rows).astype(np.float32)
        # the reference's copy of the graph waits on the host
        self.h = h.cpu()
        del h
        rng = graphs.numpy_rng(seed, 1)
        pool = int(traffic["check_sources"])
        self.sources = rng.choice(n, pool, replace=False)
        self.picks = rng.integers(0, pool, (PICK_TABLE, int(traffic["check_rows_per_step"])))
        # per edge, the sources its raise affects, in an order drawn from the seed
        self.affected_order = [rng.permutation(np.flatnonzero(t.numpy())) for t in tight]
        self.per_affected = int(traffic["check_affected_per_step"])
        self.rows = rows
        self.cycle_steps = strata
        self.kept: List = []
        self.paths: Counter = Counter()
        self.path_ms: Counter = Counter()
        self.affected: List[int] = []
        self.cycle = 0
        self.last_row = None
        self.items_per_step = 1
        self.work_per_step = None

    def _batch(self) -> dict:
        """Step ``self.cycle``: raise its edge, put back the previous
        step's."""
        row = (self.cycle - 1) % self.rows
        u, v, w = [self.tu[row]], [self.tv[row]], [self.raised_w[row]]
        if self.cycle > 0:
            prev = (self.cycle - 2) % self.rows
            u.append(self.tu[prev])
            v.append(self.tv[prev])
            w.append(self.base_w[prev])
        info = self.eng.update(np.array(u), np.array(v), np.array(w, dtype=np.float32))
        self.cycle += 1
        self.last_row = row
        return info

    def warm(self) -> None:
        for _ in range(2):
            self._batch()
        self.stats0 = dict(self.eng.stats)

    def _check_sources(self, i: int) -> np.ndarray:
        """Step i's kept rows: from the pool, and from the sources that its
        raise affects."""
        src = [self.sources[self.picks[i % PICK_TABLE]]]
        hit = self.affected_order[self.last_row]
        if hit.size:
            seen = i // self.rows
            at = (seen * self.per_affected + np.arange(self.per_affected)) % hit.size
            src.append(hit[at])
        return np.concatenate(src)

    def step(self, i: int) -> None:
        t = time.perf_counter()
        info = self._batch()
        sync(self.device)
        self.path_ms[info["path"]] += (time.perf_counter() - t) * 1e3
        self.paths[info["path"]] += 1
        self.affected.append(int(info.get("affected_rows", 0)))
        src = self._check_sources(i)
        idx = torch.as_tensor(src, device=self.device)
        pred = self.eng.pred
        self.kept.append((self.last_row, src, self.eng.dist.index_select(0, idx),
                          pred.index_select(0, idx) if self.with_pred else None))

    def counters(self) -> Dict[str, float]:
        """The window's engine counters (``engine.*``), steps by path
        (``path.*``) and their host ms (``path_ms.*``), and affected rows
        (``affected_rows.*``)."""
        out = {f"engine.{k}": self.eng.stats[k] - self.stats0[k] for k in STATS}
        out.update({f"path.{p}": c for p, c in sorted(self.paths.items())})
        out.update({f"path_ms.{p}": ms for p, ms in sorted(self.path_ms.items())})
        if self.affected:
            out.update({"affected_rows.min": min(self.affected),
                        "affected_rows.max": max(self.affected),
                        "affected_rows.sum": sum(self.affected)})
        return out

    def _graph(self, h: torch.Tensor, row: int, raised: bool) -> None:
        """Write edge ``row`` into ``h`` raised, or back at base."""
        h[int(self.tu[row]), int(self.tv[row])] = float(
            self.raised_w[row] if raised else self.base_w[row])

    def judge(self) -> Dict[str, Dict[str, float]]:
        last_dist, last_pred = self.eng.dist, self.eng.pred
        self.eng = None                        # the program's state: only the last answer stays
        h = self.h.to(self.device)
        self.h = None
        by_state: Dict[int, List] = {}
        for entry in self.kept:
            by_state.setdefault(entry[0], []).append(entry)
        rows_off, pred_rows_off, failed = 0, 0, 0
        for row, entries in sorted(by_state.items()):
            self._graph(h, row, True)
            used = np.unique(np.concatenate([src for _, src, _, _ in entries]))
            ref = reference.sssp_rows(h, torch.as_tensor(used, device=h.device))
            for _, src, dist, pred in entries:
                want = ref[torch.as_tensor(np.searchsorted(used, src), device=ref.device)]
                off = int((dist.float() != want).sum())
                if pred is not None:
                    p_off = reference.pred_off(want, pred, h,
                                               torch.as_tensor(src, device=h.device))
                    pred_rows_off += p_off
                    off += p_off
                rows_off += off
                failed += off > 0
            self._graph(h, row, False)
        self._graph(h, self.last_row, True)
        checks = {"rows_off": check(rows_off, 0),
                  "last_bellman_off": check(reference.bellman_off(last_dist, h), 0)}
        if self.with_pred:
            checks["pred_rows_off"] = check(pred_rows_off, 0)
            checks["last_pred_off"] = check(reference.pred_off(last_dist, last_pred, h), 0)
        self.failed = failed
        return checks


Loop = UpdatesLoop
