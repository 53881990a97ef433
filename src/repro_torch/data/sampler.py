"""A copy of ``repro.data.sampler`` (numpy only; the port imports nothing of the
JAX package), so the port's streams and subgraphs are bit-equal to the
reference's.

Fanout neighbour sampler for mini-batch GNN training (the minibatch_lg
cell: 232,965 nodes / 114.6M edges, batch_nodes=1024, fanout 15-10).

CSR graph on the host (numpy); per batch: seed nodes -> layer-wise uniform
neighbour sampling with the given fanouts -> one padded subgraph dict with
*static shapes* (max_nodes/max_edges derived from batch x fanouts), local
re-indexing, and masks.  This is the real GraphSAGE pipeline, not a stub —
the padded output feeds the same ``forward_gnn`` as the full-batch cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["CSRGraph", "NeighborSampler"]


@dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,) neighbour ids
    feat: np.ndarray      # (N, F)
    labels: np.ndarray    # (N,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @staticmethod
    def random(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int, seed=0):
        """Synthetic CSR graph with skewed degrees (hub-heavy)."""
        rng = np.random.default_rng(seed)
        deg = np.minimum(
            rng.zipf(1.6, n_nodes) + avg_degree // 2, avg_degree * 20
        ).astype(np.int64)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, n_nodes, indptr[-1]).astype(np.int32)
        return CSRGraph(
            indptr=indptr,
            indices=indices,
            feat=rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
            labels=rng.integers(0, n_classes, n_nodes).astype(np.int32),
        )


class NeighborSampler:
    """Layer-wise uniform fanout sampling with fixed output shapes."""

    def __init__(self, graph: CSRGraph, fanouts: Sequence[int], batch_nodes: int):
        self.g = graph
        self.fanouts = list(fanouts)
        self.batch_nodes = batch_nodes
        # static budget: seeds + seeds*f1 + seeds*f1*f2 + ...
        n = batch_nodes
        self.max_nodes = batch_nodes
        self.max_edges = 0
        for f in self.fanouts:
            e = n * f
            self.max_edges += e
            self.max_nodes += e          # every sampled edge may add a node
            n = e

    def sample(self, seeds: np.ndarray, seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        g = self.g
        nodes: List[int] = list(seeds)
        local = {int(v): i for i, v in enumerate(seeds)}
        src_l: List[int] = []
        dst_l: List[int] = []

        frontier = list(seeds)
        for f in self.fanouts:
            nxt: List[int] = []
            for v in frontier:
                lo, hi = g.indptr[v], g.indptr[v + 1]
                if hi <= lo:
                    continue
                nbrs = g.indices[lo:hi]
                take = nbrs if hi - lo <= f else rng.choice(nbrs, f, replace=False)
                for u in take:
                    u = int(u)
                    if u not in local:
                        local[u] = len(nodes)
                        nodes.append(u)
                        nxt.append(u)
                    # message flows neighbour -> center
                    src_l.append(local[u])
                    dst_l.append(local[v])
            frontier = nxt

        n, e = len(nodes), len(src_l)
        assert n <= self.max_nodes and e <= self.max_edges, (n, e)
        node_ids = np.full(self.max_nodes, nodes[-1] if nodes else 0, np.int64)
        node_ids[:n] = nodes
        src = np.zeros(self.max_edges, np.int32)
        dst = np.zeros(self.max_edges, np.int32)
        src[:e] = src_l
        dst[:e] = dst_l
        node_mask = np.zeros(self.max_nodes, bool)
        node_mask[:n] = True
        edge_mask = np.zeros(self.max_edges, bool)
        edge_mask[:e] = True
        label_mask = np.zeros(self.max_nodes, bool)
        label_mask[: len(seeds)] = True                # loss on seeds only
        return {
            "node_feat": g.feat[node_ids],
            "edge_index": np.stack([src, dst]),
            "edge_mask": edge_mask,
            "node_mask": node_mask,
            "labels": g.labels[node_ids],
            "label_mask": label_mask,
        }

    def batches(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        step = 0
        while True:
            seeds = rng.choice(self.g.n_nodes, self.batch_nodes, replace=False)
            yield self.sample(seeds, seed=(seed + step) % (2**31))
            step += 1
