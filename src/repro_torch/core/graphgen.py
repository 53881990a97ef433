"""The paper's random graph generator ``G = f(V, rho, alpha)`` (paper §3.4),
ported from ``repro.core.graphgen``.

Procedure: sample a probability matrix P ~ U[0,1]^{V×V}; scale by the
density knob rho (a percentage); Bernoulli-threshold into an adjacency
matrix A; assign integer edge costs uniform in [1, alpha]; zero the
diagonal.  Non-edges get +inf in the cost matrix H the solvers take.

Two backends:

* :func:`generate_np` is a copy of the JAX package's numpy generator: the
  same ``np.random.Generator`` seed gives the same graph bit for bit in both
  packages, which is how the tests and ``chip_smoke.py`` feed them one input.
* :func:`generate` draws from a ``torch.Generator`` on any device, and
  :func:`generate_batch` builds a ragged corpus from it as one padded
  (G, N, N) stack.  Their seed contract is their own: they never reproduce
  the JAX generator's graphs.

:func:`generate_edge_updates` is a copy of the JAX package's numpy update
stream, so one seed gives both dynamic engines the same updates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "GraphSample",
    "generate",
    "generate_batch",
    "generate_np",
    "generate_edge_updates",
    "paper_corpus",
    "graph_stats",
]

INF = np.inf


@dataclass
class GraphSample:
    """One generated graph: dense cost matrix + bookkeeping for Fig 9."""

    h: np.ndarray          # (V, V) float32 cost matrix, inf = no edge, diag 0
    adjacency: np.ndarray  # (V, V) bool
    n_nodes: int
    n_edges: int
    rho: float
    alpha: int

    @property
    def density(self) -> float:
        v = self.n_nodes
        max_edges = max(v * (v - 1), 1)
        return self.n_edges / max_edges


def generate(
    generator: torch.Generator,
    n_nodes: int,
    *,
    rho: Optional[float] = None,
    alpha: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch backend: returns (H, adjacency) on ``generator.device``.
    ``rho=None`` samples rho ~ U[0, 100]."""
    dev = generator.device
    if rho is None:
        rho = float(torch.rand((), generator=generator, device=dev)) * 100.0
    p = torch.rand((n_nodes, n_nodes), generator=generator, device=dev)
    p_edge = torch.clamp(rho / 100.0 * p, 0.0, 1.0)
    adj = torch.rand((n_nodes, n_nodes), generator=generator, device=dev) < p_edge
    cost = torch.randint(
        1, alpha + 1, (n_nodes, n_nodes), generator=generator, device=dev
    ).to(torch.float32)
    adj.fill_diagonal_(False)
    h = torch.where(adj, cost, torch.full_like(cost, float("inf")))
    h.fill_diagonal_(0.0)
    return h, adj


def generate_batch(
    generator: torch.Generator,
    sizes,
    *,
    n_max: Optional[int] = None,
    rho: Optional[float] = None,
    alpha: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torch backend, batched: a ragged corpus as one (G, N, N) stack on
    ``generator.device``.

    ``sizes`` lists each graph's true node count; graphs are drawn one
    after another from ``generator`` at ``n_max`` (default: max(sizes)) by
    :func:`generate` and masked down, so the stack feeds
    ``apsp.solve_batch`` directly: entries outside a graph's (size, size)
    block are inf off-diagonal / 0 diagonal phantom nodes.  ``rho=None``
    samples an independent rho ~ U[0, 100] per graph (the paper's corpus
    recipe).  Returns (H, adjacency, sizes), sizes int32.
    """
    dev = generator.device
    sizes = torch.as_tensor(sizes, dtype=torch.int32).to(dev)
    n = int(n_max) if n_max is not None else int(sizes.max())
    drawn = [generate(generator, n, rho=rho, alpha=alpha) for _ in range(sizes.shape[0])]
    h = torch.stack([d[0] for d in drawn])
    adj = torch.stack([d[1] for d in drawn])
    node = torch.arange(n, device=dev)
    live = node[None, :, None] < sizes[:, None, None]
    valid = live & (node[None, None, :] < sizes[:, None, None])
    eye = torch.eye(n, dtype=torch.bool, device=dev)[None]
    phantom = torch.where(eye, 0.0, float("inf")).to(h.dtype)
    h = torch.where(valid & ~eye, h, phantom)
    return h, adj & valid, sizes


def generate_np(
    rng: np.random.Generator,
    n_nodes: int,
    *,
    rho: Optional[float] = None,
    alpha: int = 100,
) -> GraphSample:
    """numpy backend, identical to ``repro.core.graphgen.generate_np``."""
    if rho is None:
        rho = float(rng.uniform(0.0, 100.0))
    p = rng.uniform(size=(n_nodes, n_nodes))
    p_edge = np.clip(rho / 100.0 * p, 0.0, 1.0)
    adj = rng.uniform(size=(n_nodes, n_nodes)) < p_edge
    np.fill_diagonal(adj, False)
    cost = rng.integers(1, alpha + 1, size=(n_nodes, n_nodes)).astype(np.float32)
    h = np.where(adj, cost, np.float32(INF)).astype(np.float32)
    np.fill_diagonal(h, 0.0)
    return GraphSample(
        h=h,
        adjacency=adj,
        n_nodes=n_nodes,
        n_edges=int(adj.sum()),
        rho=rho,
        alpha=alpha,
    )


def generate_edge_updates(
    rng: np.random.Generator,
    h: np.ndarray,
    k: int,
    *,
    worsen_frac: float = 0.0,
    alpha: int = 100,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k random tropical edge updates ``(u, v, w)`` against cost matrix h,
    identical to ``repro.core.graphgen.generate_edge_updates``.

    By default every update is guaranteed not-worsening — lower an existing
    edge (integer-valued, floor 1) or insert a new one with cost in
    [1, alpha) — the load shape the dynamic engine's exact rank-k path
    covers.  ``worsen_frac`` > 0 additionally worsens that fraction of the
    batch (cost + [100, 300)), exercising the bounded re-solve paths.
    Never emits self-loops.
    """
    n = h.shape[0]
    u = rng.integers(0, n, k).astype(np.int32)
    v = ((u + rng.integers(1, n, k)) % n).astype(np.int32)
    old = h[u, v]
    w = np.where(
        np.isfinite(old),
        np.maximum(1.0, np.floor(old) - rng.integers(1, 20, k)),
        rng.integers(1, alpha, k),
    ).astype(np.float32)
    if worsen_frac > 0.0:
        worsen = rng.uniform(size=k) < worsen_frac
        w = np.where(
            worsen,
            np.where(np.isfinite(old), old, 1.0)
            + rng.integers(100, 300, k).astype(np.float32),
            w,
        ).astype(np.float32)
    return u, v, w


def paper_corpus(
    seed: int = 0,
    n_graphs: int = 1000,
    v_min: int = 4,
    v_max: int = 1000,
    alpha: int = 100,
):
    """The paper's benchmark corpus: ``n_graphs`` graphs, V ~ U[v_min, v_max],
    rho ~ U[0,100], alpha=100 — sorted by edge count (paper §4)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(v_min, v_max + 1, size=n_graphs)
    graphs = [generate_np(rng, int(v), alpha=alpha) for v in sizes]
    graphs.sort(key=lambda g: g.n_edges)
    return graphs


def graph_stats(graphs) -> dict:
    """Fig 9 statistics: sqrt(edges), nodes, densities."""
    return {
        "n_nodes": np.array([g.n_nodes for g in graphs]),
        "sqrt_edges": np.sqrt(np.array([g.n_edges for g in graphs], dtype=np.float64)),
        "density": np.array([g.density for g in graphs]),
    }
