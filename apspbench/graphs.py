"""The inputs of every cell, made from ``--seed`` alone.

Frozen: a later change adds a configuration or a traffic mix as data, or
a traffic kind as a new file (``kinds/``), and never edits these recipes,
so every cell keeps its inputs.

* :func:`paper_graph`: the paper's generator ``G = f(V, rho, alpha)``
  (§3.4): edge probability ``rho / 100 * U[0, 1)``, integer costs uniform in
  ``[1, alpha]``, no self-loops, inf where there is no edge.  Drawn on the
  device with a ``torch.Generator``, a few large calls.
* :func:`corpus`: the paper's evaluation corpus (§4): graphs of V nodes
  with ``rho ~ U[0, rho_max]`` each, stacked into one padded (G, N, N) tensor
  with inert padding (inf off the diagonal, 0 on it).  The sizes are the
  same set for every seed, an even grid over ``[v_min, v_max]`` in an
  order drawn from the seed, so that no seed changes the work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

INF = float("inf")


def torch_generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number) and a
    stream number, so that two inputs of one run draw independently."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + stream) % (1 << 64))
    return gen


def numpy_rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


def _costs(gen: torch.Generator, shape, rho: torch.Tensor, alpha: int) -> torch.Tensor:
    """Cost matrices of ``shape`` (..., N, N): an edge where a second
    uniform draw falls under ``rho / 100 * U[0, 1)``, its cost an integer in
    [1, alpha]; inf elsewhere."""
    dev = gen.device
    p = torch.rand(shape, generator=gen, device=dev)
    p.mul_(rho / 100.0).clamp_(0.0, 1.0)
    adj = torch.rand(shape, generator=gen, device=dev) < p
    del p
    cost = torch.rand(shape, generator=gen, device=dev)
    cost.mul_(alpha).floor_().add_(1.0).clamp_(max=float(alpha))
    return cost.masked_fill_(~adj, INF)


def paper_graph(gen: torch.Generator, n: int, rho: float, alpha: int) -> torch.Tensor:
    """One (n, n) float32 cost matrix of ``G = f(n, rho, alpha)`` on the
    generator's device, diagonal 0."""
    h = _costs(gen, (n, n), torch.tensor(float(rho), device=gen.device), alpha)
    return h.fill_diagonal_(0.0)


def size_grid(n_graphs: int, v_min: int, v_max: int) -> np.ndarray:
    """The corpus's node counts: an even grid over [v_min, v_max], the
    same set for every seed (V ~ U[v_min, v_max] by its quantiles)."""
    return np.rint(np.linspace(v_min, v_max, n_graphs)).astype(np.int64)


def corpus(gen: torch.Generator, n_graphs: int, v_min: int, v_max: int, rho_max: float,
           alpha: int, chunk: int = 64) -> Tuple[torch.Tensor, np.ndarray]:
    """The paper's corpus as one padded (G, v_max, v_max) float32 stack on
    the generator's device and its true sizes (host int64); each graph's
    rho ~ U[0, rho_max]."""
    dev = gen.device
    order = torch.randperm(n_graphs, generator=gen, device=dev).cpu().numpy()
    sizes = size_grid(n_graphs, v_min, v_max)[order]
    rho = torch.rand(n_graphs, generator=gen, device=dev) * float(rho_max)
    n = int(v_max)
    stack = torch.empty((n_graphs, n, n), dtype=torch.float32, device=dev)
    node = torch.arange(n, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    live_all = torch.as_tensor(sizes, device=dev)
    for g0 in range(0, n_graphs, chunk):
        g1 = min(n_graphs, g0 + chunk)
        h = _costs(gen, (g1 - g0, n, n), rho[g0:g1, None, None], alpha)
        live = node[None, :] < live_all[g0:g1, None]
        valid = live[:, :, None] & live[:, None, :]
        h.masked_fill_(~valid, INF)
        stack[g0:g1] = h.masked_fill_(eye, 0.0)
    return stack, sizes
