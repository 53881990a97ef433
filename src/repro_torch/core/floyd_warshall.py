"""Floyd-Warshall helpers, ported from ``repro.core.floyd_warshall``.

This slice carries :func:`init_pred`, which the blocked solver's
predecessor path needs; the squaring and classic solvers of that module
are later slices (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import torch

from .semiring import SemiringLike, get_semiring

__all__ = ["init_pred"]


def init_pred(h: torch.Tensor, semiring: SemiringLike = "tropical") -> torch.Tensor:
    """Initial int32 predecessor matrix of a cost matrix, on its device:
    ``i`` where edge (i, j) exists (not the semiring zero), -1 elsewhere,
    and every node its own predecessor on the diagonal."""
    sr = get_semiring(semiring)
    n = h.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=h.device)
    p = torch.where(sr.is_zero(h), torch.tensor(-1, dtype=torch.int32, device=h.device),
                    rows[:, None].expand(n, n))
    p[rows, rows] = rows
    return p
