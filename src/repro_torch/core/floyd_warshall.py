"""Floyd-Warshall solvers, ported from ``repro.core.floyd_warshall``: the
paper's FW-GPU (tropical matrix squaring) and the classic O(n^3) loop,
generalised over the semiring registry.

* :func:`fw_squaring` — the paper's "FW-GPU": ceil(log2 n) fused products
  ``D <- D ⊕ D ⊗ D`` (O(n^3 log n) work), each one ``minplus`` kernel
  launch on a CUDA tensor (``kernels.ops.minplus`` with X, Y and the
  accumulator the same tensor; the kernel writes a new one).  ``use_3d=True``
  builds the paper's N×N×N broadcast tensor instead (``minplus_3d``): plain
  torch ops, memory-faithful, small n only.
* :func:`fw_squaring_early_exit` — the same, stopping when a squaring
  changes nothing (paper §3.2); one host sync an iteration.
* :func:`fw_classic` — the textbook loop, n rank-1 ⊕⊗ steps.  Plain torch
  ops on any device: in JAX it is an XLA ``fori_loop``, not a Pallas kernel.

Every solver takes an (n, n) matrix or a (G, n, n) stack (each graph
independent, as ``jax.vmap`` runs them); the ``*_batch`` names are the
JAX package's batch entry points.

Predecessor conventions (paper §2): ``pred[i, j]`` is the last node before
j on the current optimal i->j path; ``pred[i, i] = i``; unreachable = -1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .semiring import TROPICAL, Semiring, SemiringLike, ceil_log2, get_semiring, minplus_3d

__all__ = [
    "init_pred",
    "fw_squaring",
    "fw_squaring_batch",
    "fw_squaring_early_exit",
    "fw_classic",
    "fw_classic_batch",
]


def _ops():
    from repro_torch.kernels import ops  # lazy: the kernels import core

    return ops


def init_pred(h: torch.Tensor, semiring: SemiringLike = "tropical") -> torch.Tensor:
    """Initial int32 predecessor matrix of a cost matrix (or of each matrix
    of a (G, n, n) stack), on its device: ``i`` where edge (i, j) exists
    (not the semiring zero), -1 elsewhere, and every node its own
    predecessor on the diagonal."""
    sr = get_semiring(semiring)
    n = h.shape[-1]
    rows = torch.arange(n, dtype=torch.int32, device=h.device)
    p = torch.where(sr.is_zero(h), torch.tensor(-1, dtype=torch.int32, device=h.device),
                    rows[:, None].expand(n, n))
    p[..., rows, rows] = rows
    return p


def fw_squaring(
    h: torch.Tensor,
    *,
    with_pred: bool = False,
    use_3d: bool = False,
    semiring: Semiring = TROPICAL,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Paper's FW-GPU: matrix squaring, a fixed ceil(log2 n) iterations.

    After t squarings every optimal path of at most 2^t hops is exact, so
    ceil(log2 n) iterations suffice.  ``use_3d=True`` selects the literal
    N×N×N broadcast of the paper (memory-faithful; small n only).  With
    predecessors each iteration is one ``minplus_pred`` with x, y and the
    accumulator the state (``use_3d`` does not apply, as in JAX).
    """
    sr = get_semiring(semiring)
    ops = _ops()
    iters = ceil_log2(h.shape[-1])
    d = h
    if not with_pred:
        for _ in range(iters):
            d = sr.add(d, minplus_3d(d, d, sr)) if use_3d else ops.minplus(d, d, d, semiring=sr)
        return d, None
    p = init_pred(h, sr)
    for _ in range(iters):
        d, p = ops.minplus_pred(d, d, p, p, a=d, pa=p, semiring=sr)
    return d, p


def fw_squaring_batch(
    hs: torch.Tensor,
    *,
    with_pred: bool = False,
    use_3d: bool = False,
    semiring: Semiring = TROPICAL,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`fw_squaring` on a (G, N, N) stack: each iteration is one
    batched product for all G graphs.  ``use_3d=True`` broadcasts a
    (G, N, N, N) tensor; keep the batch small."""
    return fw_squaring(hs, with_pred=with_pred, use_3d=use_3d, semiring=semiring)


def fw_squaring_early_exit(
    h: torch.Tensor, semiring: Semiring = TROPICAL
) -> Tuple[torch.Tensor, int]:
    """Paper §3.2 verbatim: square "until we observe no changes", at most
    ceil(log2 n) + 1 times.  Returns (distances, iterations taken), the
    JAX package's count; the check syncs the host once an iteration."""
    sr = get_semiring(semiring)
    ops = _ops()
    limit = ceil_log2(h.shape[-1]) + 1
    d, it, changed = h, 0, True
    while changed and it < limit:
        z = ops.minplus(d, d, d, semiring=sr)
        changed = bool(sr.better(z, d).any())
        d, it = z, it + 1
    return d, it


def fw_classic(
    h: torch.Tensor,
    *,
    with_pred: bool = False,
    semiring: Semiring = TROPICAL,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Textbook Floyd-Warshall: n pivot steps, each a rank-1 ⊕⊗ update
    ``d = d ⊕ (d[:, k, None] ⊗ d[None, k, :])``.  With predecessors, on
    strict improvement through pivot k, ``pred[i, j] <- pred[k, j]``."""
    sr = get_semiring(semiring)
    n = h.shape[-1]
    d = h
    if not with_pred:
        for k in range(n):
            d = sr.add(d, sr.mul(d[..., :, k:k + 1], d[..., k:k + 1, :]))
        return d, None
    p = init_pred(h, sr)
    for k in range(n):
        via = sr.mul(d[..., :, k:k + 1], d[..., k:k + 1, :])
        better = sr.better(via, d)
        d = torch.where(better, via, d)
        p = torch.where(better, p[..., k:k + 1, :], p)
    return d, p


def fw_classic_batch(
    hs: torch.Tensor,
    *,
    with_pred: bool = False,
    semiring: Semiring = TROPICAL,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`fw_classic` on a (G, N, N) stack: each pivot step is one
    rank-1 update of all G graphs."""
    return fw_classic(hs, with_pred=with_pred, semiring=semiring)
