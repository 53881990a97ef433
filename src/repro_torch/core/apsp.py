"""APSP front end, ported from ``repro.core.apsp``.

``solve(h, method=...)`` dispatches one dense cost matrix to a registered
solver.  The port registers ``"blocked_fw"`` (blocked Floyd-Warshall, fused
or split rounds, with or without predecessors); the other methods and
``solve_batch`` are later slices (ROADMAP.md queue 1).

Input conventions per semiring: off-diagonal "no edge" entries are the
semiring zero, the diagonal is the semiring one (tropical: inf / 0).

``solve`` runs on the card (``device="cuda"``, the default) unless the
caller passes another device, as the CPU tests pass ``device="cpu"``.  On
a host without CUDA a call that names no device raises: it never falls
back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from .blocked_fw import blocked_fw
from .errors import InputValidationError, NegativeCycleError
from .semiring import TROPICAL, Semiring, SemiringLike, default_device, get_semiring

__all__ = [
    "APSPResult",
    "solve",
    "METHODS",
    "register_method",
    "validate_cost_matrix",
    "check_negative_cycles",
    "next_pow2",
]


def validate_cost_matrix(h: torch.Tensor, semiring: SemiringLike = "tropical") -> None:
    """Input-boundary contract check: NaN entries are rejected with a typed
    :class:`~repro_torch.core.errors.InputValidationError` before any
    dispatch — a NaN is absorbing under every registered ⊕/⊗ pair, so one
    poisoned entry silently corrupts the whole closure.  Syncs the device;
    pass ``validate=False`` to ``solve`` on paths that guarantee clean
    inputs."""
    bad = torch.isnan(h)
    count = int(bad.sum())
    if count:
        idx = tuple(int(x) for x in torch.nonzero(bad)[0])
        sr = get_semiring(semiring)
        raise InputValidationError(
            f"cost matrix contains {count} NaN entr"
            f"{'y' if count == 1 else 'ies'} (first at {idx}): NaN is "
            f"absorbing under the {sr.name!r} semiring and would poison the "
            "whole closure.  Clean the input (no-edge is the semiring zero, "
            f"{sr.zero!r}) or pass validate=False to skip this check."
        )


def check_negative_cycles(dist: torch.Tensor, semiring: Semiring) -> None:
    """Tropical-only post-solve contract check: a strictly negative entry on
    the solved diagonal means the graph contains a negative cycle, so
    shortest-path distances are unbounded below — raise
    :class:`~repro_torch.core.errors.NegativeCycleError` instead of
    returning them.  Negative edges are fine; only a closed negative walk
    drives ``dist[i, i]`` below 0."""
    if semiring.name != "tropical":
        return
    diag = torch.diagonal(dist, dim1=-2, dim2=-1)
    neg = diag < 0
    if bool(neg.any()):
        idx = tuple(int(x) for x in torch.nonzero(neg)[0])
        raise NegativeCycleError(
            f"negative cycle detected: solved diagonal entry {idx} is "
            f"{float(diag[neg].min()):g} < 0, so tropical distances are unbounded "
            "below.  Remove the cycle or pass validate=False to skip this "
            "check (the returned matrix would be meaningless)."
        )


@dataclass
class APSPResult:
    dist: torch.Tensor
    pred: Optional[torch.Tensor]
    method: str


def _blocked(h, with_pred, block_size=None, semiring=TROPICAL, donate=False,
             round_mode=None, **kw):
    return blocked_fw(
        h, block_size=block_size, with_pred=with_pred, semiring=semiring,
        round_mode=round_mode, donate=donate,
    )


METHODS: Dict[str, Callable] = {
    "blocked_fw": _blocked,
}


def register_method(name: str, fn: Callable) -> None:
    """Register a solver ``fn(h, with_pred, **kw) -> (dist, pred)``."""
    METHODS[name] = fn


def solve(
    h,
    *,
    method: str = "blocked_fw",
    with_pred: bool = False,
    semiring: SemiringLike = "tropical",
    donate: Optional[bool] = None,
    dtype: Optional[torch.dtype] = None,
    validate: bool = True,
    device=None,
    **kwargs,
) -> APSPResult:
    """Solve the all-pairs path problem on a dense cost matrix.

    ``h`` is an (n, n) numpy array or tensor.  ``semiring`` is a registry
    name or instance; see ``repro_torch.core.semiring.SEMIRINGS``.

    ``device``: where the solve runs, ``"cuda"`` when not given.  The CPU
    runs the plain PyTorch version of each kernel.

    ``with_pred``: also return ``pred``, an int32 tensor on the solve's
    device: ``pred[i, j]`` is the last node before j on a best i -> j path,
    -1 where j is unreachable (``core.paths`` walks it).

    ``donate``: None (default) lets the solve overwrite its input whenever
    this call made a fresh copy of ``h`` (a host array, a dtype cast or a
    device move); ``True`` lets it overwrite the caller's tensor; ``False``
    never does.

    ``dtype``: storage dtype (default float32).  ``torch.bfloat16`` selects
    the mixed-precision mode — bf16 state with f32 arithmetic, tropical
    only.

    ``validate`` (default True): reject NaN input entries with a typed
    ``InputValidationError`` before dispatch, and (tropical only) raise
    ``NegativeCycleError`` when the solved diagonal goes negative.
    """
    if method not in METHODS:
        raise ValueError(
            f"unknown APSP method {method!r}; have {sorted(METHODS)} (the JAX "
            "package's squaring, classic and rkleene methods are not ported yet: "
            "ROADMAP.md queue 1, item 6)"
        )
    device = default_device(device)
    sr = get_semiring(semiring)
    target = torch.float32 if dtype is None else dtype
    x = torch.as_tensor(h, dtype=target, device=device)
    if validate:
        validate_cost_matrix(x, sr)
    if donate is None:
        donate = x is not h               # fresh copy -> safe to overwrite
    dist, pred = METHODS[method](x, with_pred, semiring=sr, donate=donate, **kwargs)
    if validate:
        check_negative_cycles(dist, sr)
    return APSPResult(dist=dist, pred=pred, method=method)


def next_pow2(x: int, floor: int = 1) -> int:
    """Smallest power-of-two >= x, with a floor — the shared bucketing rule
    (update-batch widths and affected-row lists in ``core.dynamic``)."""
    e = floor
    while e < x:
        e *= 2
    return e
