"""Closed semirings on torch tensors — the port of ``repro.core.semiring``.

(min, +) is one instance of matrix closure over an idempotent closed
semiring: swap the (⊕, ⊗) pair and the same kernels and solvers compute
widest paths (max, min), most-reliable paths (max, ×) and transitive
closure (∨, ∧).  :class:`Semiring` records the pair plus the constants and
reductions the kernels need; ``SEMIRINGS`` is the registry every solver
entry point resolves its ``semiring=`` argument against.  The registry
names are the JAX package's, so results can be compared name by name.

⊕ must propagate NaN, as ``jnp.minimum`` does: ``torch.minimum`` /
``torch.maximum`` / ``amin`` / ``amax`` do, and the CUDA kernel's ⊕ is
written to match (see ``kernels/csrc/semiring.cuh``).

Tropical conventions: distance matrices are float (``inf`` = "no path"),
the diagonal is 0, edge weights are strictly positive.  Each registry
instance documents its own domain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Union

import torch

__all__ = [
    "Semiring",
    "SEMIRINGS",
    "TROPICAL",
    "BOTTLENECK",
    "RELIABILITY",
    "BOOLEAN",
    "get_semiring",
    "register_semiring",
    "semiring_eye",
    "default_device",
    "pad_to_multiple",
    "pad_pred_to_multiple",
    "unpad",
    "ceil_log2",
]


@dataclass(frozen=True)
class Semiring:
    """An idempotent closed semiring (S, ⊕, ⊗, 0̄, 1̄) with a selective ⊕.

    ``add`` is *selective* (returns one of its operands: min or max on a
    totally ordered domain), so any fold over the same candidate set gives
    the same bits.  ``zero`` is the ⊕-identity and ⊗-annihilator (the "no
    path" value and the inert padding fill); ``one`` is the ⊗-identity (the
    diagonal).  ``monotone_mul`` is True when ⊗ by any non-``one`` edge
    strictly worsens the value on the instance domain, which makes
    predecessor rows acyclic trees.
    """

    name: str
    add: Callable            # elementwise ⊕ (selective): torch.minimum / maximum
    mul: Callable            # elementwise ⊗: torch.add / minimum / mul
    zero: float              # ⊕-identity, ⊗-annihilator, padding fill
    one: float               # ⊗-identity, diagonal value
    reduce: Callable         # ⊕ over a dim: torch.amin / torch.amax
    argreduce: Callable      # index of the ⊕-winner: torch.argmin / argmax
    better: Callable         # strict improvement: (cand, acc) -> bool mask
    monotone_mul: bool = True
    doc: str = field(default="", compare=False)

    def is_zero(self, x):
        """Mask of "no path" entries."""
        return x == self.zero

    def eye(self, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        """⊗-identity matrix: ``one`` on the diagonal, ``zero`` elsewhere;
        on ``cuda`` unless ``device`` says otherwise (:func:`default_device`)."""
        out = torch.full((n, n), self.zero, dtype=dtype, device=default_device(device))
        out.fill_diagonal_(self.one)
        return out


def _lt(cand, acc):
    return cand < acc


def _gt(cand, acc):
    return cand > acc


TROPICAL = Semiring(
    name="tropical",
    add=torch.minimum, mul=torch.add, zero=float("inf"), one=0.0,
    reduce=torch.amin, argreduce=torch.argmin, better=_lt,
    doc="(min, +) shortest path.  Domain: costs > 0, inf = no edge.",
)

BOTTLENECK = Semiring(
    name="bottleneck",
    add=torch.maximum, mul=torch.minimum, zero=float("-inf"), one=float("inf"),
    reduce=torch.amax, argreduce=torch.argmax, better=_gt, monotone_mul=False,
    doc="(max, min) widest path.  Domain: capacities, -inf = no edge.",
)

RELIABILITY = Semiring(
    name="reliability",
    add=torch.maximum, mul=torch.mul, zero=0.0, one=1.0,
    reduce=torch.amax, argreduce=torch.argmax, better=_gt,
    doc="(max, ×) most-reliable path.  Domain: probabilities in (0, 1), "
        "0 = no edge.  Keep values finite: 0 × inf is NaN.",
)

BOOLEAN = Semiring(
    name="boolean",
    add=torch.maximum, mul=torch.minimum, zero=0.0, one=1.0,
    reduce=torch.amax, argreduce=torch.argmax, better=_gt, monotone_mul=False,
    doc="(∨, ∧) reachability / transitive closure.  Domain: {0.0, 1.0}.",
)

SEMIRINGS: Dict[str, Semiring] = {
    s.name: s for s in (TROPICAL, BOTTLENECK, RELIABILITY, BOOLEAN)
}

SemiringLike = Union[str, Semiring]


def get_semiring(s: SemiringLike = "tropical") -> Semiring:
    """Resolve a registry name or pass an instance through."""
    if isinstance(s, Semiring):
        return s
    try:
        return SEMIRINGS[s]
    except KeyError:
        raise ValueError(
            f"unknown semiring {s!r}; registered: {sorted(SEMIRINGS)}"
        ) from None


def register_semiring(sr: Semiring) -> Semiring:
    """Add (or replace) a registry entry; returns ``sr`` for chaining."""
    SEMIRINGS[sr.name] = sr
    return sr


def default_device(device=None):
    """``device`` when given, else ``"cuda"``.  The port's entry points run
    on the card unless the caller names another device; on a host without
    CUDA a call that names none raises rather than fall back to the CPU."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA by default and this host has no CUDA device; "
            "pass device='cpu' to run the plain PyTorch version"
        )
    return "cuda"


def semiring_eye(
    n: int, semiring: SemiringLike = "tropical", dtype=torch.float32, device=None
) -> torch.Tensor:
    return get_semiring(semiring).eye(n, dtype, device)


def pad_to_multiple(
    d: torch.Tensor, multiple: int, semiring: SemiringLike = "tropical"
) -> torch.Tensor:
    """Pad a distance matrix to a multiple of ``multiple`` with unreachable
    (``zero`` off-diagonal, ``one`` diagonal) phantom nodes — inert under
    any registered semiring.  Returns ``d`` itself when no pad is needed."""
    sr = get_semiring(semiring)
    n = d.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return d
    out = sr.eye(n + pad, d.dtype, d.device)
    out[:n, :n] = d
    return out


def pad_pred_to_multiple(p: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad a predecessor matrix to match :func:`pad_to_multiple`: -1 (no
    predecessor) off the diagonal of the phantom nodes, each phantom its own
    predecessor on it.  Returns ``p`` itself when no pad is needed."""
    n = p.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return p
    out = torch.full((n + pad, n + pad), -1, dtype=p.dtype, device=p.device)
    out[:n, :n] = p
    idx = torch.arange(n, n + pad, device=p.device)
    out[idx, idx] = idx.to(p.dtype)
    return out


def unpad(z: torch.Tensor, n: int) -> torch.Tensor:
    return z[:n, :n]


def ceil_log2(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))))
