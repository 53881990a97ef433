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

Beside the registry the module holds the paper's 3D-broadcast product
(``minplus_3d``, its Fig. 8), the core-level ``minplus`` / ``minplus_pred``
(which reach the kernels through ``repro_torch.kernels.ops``), the
soft-min matmul and the padding helpers, which take an (n, n) matrix or a
(G, n, n) stack.

Tropical conventions: distance matrices are float (``inf`` = "no path"),
the diagonal is 0, edge weights are strictly positive.  Each registry
instance documents its own domain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

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
    "tropical_eye",
    "default_device",
    "minplus_3d",
    "minplus_3d_argmin",
    "auto_row_chunk",
    "minplus",
    "minplus_pred",
    "softmin_matmul",
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


def tropical_eye(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity of the tropical semiring: 0 on the diagonal, +inf elsewhere."""
    return TROPICAL.eye(n, dtype, device)


# ---------------------------------------------------------------------------
# The paper's 3D-broadcast formulation (its Figure 8).
# ---------------------------------------------------------------------------

def _broadcast(x: torch.Tensor, y: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """L[..., i, k, j] = x[..., i, k] ⊗ y[..., k, j], built whole."""
    return sr.mul(x[..., :, :, None], y[..., None, :, :])


def minplus_3d(
    x: torch.Tensor, y: torch.Tensor, semiring: SemiringLike = "tropical"
) -> torch.Tensor:
    """⊕⊗ product via the paper's N×N×N broadcast tensor: build
    ``L[i, k, j] = x[i, k] ⊗ y[k, j]``, then ⊕-reduce over k.  O(n^3)
    memory on purpose — the memory-faithful reference, plain torch ops on
    any device (in JAX it is an XLA broadcast, not a Pallas kernel).  A
    (G, ·, ·) stack broadcasts a (G, n, n, n) tensor."""
    sr = get_semiring(semiring)
    return sr.reduce(_broadcast(x, y, sr), dim=-2)


def minplus_3d_argmin(
    x: torch.Tensor, y: torch.Tensor, semiring: SemiringLike = "tropical"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The product and its int32 witness argreduce over k (paper Fig. 8
    steps 4-6).  Ties go to the smallest k, as ``jnp.argmin`` does; under
    NaN the two libraries need not agree."""
    sr = get_semiring(semiring)
    l = _broadcast(x, y, sr)
    return sr.reduce(l, dim=-2), sr.argreduce(l, dim=-2).to(torch.int32)


# ---------------------------------------------------------------------------
# The memory-bounded product, on the kernels.
# ---------------------------------------------------------------------------

def auto_row_chunk(m: int, n: int, k: int, budget_elems: int = 1 << 16) -> int:
    """Row chunk whose (chunk, n, k) broadcast holds ``budget_elems``
    elements (at least 4 rows, at most m), the JAX package's heuristic for
    its chunked fold.  Chunking never changes values: each output row's
    candidate set is the same."""
    per_row = max(n * k, 1)
    c = max(4, budget_elems // per_row)
    return int(min(m, c))


def _ops():
    from repro_torch.kernels import ops  # lazy: the kernels import this module

    return ops


def minplus(
    x: torch.Tensor, y: torch.Tensor, *, row_chunk: Optional[int] = None
) -> torch.Tensor:
    """Min-plus product ``Z[i, j] = min_k x[i, k] + y[k, j]`` without the
    n^3 tensor: the ``minplus`` kernel on a CUDA tensor, its plain fold on
    a CPU tensor (``kernels.ops.minplus``).  ``row_chunk`` is accepted for
    the JAX signature; the plain fold sizes its own k chunks, and the
    result does not depend on either."""
    del row_chunk
    return _ops().minplus(x, y)


def minplus_pred(
    x: torch.Tensor,
    y: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    *,
    k_offset: int = 0,
    j_offset: int = 0,
    row_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-plus product with predecessor propagation: with ``k*`` the
    argmin, the predecessor of j is ``py[k*, j]``, or ``px[i, k*]`` where
    the y-path is empty (``k* + k_offset == j + j_offset``); -1 where Z is
    inf.  ``k_offset`` / ``j_offset`` are the global node ids of x's column
    0 and the output's column 0 (tiles of a larger matrix).  The
    ``minplus_pred`` kernel on a CUDA tensor (``kernels.ops.minplus_pred``);
    ``row_chunk`` as in :func:`minplus`."""
    del row_chunk
    if px.shape != x.shape or py.shape != y.shape:
        raise ValueError(f"preds {tuple(px.shape)}, {tuple(py.shape)} do not match operands "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    return _ops().minplus_pred(x, y, px, py, k_offset=k_offset, j_offset=j_offset)


# ---------------------------------------------------------------------------
# Beyond the paper: the soft-min matmul.
# ---------------------------------------------------------------------------

def _flush(v: torch.Tensor, tiny: float) -> torch.Tensor:
    """Subnormal values to zero, as XLA's CPU and TPU code flushes them: an
    underflowing exponential or sum then reads "no path" (inf) in both
    packages."""
    return torch.where(v < tiny, torch.zeros_like(v), v)


def softmin_matmul(x: torch.Tensor, y: torch.Tensor, *, tau: float = 2e-2) -> torch.Tensor:
    """Approximate min-plus through a dense matmul via the tropical limit:
    ``Z = -tau * log(exp(-X/tau) @ exp(-Y/tau))`` -> min-plus as tau -> 0.

    The inputs are normalised by their largest finite magnitude (min-plus
    is positively homogeneous) and shifted by row / column minima so the
    exponentials stay near 1; ``tau`` is in normalised units (tau >= 0.05
    is safe for any input, error about tau * log(n) * scale).  The matmul
    runs at full float32 precision (TF32 off for the call), as the JAX
    package's does; it is a library matmul, not a port of a kernel.
    Subnormal exponentials and sums are flushed to zero (``_flush``), as
    XLA flushes them.  Experimental, used by no solver."""
    def finite_max(v):
        return torch.where(torch.isfinite(v), v.abs(), torch.zeros_like(v)).max()

    scale = torch.clamp(torch.maximum(finite_max(x), finite_max(y)), min=1e-9)
    xn, yn = x / scale, y / scale
    a = xn.amin(dim=1, keepdim=True)                # (m, 1) row shift
    b = yn.amin(dim=0, keepdim=True)                # (1, n) col shift
    a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
    b = torch.where(torch.isfinite(b), b, torch.zeros_like(b))
    tiny = torch.finfo(x.dtype).tiny
    ex = _flush(torch.exp(-(xn - a) / tau), tiny)   # in (0, 1], inf -> 0
    ey = _flush(torch.exp(-(yn - b) / tau), tiny)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        s = _flush(ex @ ey, tiny)
    finally:
        torch.set_float32_matmul_precision(precision)
    z = torch.where(s > 0, -tau * torch.log(torch.clamp(s, min=tiny)),
                    torch.full_like(s, float("inf")))
    return (z + a + b) * scale


# ---------------------------------------------------------------------------
# Padding helpers: an (n, n) matrix or a (G, n, n) stack.
# ---------------------------------------------------------------------------

def pad_to_multiple(
    d: torch.Tensor, multiple: int, semiring: SemiringLike = "tropical"
) -> torch.Tensor:
    """Pad a distance matrix, or each matrix of a (G, n, n) stack, to a
    multiple of ``multiple`` with unreachable (``zero`` off-diagonal,
    ``one`` diagonal) phantom nodes — inert under any registered semiring.
    Returns ``d`` itself when no pad is needed."""
    sr = get_semiring(semiring)
    n = d.shape[-1]
    pad = (-n) % multiple
    if pad == 0:
        return d
    out = sr.eye(n + pad, d.dtype, d.device).expand(*d.shape[:-2], n + pad, n + pad).clone()
    out[..., :n, :n] = d
    return out


def pad_pred_to_multiple(p: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad a predecessor matrix (or a (G, n, n) stack) to match
    :func:`pad_to_multiple`: -1 (no predecessor) off the diagonal of the
    phantom nodes, each phantom its own predecessor on it.  Returns ``p``
    itself when no pad is needed."""
    n = p.shape[-1]
    pad = (-n) % multiple
    if pad == 0:
        return p
    out = torch.full((*p.shape[:-2], n + pad, n + pad), -1, dtype=p.dtype, device=p.device)
    out[..., :n, :n] = p
    idx = torch.arange(n, n + pad, device=p.device)
    out[..., idx, idx] = idx.to(p.dtype)
    return out


def unpad(z: torch.Tensor, n: int) -> torch.Tensor:
    return z[..., :n, :n]


def ceil_log2(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))))
