"""Dispatch seam for the port's kernels, ported from ``repro.kernels.ops``.

Every solver in ``repro_torch.core`` reaches a kernel through this module.
The backend follows the tensor: a CUDA tensor runs the hand-written kernel
and a CPU tensor runs the plain PyTorch version.  There is no other way to
choose, so a CUDA tensor never falls back to the plain version.

Ported so far: ``minplus``, ``minplus_argmin``, ``pred_from_kstar``,
``minplus_pred``, ``fw_block``, ``fw_block_pred``, ``fw_round`` and
``fw_round_pred``.  ``rank_k_update`` and ``row_restricted_close`` follow
with the dynamic engine (ROADMAP.md).  The JAX file's autotune consult has
no counterpart yet: every kernel runs its compiled-in tiles.

bf16 operands select the mixed mode, as in the JAX file: each entry point
upcasts to f32, computes and rounds the value once to the first operand's
dtype; ``_check_mixed`` admits tropical only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring, SemiringLike, get_semiring

from . import fw_round as _fw_round
from .fw_block import fw_block_cuda, fw_block_pred_cuda, fw_block_pred_torch, fw_block_torch
from .minplus import minplus_argmin_cuda, minplus_argmin_torch, minplus_cuda, minplus_torch

__all__ = [
    "minplus",
    "minplus_argmin",
    "minplus_pred",
    "pred_from_kstar",
    "fw_block",
    "fw_block_pred",
    "fw_round",
    "fw_round_pred",
    "backend",
    "MIXED_PRECISION_SEMIRINGS",
]

# Semirings validated for bf16 storage with f32 accumulation (the
# mixed-precision mode), as in the JAX package: tropical only.
MIXED_PRECISION_SEMIRINGS = ("tropical",)


def backend(t: torch.Tensor) -> str:
    """``"cuda"`` for a CUDA tensor, ``"torch"`` (the plain version) else."""
    return "cuda" if t.is_cuda else "torch"


def _check_mixed(sr: Semiring, *arrays) -> bool:
    """True when any operand is bf16 (mixed mode); rejects unvalidated
    semirings — the one guard every entry point shares."""
    mixed = any(a is not None and a.dtype == torch.bfloat16 for a in arrays)
    if mixed and sr.name not in MIXED_PRECISION_SEMIRINGS:
        raise ValueError(
            f"bf16 mixed-precision min-plus is only validated for semirings "
            f"{list(MIXED_PRECISION_SEMIRINGS)}; semiring {sr.name!r} must "
            f"stay in float32 until its error contract is established"
        )
    return mixed


def fw_round(
    d: torch.Tensor,
    o: int,
    *,
    block_size: int,
    semiring: SemiringLike = "tropical",
) -> torch.Tensor:
    """One fused multi-stage blocked-FW round over the full matrix.

    ``o`` is the element offset of pivot block o // B.  The three stages
    (pivot closure, col' = col ⊗ A*, fused full accumulate D ⊕ col' ⊗ row)
    run as the CUDA kernel on a CUDA tensor, which updates ``d`` in place,
    and as the plain version on a CPU tensor.  Accepts (N, N) or batched
    (G, N, N) state; bf16 storage selects the mixed-precision mode (f32
    arithmetic, tropical only).
    """
    sr = get_semiring(semiring)
    _check_mixed(sr, d)
    return _fw_round.fw_round(d, o, block_size=block_size, semiring=sr)


def _f32(*arrays):
    """The operands as contiguous f32 tensors (None passes through)."""
    return tuple(None if a is None else a.float().contiguous() for a in arrays)


def minplus(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> torch.Tensor:
    """Z = ⊕_k x[:, k] ⊗ y[k, :]; fused Z = a ⊕ (.) when ``a`` is given.
    2D or batched (G, ·, ·) operands; a new tensor in ``x``'s dtype."""
    sr = get_semiring(semiring)
    _check_mixed(sr, x, y, a)
    fn = minplus_cuda if backend(x) == "cuda" else minplus_torch
    return fn(*_f32(x, y, a), semiring=sr).to(x.dtype)


def minplus_argmin(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Z, K*) with the fused global-k witness (int32; -1 where nothing
    improved on ``a`` or on the semiring zero; ties to the smallest k)."""
    sr = get_semiring(semiring)
    _check_mixed(sr, x, y, a)
    fn = minplus_argmin_cuda if backend(x) == "cuda" else minplus_argmin_torch
    z, ks = fn(*_f32(x, y, a), semiring=sr)
    return z.to(x.dtype), ks


def pred_from_kstar(
    kstar: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    *,
    k_offset: int = 0,
    j_offset: int = 0,
    fallback: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Derive predecessors from argmin winners — the one shared rule.

    ``k*`` wins for (i, j), so the path is i --(x-path)--> k* --(y-path)--> j
    and the predecessor of j is ``py[k*, j]``, unless the y-path is empty
    (k*'s global id, ``k* + k_offset``, is j's, ``j + j_offset``): then it is
    x's own last hop ``px[i, k*]``.  Where ``kstar < 0`` the entry comes from
    ``fallback`` (the old predecessors), or is -1.  Batched (G, ·, ·)
    operands work as they are.  Plain torch gathers on either device, as in
    the JAX package (no Pallas kernel there).
    """
    ks = kstar.clamp(min=0).long()
    p_via = torch.gather(py, -2, ks)
    p_own = torch.gather(px, -1, ks)
    cols = torch.arange(kstar.shape[-1], device=kstar.device)
    pz = torch.where(ks + k_offset == cols + j_offset, p_own, p_via)
    kept = torch.full_like(pz, -1) if fallback is None else fallback
    return torch.where(kstar < 0, kept, pz)


def minplus_pred(
    x: torch.Tensor,
    y: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    *,
    a: Optional[torch.Tensor] = None,
    pa: Optional[torch.Tensor] = None,
    k_offset: int = 0,
    j_offset: int = 0,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ⊕⊗ with predecessor propagation, on the witness kernel.
    Without ``a``: a plain product, predecessors -1 where Z is the zero.
    With ``a``/``pa``: the strict-improvement accumulate, where entries that
    kept ``a`` keep ``pa``."""
    z, kstar = minplus_argmin(x, y, a, semiring=semiring)
    pz = pred_from_kstar(kstar, px, py, k_offset=k_offset, j_offset=j_offset, fallback=pa)
    return z, pz


def fw_block(d: torch.Tensor, *, semiring: SemiringLike = "tropical") -> torch.Tensor:
    """Closure of a (B, B) tile or a (T, B, B) stack of tiles; bf16 tiles
    are closed in f32 and rounded once."""
    sr = get_semiring(semiring)
    _check_mixed(sr, d)
    fn = fw_block_cuda if backend(d) == "cuda" else fw_block_torch
    return fn(*_f32(d), semiring=sr).to(d.dtype)


def fw_block_pred(
    d: torch.Tensor, p: torch.Tensor, *, semiring: SemiringLike = "tropical"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closure with predecessors (global node ids in ``p``, int32)."""
    sr = get_semiring(semiring)
    _check_mixed(sr, d)
    fn = fw_block_pred_cuda if backend(d) == "cuda" else fw_block_pred_torch
    z, pz = fn(*_f32(d), p.contiguous(), semiring=sr)
    return z.to(d.dtype), pz


def fw_round_pred(
    d: torch.Tensor,
    p: torch.Tensor,
    o: int,
    *,
    block_size: int,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused multi-stage round with predecessor propagation, out of place.

    The three stages of :func:`fw_round`, composed from the witness
    primitives: the pivot closure by :func:`fw_block_pred`, col' by one
    accumulate :func:`minplus_pred`, and the full update by one accumulate
    :func:`minplus_pred`.  Values equal :func:`fw_round`'s (the col'
    accumulate's candidates already lie in the plain product's: A* has the
    one on its diagonal).  Stage 3's row panels alias the state, so it
    writes new (d, p) tensors, as JAX does.  (N, N) or (G, N, N) state.
    """
    sr = get_semiring(semiring)
    _check_mixed(sr, d)
    b = block_size
    pivot, ppivot = fw_block_pred(d[..., o:o + b, o:o + b], p[..., o:o + b, o:o + b],
                                  semiring=sr)
    col, pcol = d[..., :, o:o + b], p[..., :, o:o + b]
    colp, pcolp = minplus_pred(col, pivot, pcol, ppivot, a=col, pa=pcol, k_offset=o,
                               j_offset=o, semiring=sr)
    return minplus_pred(colp, d[..., o:o + b, :], pcolp, p[..., o:o + b, :], a=d, pa=p,
                        k_offset=o, j_offset=0, semiring=sr)
