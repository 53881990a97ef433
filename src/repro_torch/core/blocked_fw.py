"""Blocked Floyd-Warshall with the fused multi-stage round, ported from
``repro.core.blocked_fw``.

for each pivot block t (size B, offset o = t·B):
  stage 1: close the pivot block      A* <- FW(D_tt)
  stage 2: col panel                  col' <- D_*t ⊗ A*
  stage 3: fused full update          D <- D ⊕ col' ⊗ D_t*

Stage 3's single accumulate re-derives the row stripe, the column stripe
and the pivot block by subsumption over the old operands
(``1 ⊕ A A* = 1 ⊕ A* A = A*`` in every closed semiring), so each element is
written once a round.  All three stages are one ``kernels.ops.fw_round``
call; the loop over the n/B pivots is a plain Python loop.

Divergence from the JAX package — donation.  JAX's ``donate=True`` deletes
the caller's buffer, so reads after the call raise.  Torch cannot delete a
buffer: here ``donate=True`` means the caller's tensor may be overwritten
(the CUDA kernel updates the state in place), and ``donate=False`` copies it
first.  Nothing checks for reads of a donated tensor.

``round_mode="split"`` keeps the legacy round of four dispatches:
the pivot closure (``ops.fw_block``), the row panel A* ⊗ D_t*, the column
panel D_*t ⊗ A* with the closed pivot written into its pivot rows, and the
full accumulate D ⊕ col ⊗ row.  ``with_pred=True`` carries int32
predecessors through the same rounds on the witness kernels
(``ops.fw_round_pred`` fused, ``ops.minplus_pred`` split).  The rounds with
predecessors and the split round write new tensors each round, as JAX
does; the fused round without them updates the state in place.

Block size and round mode come from the autotune cache's ``fwround|...``
winners (``kernels.autotune.tune_fw_round``) when the caller gives none,
else B = min(256, n) and the fused round.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .floyd_warshall import init_pred
from .semiring import (
    TROPICAL,
    Semiring,
    SemiringLike,
    get_semiring,
    pad_pred_to_multiple,
    pad_to_multiple,
    unpad,
)

__all__ = ["blocked_fw", "blocked_fw_batch", "closure_block"]


def _ops():
    from repro_torch.kernels import ops  # lazy: the kernels import core

    return ops


def closure_block(d: torch.Tensor, semiring: Semiring = TROPICAL) -> torch.Tensor:
    """In-block FW closure (stage 1): B pivot steps on a (B, B) tile or a
    (T, B, B) stack of tiles, one dispatch either way (``ops.fw_block``)."""
    return _ops().fw_block(d, semiring=semiring)


def _closure_block_pred(
    d: torch.Tensor, p: torch.Tensor, semiring: Semiring = TROPICAL
) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ops().fw_block_pred(d, p, semiring=semiring)


def _resolve_round(
    h: torch.Tensor,
    block_size: Optional[int],
    round_mode: Optional[str],
    sr: Semiring,
    with_pred: bool = False,
) -> Tuple[int, str]:
    """Explicit arguments win; else the autotune ``fwround`` winner
    (``kernels.autotune.lookup_fw_round``, a dict read); else the
    compiled-in defaults (fused round, B = min(256, n)).

    Predecessor solves pin ``round_mode`` to the canonical fused round
    instead of consulting the cache, as in the JAX package: fused and split
    rounds emit different (equally valid) tie witnesses, and the per-size
    cache must never make a batched solve and a per-graph solve disagree on
    preds.  Distances are mode-independent either way."""
    n = h.shape[-1]
    if block_size is None or round_mode is None:
        from repro_torch.kernels import autotune, ops

        won = autotune.lookup_fw_round(ops.backend(h), h.dtype, n,
                                       g=h.shape[0] if h.ndim == 3 else 0, semiring=sr.name)
        if block_size is None:
            block_size = won.get("block_size", 256)
        if round_mode is None:
            round_mode = "fused" if with_pred else won.get("round_mode", "fused")
    if round_mode not in ("fused", "split"):
        raise ValueError(f"round_mode must be 'fused' or 'split', got {round_mode!r}")
    return min(int(block_size), n), round_mode


def _split_round(d: torch.Tensor, o: int, b: int, sr: Semiring) -> torch.Tensor:
    ops = _ops()
    pivot = closure_block(d[..., o:o + b, o:o + b], sr)             # one launch for all G
    row = ops.minplus(pivot, d[..., o:o + b, :], semiring=sr)      # (B, N)
    col = ops.minplus(d[..., :, o:o + b], pivot, semiring=sr)      # (N, B)
    col[..., o:o + b, :] = pivot    # col's pivot rows = the closed pivot: updates the stripes
    return ops.minplus(col, row, d, semiring=sr)


def _split_round_pred(
    d: torch.Tensor, p: torch.Tensor, o: int, b: int, sr: Semiring
) -> Tuple[torch.Tensor, torch.Tensor]:
    ops = _ops()
    pivot, ppivot = _closure_block_pred(d[..., o:o + b, o:o + b], p[..., o:o + b, o:o + b], sr)
    row, prow = d[..., o:o + b, :], p[..., o:o + b, :]
    col, pcol = d[..., :, o:o + b], p[..., :, o:o + b]
    row, prow = ops.minplus_pred(pivot, row, ppivot, prow, a=row, pa=prow, k_offset=o,
                                 j_offset=0, semiring=sr)
    col, pcol = ops.minplus_pred(col, pivot, pcol, ppivot, a=col, pa=pcol, k_offset=o,
                                 j_offset=o, semiring=sr)
    col[..., o:o + b, :] = pivot
    pcol[..., o:o + b, :] = ppivot
    return ops.minplus_pred(col, row, pcol, prow, a=d, pa=p, k_offset=o, j_offset=0,
                            semiring=sr)


def blocked_fw(
    h: torch.Tensor,
    *,
    block_size: Optional[int] = None,
    with_pred: bool = False,
    semiring: SemiringLike = TROPICAL,
    round_mode: Optional[str] = None,
    donate: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Blocked Floyd-Warshall on an (n, n) cost tensor, or on a (G, n, n)
    stack of independent graphs (:func:`blocked_fw_batch`), on its device.

    ``block_size`` is the tile edge B; the matrix is padded to a multiple
    of B with unreachable phantom nodes (semantically inert).  A bf16 ``h``
    selects the mixed-precision round (tropical only).  ``donate=True`` lets
    the solve overwrite ``h``.  Returns ``(dist, pred)``, ``pred`` an int32
    tensor on ``h``'s device when ``with_pred``, else None.
    """
    ops = _ops()
    sr = get_semiring(semiring)
    b, round_mode = _resolve_round(h, block_size, round_mode, sr, with_pred)
    n = h.shape[-1]
    d = pad_to_multiple(h, b, sr)
    nblk = d.shape[-1] // b
    if not with_pred:
        if round_mode == "split":
            for t in range(nblk):
                d = _split_round(d, t * b, b, sr)
            return unpad(d, n), None
        if d is h:   # the fused round updates d in place
            d = h.contiguous() if donate else h.clone(memory_format=torch.contiguous_format)
        for t in range(nblk):
            d = ops.fw_round(d, t * b, block_size=b, semiring=sr)
        return unpad(d, n), None

    p = pad_pred_to_multiple(init_pred(h, sr), b)
    for t in range(nblk):
        if round_mode == "fused":
            d, p = ops.fw_round_pred(d, p, t * b, block_size=b, semiring=sr)
        else:
            d, p = _split_round_pred(d, p, t * b, b, sr)
    return unpad(d, n), unpad(p, n)


def blocked_fw_batch(
    hs: torch.Tensor,
    *,
    block_size: Optional[int] = None,
    with_pred: bool = False,
    semiring: SemiringLike = TROPICAL,
    round_mode: Optional[str] = None,
    donate: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Blocked FW over a (G, N, N) stack of independent graphs.

    The same pivot loop as :func:`blocked_fw`; every launch takes the whole
    stack (``fw_round`` and the products carry G in their grids, the split
    round's pivot closure is one (G, B, B) ``fw_block`` launch), so the
    batch advances one pivot a round.  Ragged batches are padded upstream
    (``apsp.solve_batch``); phantom nodes are inert under every registered
    semiring.  ``donate=True`` lets the solve overwrite ``hs``."""
    if hs.ndim != 3:
        raise ValueError(f"blocked_fw_batch takes a (G, N, N) stack, got {tuple(hs.shape)}")
    return blocked_fw(hs, block_size=block_size, with_pred=with_pred, semiring=semiring,
                      round_mode=round_mode, donate=donate)
