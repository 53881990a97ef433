"""Dispatch seam for the port's kernels, ported from ``repro.kernels.ops``.

Every solver in ``repro_torch.core`` reaches a kernel through this module.
The backend follows the tensor: a CUDA tensor runs the hand-written kernel
and a CPU tensor runs the plain PyTorch version.  There is no other way to
choose, so a CUDA tensor never falls back to the plain version.  A
``meta`` tensor (the dry run, ``launch/dryrun.py``) takes the kernel's
wrapper too, which allocates its outputs on ``meta``, reports its launch
plan and work to the dry run's counter and launches nothing: the plain
version would loop over k chunks and be priced as other work.

Every entry point of the JAX file is ported: ``minplus``,
``minplus_argmin``, ``pred_from_kstar``, ``minplus_pred``,
``rank_k_update`` and ``row_restricted_close`` (the dynamic engine's two
passes), ``fw_block``, ``fw_block_pred``, ``fw_round`` and
``fw_round_pred``.  The product entry points and the row pass take the
JAX signatures' ``**block_kw`` and resolve their tile as the JAX dispatch
does (:func:`_tuned`): explicit knobs win; otherwise a CUDA or ``meta``
dispatch reads the autotune cache's winner for its shape
(``autotune.lookup``, ``lookup_row_close``: a dict read, with the g -> 0
and semiring -> tropical fallbacks); either way only the kernel's own
knobs (``tile_rows``, ``chunks``) pass, so a call written for the JAX
signature (``bm=``, ``bn=``, ...) runs the default plan, and a knob the
kernel's lattice does not hold raises.  The plain versions take no knob:
a tile changes no value.

bf16 operands select the mixed mode, as in the JAX file: each entry point
upcasts to f32, computes and rounds the value once to the first operand's
dtype; ``_check_mixed`` admits tropical only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring, SemiringLike, get_semiring

from . import fw_round as _fw_round
from . import row_close as _row_close
from .fw_block import fw_block_cuda, fw_block_pred_cuda, fw_block_pred_torch, fw_block_torch
from .minplus import (
    minplus_argmin_cuda,
    minplus_argmin_torch,
    minplus_cuda,
    minplus_pred_cuda,
    minplus_pred_torch,
    minplus_torch,
    pred_from_kstar,
)

__all__ = [
    "minplus",
    "minplus_argmin",
    "minplus_pred",
    "pred_from_kstar",
    "rank_k_update",
    "row_restricted_close",
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
    """``"cuda"`` for a CUDA tensor, ``"meta"`` for a meta tensor (the
    kernel's wrapper, which launches nothing), ``"torch"`` (the plain
    version) else."""
    return "cuda" if t.is_cuda else "meta" if t.is_meta else "torch"


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


def _rows(*arrays, dtype=torch.float32):
    """The operands in ``dtype`` with unit column stride (None passes
    through): the product kernels read rows through their pitch, so a
    strided panel of the state is passed as it lies."""
    out = []
    for a in arrays:
        if a is not None:
            a = a.to(dtype)
            if a.shape[-1] > 1 and a.stride(-1) != 1:
                a = a.contiguous()
        out.append(a)
    return tuple(out)


def _tuned(b: str, x, y, block_kw: dict, sr: Semiring) -> dict:
    """Tile knobs for this product dispatch: explicit ``block_kw`` win,
    else the autotune cache's winner for the shape (keyed per semiring and
    batch, with the JAX cache's fallbacks); either way cut to the
    backend's knobs (none for the plain versions)."""
    if b == "torch":
        return {}
    from . import autotune   # lazy: a dict read, kept out of import order

    if not block_kw:
        g = x.shape[0] if x.ndim == 3 else 0
        m, k = x.shape[-2:]
        block_kw = autotune.lookup("cuda", x.dtype, m, k, y.shape[-1], g=g,
                                   semiring=sr.name)
    return autotune.knobs(b, block_kw)


def minplus(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
    **block_kw,
) -> torch.Tensor:
    """Z = ⊕_k x[:, k] ⊗ y[k, :]; fused Z = a ⊕ (.) when ``a`` is given.
    2D or batched (G, ·, ·) operands; a new tensor in ``x``'s dtype; tile
    knobs from ``block_kw`` or the autotune cache (:func:`_tuned`)."""
    sr = get_semiring(semiring)
    _check_mixed(sr, x, y, a)
    b = backend(x)
    if b == "torch":
        return minplus_torch(*_rows(x, y, a), semiring=sr).to(x.dtype)
    return minplus_cuda(*_rows(x, y, a), semiring=sr,
                        **_tuned(b, x, y, block_kw, sr)).to(x.dtype)


def minplus_argmin(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
    **block_kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Z, K*) with the fused global-k witness (int32; -1 where nothing
    improved on ``a`` or on the semiring zero; ties to the smallest k)."""
    sr = get_semiring(semiring)
    _check_mixed(sr, x, y, a)
    b = backend(x)
    if b == "torch":
        z, ks = minplus_argmin_torch(*_rows(x, y, a), semiring=sr)
    else:
        z, ks = minplus_argmin_cuda(*_rows(x, y, a), semiring=sr,
                                    **_tuned(b, x, y, block_kw, sr))
    return z.to(x.dtype), ks


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
    **block_kw,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ⊕⊗ with predecessor propagation, on the witness kernel.
    Without ``a``: a plain product, predecessors -1 where Z is the zero.
    With ``a``/``pa``: the strict-improvement accumulate, where entries that
    kept ``a`` keep ``pa``.  On a CUDA tensor one ``minplus_pred`` launch
    derives the preds by :func:`pred_from_kstar`'s rule in its epilogue; on
    a CPU tensor the plain version runs ``minplus_argmin`` and then the
    rule's gathers.  Operands may be strided panels of the state."""
    sr = get_semiring(semiring)
    _check_mixed(sr, x, y, a)
    b = backend(x)
    preds = _rows(px, py, pa, dtype=torch.int32)
    args = (*_rows(x, y), *preds[:2], *_rows(a), preds[2])
    if b == "torch":
        z, pz = minplus_pred_torch(*args, k_offset=k_offset, j_offset=j_offset, semiring=sr)
    else:
        z, pz = minplus_pred_cuda(*args, k_offset=k_offset, j_offset=j_offset, semiring=sr,
                                  **_tuned(b, x, y, block_kw, sr))
    return z.to(x.dtype), pz


def rank_k_update(
    dist: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    *,
    pred: Optional[torch.Tensor] = None,
    semiring: SemiringLike = "tropical",
    **block_kw,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One fused rank-k edge-relaxation pass over a solved state, as new
    tensors: ``dist ⊕ (dist[:, U] ⊗ W ⊗ dist[V, :])`` for the k edges
    ``(u_i, v_i, w_i)``, one (n, k) x (k, n) accumulate on :func:`minplus`.

    With ``pred`` the pass runs on :func:`minplus_argmin` and b's new
    predecessor is ``pred[v_{k*}, b]``, or ``u_{k*}`` itself where b is
    ``v_{k*}`` (the empty tail); entries that kept their value (k* = -1)
    keep their predecessor.  ``pred_from_kstar`` does not apply: the
    contraction indexes edges, not nodes.

    A (G, n, n) state takes (G, k) edges, each graph its own: one batched
    launch a pass (G in the grid's z), the pred rule gathered per graph —
    the computation of ``jax.vmap`` over the (n, n) pass.

    bf16 state forms x in f32 and rounds only the result, as the JAX pass
    does under ``jit`` (XLA drops x's round trip through bf16; the JAX
    function called eagerly rounds x, see ROADMAP.md §3).
    """
    sr = get_semiring(semiring)
    cd = torch.float32 if _check_mixed(sr, dist) else dist.dtype
    single = dist.ndim == 2
    if single:
        dist, u, v, w = dist[None], u[None], v[None], w[None]
        pred = None if pred is None else pred[None]
    g, n, _ = dist.shape
    k = u.shape[-1]
    u, v = u.long(), v.long()
    # x[g, :, i] = d_g[:, u_gi] ⊗ w_gi (n, k); y[g, i, :] = d_g[v_gi, :] (k, n)
    x = sr.mul(torch.gather(dist, 2, u[:, None, :].expand(g, n, k)).to(cd),
               w[:, None, :].to(cd))
    y = torch.gather(dist, 1, v[:, :, None].expand(g, k, n))
    if pred is None:
        z, pz = minplus(x, y, dist, semiring=sr, **block_kw).to(dist.dtype), None
    else:
        z, kstar = minplus_argmin(x, y, dist, semiring=sr, **block_kw)
        z = z.to(dist.dtype)
        ks = kstar.clamp(min=0).long()
        cols = torch.arange(n, device=dist.device)
        p_via = torch.gather(torch.gather(pred, 1, v[:, :, None].expand(g, k, n)), 1, ks)
        v_ks = torch.gather(v[:, None, :].expand(g, n, k), 2, ks)   # v_{k*}
        u_ks = torch.gather(u[:, None, :].expand(g, n, k), 2, ks)   # u_{k*}
        pz = torch.where(v_ks == cols, u_ks.to(pred.dtype), p_via)
        pz = torch.where(kstar < 0, pred, pz)
    if single:
        return z[0], None if pz is None else pz[0]
    return z, pz


def row_restricted_close(
    dist: torch.Tensor,
    rows: torch.Tensor,
    *,
    pred: Optional[torch.Tensor] = None,
    semiring: SemiringLike = "tropical",
    **block_kw,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One row-restricted relaxation pass: ``dist[R, :] ⊕= dist[R, :] ⊗ dist``.

    ``rows`` holds the affected source rows R (int32, repeats allowed: a
    repeated row computes the same panel row, so the write-back does not
    depend on its order).  The panel runs as the ``row_close`` kernel on a
    CUDA tensor and as its plain version on a CPU tensor; bf16 state is
    upcast and the panel rounded once.  With ``pred`` the witness decides
    the panel's predecessors by :func:`pred_from_kstar`'s rule (the
    contraction indexes nodes), the old ones where nothing improved: on a
    CUDA tensor one ``row_close_pred`` launch derives them in its epilogue;
    on a CPU tensor the plain version runs the witness fold and then the
    rule's gathers.

    Returns new full (dist, pred) tensors, as the JAX pass does: clones of
    the inputs with the panel written back (``index_copy_``) after the
    kernel has read the whole state.  (n, n) only.  Tile knobs as
    :func:`minplus`'s, the cache read under the ``rowclose|...`` key
    (``autotune.lookup_row_close``): without a winner the kernel's fill
    rule plans the pass.
    """
    sr = get_semiring(semiring)
    _check_mixed(sr, dist)
    rows = rows.to(device=dist.device, dtype=torch.int32).contiguous()
    b = backend(dist)
    (d,) = _f32(dist)
    if b == "torch":
        if pred is None:
            z, pz = _row_close.row_close_torch(d, rows, semiring=sr)
        else:
            z, pz = _row_close.row_close_pred_torch(d, rows, pred.to(torch.int32).contiguous(),
                                                    semiring=sr)
    else:
        from . import autotune

        if not block_kw:
            block_kw = autotune.lookup_row_close("cuda", dist.dtype, rows.numel(),
                                                 dist.shape[-1], semiring=sr.name)
        kw = autotune.knobs(b, block_kw)
        if pred is None:
            z, pz = _row_close.row_close_cuda(d, rows, semiring=sr, **kw)
        else:
            z, pz = _row_close.row_close_pred_cuda(d, rows, pred.to(torch.int32).contiguous(),
                                                   semiring=sr, **kw)
    idx = rows.long()
    out = dist.clone().index_copy_(0, idx, z.to(dist.dtype))
    return out, None if pz is None else pred.clone().index_copy_(0, idx, pz.to(pred.dtype))


def fw_block(d: torch.Tensor, *, semiring: SemiringLike = "tropical") -> torch.Tensor:
    """Closure of a (B, B) tile or a (T, B, B) stack of tiles; bf16 tiles
    are closed in f32 and rounded once."""
    sr = get_semiring(semiring)
    _check_mixed(sr, d)
    fn = fw_block_torch if backend(d) == "torch" else fw_block_cuda
    return fn(*_f32(d), semiring=sr).to(d.dtype)


def fw_block_pred(
    d: torch.Tensor, p: torch.Tensor, *, semiring: SemiringLike = "tropical"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closure with predecessors (global node ids in ``p``, int32)."""
    sr = get_semiring(semiring)
    _check_mixed(sr, d)
    fn = fw_block_pred_torch if backend(d) == "torch" else fw_block_pred_cuda
    z, pz = fn(*_f32(d), p.contiguous(), semiring=sr)
    return z.to(d.dtype), pz


def fw_round_pred(
    d: torch.Tensor,
    p: torch.Tensor,
    o: int,
    *,
    block_size: int,
    semiring: SemiringLike = "tropical",
    **block_kw,
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
                               j_offset=o, semiring=sr, **block_kw)
    return minplus_pred(colp, d[..., o:o + b, :], pcolp, p[..., o:o + b, :], a=d, pa=p,
                        k_offset=o, j_offset=0, semiring=sr, **block_kw)
