"""R-Kleene [D'Alberto & Nicolau 2006] — divide-and-conquer APSP (paper
§3.3), ported from ``repro.core.rkleene``.

Split D = [[A, B], [C, D]] (A: first half <-> first half, etc.) and:

    A <- rkleene(A)                 # close the first half
    B <- A (x) B ;  C <- C (x) A    # route through the closed first half
    D <- D (+) C (x) B              # first-half detours between 2nd-half nodes
    D <- rkleene(D)                 # close the second half
    B <- B (x) D ;  C <- D (x) C    # allow wandering inside the second half
    A <- A (+) B (x) C              # second-half detours between 1st-half nodes

(x) = the semiring ⊗-product, (+) = elementwise ⊕.  Every quadrant product
is one ``kernels.ops.minplus`` call (the two (+) steps fused as its
accumulate) and every leaf of ``base`` nodes one ``closure_block`` (the
``fw_block`` kernel on a CUDA tensor); with predecessors ``minplus_pred``
with the quadrants' ``k_offset`` / ``j_offset`` and ``fw_block_pred``.

The quadrants are views of the level's input, and every product writes a
new tensor, as in JAX: no step reads a value another step of the level has
written in place.  Each level assembles its four results with ``torch.cat``.

Padding/split rule, kept exactly: distance-only solves pad to the next
multiple of ``base`` and split each level at half rounded up to a multiple
of ``base`` (``split_point``); predecessor solves keep the pow-2 pad and
equal halving, the grid whose witnesses nest as a prefix of any larger
pow-2 solve (what makes a batched pred solve bit-equal to the per-graph
one).  Distances do not depend on the structure (inert phantom padding).

Divergence from the JAX package — donation.  ``donate=`` is accepted and
has no effect: torch cannot delete a buffer, and the solve never writes
its input.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .blocked_fw import _closure_block_pred, closure_block
from .floyd_warshall import init_pred
from .semiring import TROPICAL, Semiring, SemiringLike, get_semiring, unpad

__all__ = ["rkleene", "split_point", "padded_size", "pow2_size"]


def _ops():
    from repro_torch.kernels import ops  # lazy: the kernels import core

    return ops


def padded_size(n: int, base: int) -> int:
    """Padded matrix edge: next multiple of ``base`` (>= base)."""
    return max(-(-n // base) * base, base)


def split_point(n: int, base: int) -> int:
    """First-half size at one recursion level: half of n rounded *up* to a
    multiple of ``base`` (n is a base multiple after padding)."""
    return base * ((n // base + 1) // 2)


def pow2_size(n: int, base: int) -> int:
    """Legacy pow-2 padded edge (pred solves: canonical witness grid)."""
    target = base
    while target < n:
        target *= 2
    return target


def _pad_base(d: torch.Tensor, target: int, fill, diag) -> torch.Tensor:
    """``d`` padded to (target, target): ``fill`` off the phantom diagonal,
    ``diag`` (a value, or the phantom ids when None) on it."""
    n = d.shape[0]
    if target == n:
        return d
    out = torch.full((target, target), fill, dtype=d.dtype, device=d.device)
    out[:n, :n] = d
    idx = torch.arange(n, target, device=d.device)
    if diag is None:
        out[idx, idx] = idx.to(d.dtype)
    else:
        out[idx, idx] = torch.tensor(diag, dtype=d.dtype, device=d.device)  # lint: allow-copy  0-d
    return out


def _block(a, b, c, dd) -> torch.Tensor:
    return torch.cat([torch.cat([a, b], dim=1), torch.cat([c, dd], dim=1)], dim=0)


def _rk(d: torch.Tensor, base: int, sr: Semiring) -> torch.Tensor:
    ops = _ops()
    n = d.shape[0]
    if n <= base:
        return closure_block(d, sr)
    m = split_point(n, base)
    a, b = d[:m, :m], d[:m, m:]
    c, dd = d[m:, :m], d[m:, m:]

    a = _rk(a, base, sr)
    b = ops.minplus(a, b, semiring=sr)
    c = ops.minplus(c, a, semiring=sr)
    dd = ops.minplus(c, b, dd, semiring=sr)    # fused D <- D (+) C (x) B
    dd = _rk(dd, base, sr)
    b = ops.minplus(b, dd, semiring=sr)
    c = ops.minplus(dd, c, semiring=sr)
    a = ops.minplus(b, c, a, semiring=sr)      # fused A <- A (+) B (x) C
    return _block(a, b, c, dd)


def _rk_pred(d, p, base: int, off: int, sr: Semiring):
    """R-Kleene with predecessors. ``off`` = global id of this block's node 0."""
    ops = _ops()
    n = d.shape[0]
    if n <= base:
        return _closure_block_pred(d, p, sr)
    m = n // 2          # pow-2 canonical halving (see module docstring)
    a, b = d[:m, :m], d[:m, m:]
    c, dd = d[m:, :m], d[m:, m:]
    pa, pb = p[:m, :m], p[:m, m:]
    pc, pd = p[m:, :m], p[m:, m:]
    o1, o2 = off, off + m

    def upd(x, y, px, py, ko, jo, zold, pold):
        # fused strict-improvement accumulate + pred propagation
        return ops.minplus_pred(x, y, px, py, a=zold, pa=pold, k_offset=ko, j_offset=jo,
                                semiring=sr)

    a, pa = _rk_pred(a, pa, base, o1, sr)
    b, pb = upd(a, b, pa, pb, o1, o2, b, pb)
    c, pc = upd(c, a, pc, pa, o1, o1, c, pc)
    dd, pd = upd(c, b, pc, pb, o1, o2, dd, pd)
    dd, pd = _rk_pred(dd, pd, base, o2, sr)
    b, pb = upd(b, dd, pb, pd, o2, o2, b, pb)
    c, pc = upd(dd, c, pd, pc, o2, o1, c, pc)
    a, pa = upd(b, c, pb, pc, o2, o1, a, pa)
    return _block(a, b, c, dd), _block(pa, pb, pc, pd)


def rkleene(
    h: torch.Tensor,
    *,
    base: int = 64,
    with_pred: bool = False,
    semiring: SemiringLike = TROPICAL,
    donate: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """R-Kleene APSP on an (n, n) cost tensor, on its device.  ``base`` is
    the leaf size closed with in-block FW; ``donate`` is accepted and has
    no effect (module docstring).  Returns ``(dist, pred)``, ``pred`` an
    int32 tensor when ``with_pred``, else None."""
    del donate
    sr = get_semiring(semiring)
    n = h.shape[0]
    if not with_pred:
        d = _pad_base(h, padded_size(n, base), sr.zero, sr.one)
        return unpad(_rk(d, base, sr), n), None
    target = pow2_size(n, base)
    d = _pad_base(h, target, sr.zero, sr.one)
    p = _pad_base(init_pred(h, sr), target, -1, None)
    z, pz = _rk_pred(d, p, base, 0, sr)
    return unpad(z, n), unpad(pz, n)
