"""Plain torch oracles, ported from ``repro.kernels.ref``.

These are the semantics contracts the port's kernels and plain versions are
held to: ⊕-reduce over the same candidate set (a selective ⊕ is
order-insensitive), witness ties to the smallest k, ``zero`` = "no path"
(K* = -1).  They materialise the (m, k, n) broadcast, so keep them to small
shapes.

Under NaN the argmin oracles follow the JAX package's (a NaN wins the
reduce), while the port's witness folds skip NaN candidates; see
``kernels/minplus.py``.  The tests hold witnesses to these oracles on
NaN-free inputs only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.semiring import SemiringLike, get_semiring

__all__ = [
    "minplus_ref",
    "minplus_argmin_ref",
    "minplus_acc_ref",
    "minplus_acc_argmin_ref",
    "fw_block_ref",
    "fw_block_pred_ref",
]


def minplus_ref(
    x: torch.Tensor, y: torch.Tensor, semiring: SemiringLike = "tropical"
) -> torch.Tensor:
    """Z[i, j] = ⊕_k x[i, k] ⊗ y[k, j] (tropical: min_k x[i,k] + y[k,j])."""
    sr = get_semiring(semiring)
    return sr.reduce(sr.mul(x[:, :, None], y[None, :, :]), dim=1)


def minplus_argmin_ref(
    x: torch.Tensor, y: torch.Tensor, semiring: SemiringLike = "tropical"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Z, K*) with K*[i, j] = the winning k (int32); K* = -1 where Z = zero.
    Ties resolve to the smallest k (``torch.argmin``/``argmax`` convention)."""
    sr = get_semiring(semiring)
    l = sr.mul(x[:, :, None], y[None, :, :])
    z = sr.reduce(l, dim=1)
    kstar = sr.argreduce(l, dim=1).to(torch.int32)
    return z, torch.where(sr.is_zero(z), torch.full_like(kstar, -1), kstar)


def minplus_acc_ref(
    a: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
    semiring: SemiringLike = "tropical",
) -> torch.Tensor:
    """Fused accumulate: Z = A ⊕ (X ⊗ Y) elementwise."""
    sr = get_semiring(semiring)
    return sr.add(a, minplus_ref(x, y, sr))


def minplus_acc_argmin_ref(
    a: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused accumulate with provenance: K* = -1 where A is kept, else the
    winning k.  Strict improvement only (ties keep A)."""
    sr = get_semiring(semiring)
    z, kstar = minplus_argmin_ref(x, y, sr)
    better = sr.better(z, a)
    return torch.where(better, z, a), torch.where(better, kstar, torch.full_like(kstar, -1))


def fw_block_ref(d: torch.Tensor, semiring: SemiringLike = "tropical") -> torch.Tensor:
    """In-block Floyd-Warshall closure: B pivot steps on a (B, B) tile, or
    on each tile of a (T, B, B) stack."""
    sr = get_semiring(semiring)
    for k in range(d.shape[-1]):
        d = sr.add(d, sr.mul(d[..., :, k:k + 1], d[..., k:k + 1, :]))
    return d


def fw_block_pred_ref(
    d: torch.Tensor, p: torch.Tensor, semiring: SemiringLike = "tropical"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-block FW closure with predecessors, on a (B, B) tile or a (T, B, B)
    stack: on strict improvement through pivot k, pred[i, j] <- pred[k, j].
    ``p`` holds global node ids (the caller offsets them).  Each step reads
    the old row and column k, so a pivot that is not the semiring one (a
    tropical negative cycle) is handled as in the JAX package."""
    sr = get_semiring(semiring)
    for k in range(d.shape[-1]):
        via = sr.mul(d[..., :, k:k + 1], d[..., k:k + 1, :])
        better = sr.better(via, d)
        d = torch.where(better, via, d)
        p = torch.where(better, p[..., k:k + 1, :].expand_as(p), p)
    return d, p
