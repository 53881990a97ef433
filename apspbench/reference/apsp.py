"""Shortest paths in plain PyTorch, for the tropical semiring with
positive edge costs.

The graph is held by its in-edges (:func:`in_edges`): for each node j, the
nodes k with an edge k -> j and its cost, padded to the largest in-degree
with cost inf.  One relaxation (:func:`relax`) is then
``out[r, j] = min_k D[r, k] + h[k, j]`` over those edges, in row blocks
that bound the memory.

Two comparisons rest on it:

* :func:`sssp_rows`: Bellman-Ford from given sources to its fixpoint, the
  exact rows of the all-pairs answer (every sum of integer costs below 2^24
  is exact in float32).
* :func:`bellman_off`: with every cost >= 1, a matrix D is the all-pairs
  answer exactly when ``D[i, i] = 0`` and ``D[i, j] = min_k D[i, k] +
  h[k, j]`` for every j != i (the Bellman equations have one solution
  when every cycle is positive), so the entries that break them count the
  wrong answers of a whole matrix without solving it again.

:func:`pred_off` counts predecessors that do not witness their distance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

INF = float("inf")
# elements of one relaxation block (4 bytes each): 512 MiB of gathered candidates
BLOCK_ELEMS = 1 << 27


def in_edges(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, W), each (n, m): the sources and costs of the edges into each
    node, m the largest in-degree, padded with (0, inf).  The diagonal and
    inf entries of the cost matrix ``h`` are no edges."""
    n = h.shape[-1]
    edge = torch.isfinite(h)
    edge.fill_diagonal_(False)
    jk = torch.nonzero(edge.T)                      # (E, 2): j, k, sorted by j
    j, k = jk[:, 0], jk[:, 1]
    deg = torch.bincount(j, minlength=n)
    m = max(1, int(deg.max()) if j.numel() else 1)
    start = torch.cumsum(deg, 0) - deg
    pos = torch.arange(j.numel(), device=h.device) - start[j]
    K = torch.zeros((n, m), dtype=torch.long, device=h.device)
    W = torch.full((n, m), INF, dtype=torch.float32, device=h.device)
    K[j, pos] = k
    W[j, pos] = h[k, j].float()
    return K, W


def relax(D: torch.Tensor, K: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``out[r, j] = min_m D[r, K[j, m]] + W[j, m]`` for the rows of D
    (float32)."""
    rows, n = D.shape
    m = K.shape[1]
    out = torch.empty((rows, n), dtype=torch.float32, device=D.device)
    flat = K.reshape(-1)
    step = max(1, BLOCK_ELEMS // (n * m))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        cand = D[r0:r1].float().index_select(1, flat).view(r1 - r0, n, m)
        out[r0:r1] = cand.add_(W).amin(dim=2)
    return out


def sssp_rows(h: torch.Tensor, sources: torch.Tensor,
              edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """The exact rows ``sources`` of the all-pairs answer of ``h``: the
    distances from each source, by Bellman-Ford to its fixpoint."""
    K, W = in_edges(h) if edges is None else edges
    n = h.shape[-1]
    src = sources.to(device=h.device, dtype=torch.long)
    d = torch.full((src.numel(), n), INF, dtype=torch.float32, device=h.device)
    d[torch.arange(src.numel(), device=h.device), src] = 0.0
    for _ in range(n):
        nxt = torch.minimum(d, relax(d, K, W))
        if torch.equal(nxt, d):
            break
        d = nxt
    return d


def bellman_off(D: torch.Tensor, h: torch.Tensor, rows: Optional[torch.Tensor] = None,
                edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> int:
    """Entries of D (the rows ``rows`` of an answer; all rows by default)
    that break the Bellman equations of ``h``: a NaN, a diagonal entry other
    than 0, or any other entry unequal to its best one-edge extension."""
    K, W = in_edges(h) if edges is None else edges
    n = h.shape[-1]
    ids = torch.arange(D.shape[0], device=D.device) if rows is None else rows.to(D.device).long()
    want = relax(D, K, W)
    at = torch.arange(ids.numel(), device=D.device)
    want[at, ids] = 0.0
    return int((D.float() != want).sum())


def pred_off(D: torch.Tensor, P: torch.Tensor, h: torch.Tensor,
             rows: Optional[torch.Tensor] = None) -> int:
    """Predecessors that do not witness their distance, for the rows
    ``rows`` of D and P (all rows by default): on the diagonal P must name
    the node itself, where D is inf it must be -1, and elsewhere it must
    name a node p with ``D[r, p] + h[p, j] == D[r, j]``."""
    n = h.shape[-1]
    ids = torch.arange(D.shape[0], device=D.device) if rows is None else rows.to(D.device).long()
    cols = torch.arange(n, device=D.device)
    off = 0
    step = max(1, BLOCK_ELEMS // (4 * n))
    for r0 in range(0, D.shape[0], step):
        r1 = min(D.shape[0], r0 + step)
        d = D[r0:r1].float()
        p = P[r0:r1].long()
        me = ids[r0:r1, None]
        diag = cols[None, :] == me
        reach = torch.isfinite(d) & ~diag
        pc = p.clamp(0, n - 1)
        via = d.gather(1, pc) + h[pc, cols[None, :]].float()
        good = (diag & (p == me)) | (~diag & ~torch.isfinite(d) & (p == -1)) \
            | (reach & (p >= 0) & (p < n) & (via == d))
        off += int((~good).sum())
    return off
