"""Path reconstruction from predecessor matrices, ported from
``repro.core.paths``.

``pred[i, j]`` is the last node before j on a best i -> j path.
Reconstruction walks backwards from j.  Two implementations:

* :func:`reconstruct_path` — a host walk over a numpy array or tensor,
  variable length.
* :func:`reconstruct_path_device` — the counterpart of
  ``reconstruct_path_jit``: a fixed number of masked steps on ``pred``'s
  device with no host sync, returning a path padded with -1 and its length.
  :func:`reconstruct_path_jit` is the same function under the reference's
  name.

:func:`path_cost` and :func:`validate_tree` check a solve on the host.
:func:`spd_features` turns the tropical product into landmark
shortest-path features for the GNN stack.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .semiring import SemiringLike, get_semiring

__all__ = [
    "reconstruct_path",
    "reconstruct_path_device",
    "reconstruct_path_jit",
    "path_cost",
    "validate_tree",
    "spd_features",
]


def _host(a) -> np.ndarray:
    """A host array of a tensor (bf16 as float32) or array."""
    if isinstance(a, torch.Tensor):
        # The engine's host copy of an update's ids and weights (JAX: np.asarray).
        a = a.detach().cpu()  # repro: allow-host-sync  host bookkeeping
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.numpy()  # repro: allow-host-sync  host bookkeeping
    return np.asarray(a)


def reconstruct_path(pred, i: int, j: int) -> Optional[List[int]]:
    """Walk pred backwards from j.  Returns [i, ..., j], or None if j is
    unreachable from i (or the walk does not reach i within n + 1 hops)."""
    if i == j:
        return [i]
    row = _host(pred[i])
    if row[j] < 0:
        return None
    path = [j]
    guard = row.shape[0] + 1
    cur = j
    while cur != i:
        cur = int(row[cur])
        if cur < 0 or len(path) > guard:
            return None
        path.append(cur)
    return path[::-1]


def reconstruct_path_device(
    pred: torch.Tensor, i: int, j: int, *, max_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(path, length) on ``pred``'s device: ``path`` holds the nodes i ... j
    padded with -1 to ``max_len``; ``length`` is 0 when j is unreachable or
    the path has more than ``max_len`` nodes.

    Runs ``max_len`` masked steps (a few small launches each), so keep
    ``max_len`` near the longest path wanted.  ``reconstruct_path_jit``
    returns length ``max_len + 1`` and a wrong path when the path has
    exactly ``max_len + 1`` nodes; this counterpart returns length 0 there,
    as its contract says."""
    dev = pred.device
    row = pred[i].long()
    start = torch.tensor(i, device=dev)   # lint: allow-copy  0-d node id
    cur = torch.tensor(j, device=dev)     # lint: allow-copy  0-d node id
    hops = torch.zeros((), dtype=torch.long, device=dev)
    back = torch.full((max_len,), -1, dtype=torch.long, device=dev)   # j, pred(j), ...
    for s in range(max_len):
        live = (cur != start) & (cur >= 0)
        back[s] = torch.where(live, cur, back[s])
        hops = hops + live.long()
        cur = torch.where(live, row[cur.clamp(min=0)], cur)
    ok = (cur == start) & (hops < max_len)
    length = torch.where(ok, hops + 1, torch.zeros_like(hops))
    idx = torch.arange(max_len, device=dev)
    walk = back[(hops - idx).clamp(0, max_len - 1)]
    path = torch.where(idx == 0, start, walk)
    path = torch.where(idx < length, path, torch.full_like(path, -1))
    return path.to(torch.int32), length.to(torch.int32)


def reconstruct_path_jit(
    pred: torch.Tensor, i: int, j: int, *, max_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``repro.core.reconstruct_path_jit`` under its own name: (path, length)
    on ``pred``'s device, path padded with -1 to ``max_len``, length 0 when
    j is unreachable.  It runs :func:`reconstruct_path_device`.

    Divergence by design: for a path of exactly ``max_len + 1`` nodes the
    reference returns length ``max_len + 1`` and a path without its source;
    this one returns length 0, as the contract says (ROADMAP.md §3)."""
    return reconstruct_path_device(pred, i, j, max_len=max_len)


_NP_MUL = {torch.add: np.add, torch.minimum: np.minimum, torch.maximum: np.maximum,
           torch.mul: np.multiply}


def _np_mul(semiring: SemiringLike):
    """Host-side ⊗ for a semiring, keyed on the instance's own ``mul``."""
    sr = get_semiring(semiring)
    mul = _NP_MUL.get(sr.mul)
    if mul is None:   # a custom ⊗ with no numpy twin: the torch op on host arrays
        mul = lambda a, b: sr.mul(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    return sr, mul


def path_cost(h, path: List[int], semiring: SemiringLike = "tropical") -> float:
    """⊗-accumulated cost along an explicit path (tropical: the sum of its
    edges).  The empty path (i == j) costs the semiring one."""
    sr, mul = _np_mul(semiring)
    h = _host(h)
    cost = sr.one
    for a, b in zip(path[:-1], path[1:]):
        cost = mul(cost, h[a, b])
    return float(cost)


def validate_tree(h, dist, pred, semiring: SemiringLike = "tropical") -> bool:
    """Invariant: every reachable dist[i, j] (i != j) is witnessed by pred:
    one hop back, dist[i, j] == dist[i, pred[i, j]] ⊗ h[pred[i, j], j]."""
    sr, mul = _np_mul(semiring)
    h, dist, pred = _host(h), _host(dist), _host(pred)
    n = h.shape[0]
    reach = (dist != sr.zero) & ~np.eye(n, dtype=bool)
    ii, jj = np.nonzero(reach)
    p = pred[ii, jj]
    if np.any(p < 0):
        return False
    lhs = dist[ii, jj]
    rhs = mul(dist[ii, p], h[p, jj])
    return bool(np.allclose(lhs, rhs, rtol=1e-5, atol=1e-5))


def spd_features(h: torch.Tensor, landmarks, *, cap: float = 1e4) -> torch.Tensor:
    """Landmark SPD node features via the tropical solver.

    Iterates the fused one-hop min-plus relaxation ``d <- d ⊕ d ⊗ h`` over
    the landmark rows only (``d`` starts as ``h[landmarks]``), to a fixpoint
    or ``n - 1`` hops, whichever comes first, as the JAX ``while_loop``
    does: cost O(L * n^2 * D), D the shortest-path hop diameter.  Each
    hop is one ``kernels.ops.minplus`` call in accumulate mode (on a CUDA
    ``h``, one launch of the ``minplus`` kernel).  Returns the (n, L)
    feature matrix ``min(d, cap).T``.

    ``landmarks`` may be a sequence, a numpy array or a tensor on any
    device.  Divergence by design: the JAX loop tests ``any(z < d)`` on
    the device; here the host reads it after every hop (one sync a hop).
    The hop cap stays exactly ``n - 1``, so with a negative cycle the
    answer is the reference's.  On the card ``h``'s rows are made ready
    for the kernel's ring once (``ring_rows``), not once a hop.

    Landmark ids are checked on the host before any indexing: ids in
    ``[-n, n)`` are read as numpy reads them (negatives wrap), and any
    other id raises ``IndexError`` on both devices before anything touches
    the card.  Divergence by design: the JAX function clamps such an id
    to the nearest node.
    """
    from repro_torch.kernels import ops

    n = h.shape[0]
    # The ids are checked on the host before any indexing (ROADMAP: out-of-range
    # ids raise where JAX clamps): one read of L ids a call, not a hop.
    if isinstance(landmarks, torch.Tensor):
        landmarks = landmarks.detach().cpu()  # repro: allow-host-sync  landmark ids
    else:
        landmarks = torch.from_numpy(np.asarray(landmarks))  # repro: allow-host-sync  ids
    lm = landmarks.to(dtype=torch.long)
    if bool(((lm < -n) | (lm >= n)).any()):  # repro: allow-host-sync  landmark range check
        raise IndexError(f"spd_features: a landmark id lies outside [{-n}, {n})")
    lm = torch.where(lm < 0, lm + n, lm).to(h.device)
    d = h[lm].contiguous()                   # (L, n) 1-hop seed distances
    y = h
    if h.is_cuda:
        from repro_torch.kernels.minplus import ring_rows

        y = ring_rows(h)
    for _ in range(n - 1):
        z = ops.minplus(d, y, d)             # fused relax step (one more hop)
        changed = bool((z < d).any())  # repro: allow-host-sync  one read a hop (JAX: :151)
        d = z
        if not changed:
            break
    top = torch.tensor(cap, dtype=d.dtype, device=d.device)   # lint: allow-copy  0-d cap
    return torch.minimum(d, top).T  # lint: allow-unfused  # repro: allow-semiring-hardcode tropical-only SPD feature cap
