"""APSP front end, ported from ``repro.core.apsp``.

``solve(h, method=...)`` dispatches one dense cost matrix to a registered
solver:

* ``"squaring"``    — the paper's FW-GPU (tropical matrix squaring, on the
                      ``minplus`` / ``minplus_pred`` kernels)
* ``"squaring_3d"`` — the same over the paper's N×N×N broadcast tensor
                      (plain torch ops, memory-faithful)
* ``"classic"``     — textbook O(n^3) Floyd-Warshall (plain torch ops)
* ``"blocked_fw"``  — blocked FW, fused or split rounds (``fw_round``, or
                      ``fw_block`` and ``minplus``; their pred twins)
* ``"rkleene"``     — R-Kleene divide and conquer (paper §3.3; ``minplus``
                      and ``fw_block``, or their pred twins)

``solve_batch(hs, method=...)`` is the multi-graph engine: it takes a
(G, N, N) stack or a ragged list of per-graph matrices, pads them to a
common edge with inert phantom nodes, and runs a batched solver: one launch
a step for the whole batch.  ``squaring``, ``squaring_3d``, ``classic`` and
``blocked_fw`` are batched natively; any other method runs per padded
slice, which is what ``jax.vmap`` computes in the JAX package (so
R-Kleene's pow-2 pred grid is the same).  ``bucket_by_size=True`` groups a
ragged batch by power-of-two edge.  Results equal per-graph ``solve``.

Input conventions per semiring: off-diagonal "no edge" entries are the
semiring zero, the diagonal is the semiring one (tropical: inf / 0).

Both entry points run on the card (``device="cuda"``, the default) unless
the caller passes another device, as the CPU tests pass ``device="cpu"``.
On a host without CUDA a call that names no device raises: it never falls
back to the CPU.

A running ``torch.profiler`` records each call's phases as ``repro_torch.*``
spans (``repro_torch._spans``): the call, ``validate``, ``bucket``, ``pad``,
``dispatch`` (the solver), ``scatter`` and ``check``, once a call or a bucket.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .._spans import span
from .blocked_fw import blocked_fw
from .errors import InputValidationError, NegativeCycleError
from .floyd_warshall import fw_classic, fw_squaring
from .rkleene import rkleene
from .semiring import TROPICAL, Semiring, SemiringLike, default_device, get_semiring

__all__ = [
    "APSPResult",
    "BatchAPSPResult",
    "solve",
    "solve_batch",
    "pad_batch",
    "METHODS",
    "BATCH_METHODS",
    "register_method",
    "validate_cost_matrix",
    "check_negative_cycles",
    "next_pow2",
]


def validate_cost_matrix(h, semiring: SemiringLike = "tropical") -> None:
    """Input-boundary contract check: NaN entries are rejected with a typed
    :class:`~repro_torch.core.errors.InputValidationError` before any
    dispatch — a NaN is absorbing under every registered ⊕/⊗ pair, so one
    poisoned entry silently corrupts the whole closure.  Takes an (n, n)
    matrix or a (G, n, n) stack, a tensor or a host array, and checks it
    where it lies.  Syncs the device; pass ``validate=False`` to ``solve``
    on paths that guarantee clean inputs."""
    with span("repro_torch.validate"):
        _reject_nan(h, semiring)


def _reject_nan(h, semiring: SemiringLike) -> None:
    bad = torch.isnan(torch.as_tensor(h))
    count = int(bad.sum())  # repro: allow-host-sync  NaN check before dispatch (JAX: apsp.py:86)
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


def check_negative_cycles(
    dist: torch.Tensor, semiring: Semiring, sizes: Optional[np.ndarray] = None
) -> None:
    """Tropical-only post-solve contract check: a strictly negative entry on
    the solved diagonal means the graph contains a negative cycle, so
    shortest-path distances are unbounded below — raise
    :class:`~repro_torch.core.errors.NegativeCycleError` instead of
    returning them.  Negative edges are fine; only a closed negative walk
    drives ``dist[i, i]`` below 0.  Takes (n, n) or (G, n, n); ``sizes``
    restricts each graph's check to its true block."""
    if semiring.name != "tropical":
        return
    with span("repro_torch.check"):
        diag = torch.diagonal(dist, dim1=-2, dim2=-1)
        neg = diag < 0
        if sizes is not None:
            live = torch.arange(diag.shape[-1], device=diag.device)[None, :] < torch.as_tensor(
                np.asarray(sizes), device=diag.device)[:, None]
            neg = neg & live
        if bool(neg.any()):  # repro: allow-host-sync  the post-solve contract (JAX: apsp.py:118)
            idx = tuple(int(x) for x in torch.nonzero(neg)[0])
            worst = float(diag[neg].min())  # repro: allow-host-sync  the message, on the raise path
            raise NegativeCycleError(
                f"negative cycle detected: solved diagonal entry {idx} is "
                f"{worst:g} < 0, so tropical distances are unbounded "
                "below.  Remove the cycle or pass validate=False to skip this "
                "check (the returned matrix would be meaningless)."
            )


@dataclass
class APSPResult:
    dist: torch.Tensor
    pred: Optional[torch.Tensor]
    method: str


@dataclass
class BatchAPSPResult:
    """Batched APSP result over G graphs padded to a common edge N.

    ``dist``/``pred`` are (G, N, N) tensors on the solve's device;
    ``sizes[i]`` is graph i's true node count — entries at index >= sizes[i]
    are padding (zero off-diagonal / one diagonal distances, -1 / identity
    predecessors).
    """

    dist: torch.Tensor               # (G, N, N)
    pred: Optional[torch.Tensor]     # (G, N, N) or None
    sizes: np.ndarray                # (G,) true node counts
    method: str

    def __len__(self) -> int:
        return int(self.dist.shape[0])

    def unpadded(self, i: int) -> APSPResult:
        """Graph i's result with the padding sliced off."""
        n = int(self.sizes[i])
        return APSPResult(
            dist=self.dist[i, :n, :n],
            pred=None if self.pred is None else self.pred[i, :n, :n],
            method=self.method,
        )


def _squaring(h, with_pred, semiring=TROPICAL, **kw):
    return fw_squaring(h, with_pred=with_pred, semiring=semiring)


def _squaring_3d(h, with_pred, semiring=TROPICAL, **kw):
    return fw_squaring(h, with_pred=with_pred, use_3d=True, semiring=semiring)


def _classic(h, with_pred, semiring=TROPICAL, **kw):
    return fw_classic(h, with_pred=with_pred, semiring=semiring)


def _blocked(h, with_pred, block_size=None, semiring=TROPICAL, donate=False,
             round_mode=None, **kw):
    return blocked_fw(
        h, block_size=block_size, with_pred=with_pred, semiring=semiring,
        round_mode=round_mode, donate=donate,
    )


def _rkleene(h, with_pred, base=64, semiring=TROPICAL, donate=False, **kw):
    return rkleene(h, base=base, with_pred=with_pred, semiring=semiring, donate=donate)


METHODS: Dict[str, Callable] = {
    "squaring": _squaring,
    "squaring_3d": _squaring_3d,
    "classic": _classic,
    "blocked_fw": _blocked,
    "rkleene": _rkleene,
}


# The single-graph solvers take a (G, N, N) stack as it is (every launch
# carries the batch), so they are the batch solvers too.
BATCH_METHODS: Dict[str, Callable] = {
    "squaring": _squaring,
    "squaring_3d": _squaring_3d,
    "classic": _classic,
    "blocked_fw": _blocked,
}


def register_method(name: str, fn: Callable, batch_fn: Optional[Callable] = None) -> None:
    """Register a solver.  ``fn(h, with_pred, **kw) -> (dist, pred)``
    handles one graph; ``batch_fn(hs, with_pred, **kw)``, if given, handles
    a (G, N, N) stack (otherwise ``solve_batch`` runs ``fn`` on each padded
    slice)."""
    METHODS[name] = fn
    if batch_fn is not None:
        BATCH_METHODS[name] = batch_fn
    else:
        # don't leave a stale batched solver behind a re-registered name
        BATCH_METHODS.pop(name, None)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown APSP method {method!r}; have {sorted(METHODS)}")


def _fresh(x: torch.Tensor, h) -> bool:
    """Whether ``x`` is a copy this call made of ``h``, which the solve may
    overwrite: not ``h`` itself nor its memory (``torch.as_tensor`` of a
    float32 numpy array on the CPU shares the array's)."""
    if x is h:
        return False
    if isinstance(h, torch.Tensor):
        return x.untyped_storage().data_ptr() != h.untyped_storage().data_ptr()
    if isinstance(h, np.ndarray) and x.device.type == "cpu":
        base = h.__array_interface__["data"][0]
        return not base <= x.data_ptr() < base + max(h.nbytes, 1)
    return True


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
    never does.  Only ``blocked_fw`` overwrites its input; the other
    methods write new tensors.

    ``dtype``: storage dtype (default float32).  ``torch.bfloat16`` selects
    the mixed-precision mode — bf16 state with f32 arithmetic, tropical
    only.

    ``validate`` (default True): reject NaN input entries with a typed
    ``InputValidationError`` before dispatch, and (tropical only) raise
    ``NegativeCycleError`` when the solved diagonal goes negative.
    """
    with span("repro_torch.solve"):
        _check_method(method)
        device = default_device(device)
        sr = get_semiring(semiring)
        target = torch.float32 if dtype is None else dtype
        x = torch.as_tensor(h, dtype=target, device=device)
        if validate:
            validate_cost_matrix(x, sr)
        if donate is None:
            donate = _fresh(x, h)             # fresh copy -> safe to overwrite
        with span("repro_torch.dispatch"):
            dist, pred = METHODS[method](x, with_pred, semiring=sr, donate=donate, **kwargs)
        if validate:
            check_negative_cycles(dist, sr)
        return APSPResult(dist=dist, pred=pred, method=method)


def next_pow2(x: int, floor: int = 1) -> int:
    """Smallest power-of-two >= x, with a floor — the shared bucketing rule
    (batch edges here, update-batch widths and affected-row lists in
    ``core.dynamic``)."""
    e = floor
    while e < x:
        e *= 2
    return e


def _is_stack(hs) -> bool:
    return getattr(hs, "ndim", None) == 3


def pad_batch(
    hs: Union[torch.Tensor, np.ndarray, Sequence],
    sizes: Optional[Sequence[int]] = None,
    *,
    n_max: Optional[int] = None,
    semiring: SemiringLike = "tropical",
    device=None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Pack graphs into a padded float32 (G, N, N) stack on ``device`` (the
    card unless given) and a true-size vector.

    Accepts a ragged list of (n_i, n_i) cost matrices (tensors or host
    arrays) or an already-stacked (G, N, N) array (with optional ``sizes``;
    N for every graph by default).  ``n_max`` forces the padded edge (>=
    the largest graph).  Padding is a phantom node: semiring zero
    off-diagonal, semiring one self-loop — inert under every registered
    semiring.

    A pre-stacked input with ``sizes[i] < N`` is not trusted: only the true
    (sizes[i], sizes[i]) block is kept and the padding region is
    re-inertized (garbage there, e.g. 0.0 off-diagonal under tropical,
    would be free phantom-node shortcuts).  A full-size float32 stack on
    ``device`` comes back as itself.
    """
    with span("repro_torch.pad"):
        sr = get_semiring(semiring)
        device = default_device(device)
        if _is_stack(hs):
            g, n, _ = hs.shape
            sizes = np.full(g, n) if sizes is None else np.asarray(sizes, np.int64)
            if int(sizes.max(initial=0)) > n:
                raise ValueError(f"sizes {sizes.max()} larger than stack edge {n}")
            if bool((sizes == n).all()) and (n_max is None or n_max == n):
                return torch.as_tensor(hs, dtype=torch.float32, device=device), sizes
            # keep only each graph's true block; repack with inert padding below
            mats = [hs[i][: int(k), : int(k)] for i, k in enumerate(sizes)]
            if n_max is None:
                n_max = n                        # preserve the stack's edge
        else:
            mats = list(hs)
            if sizes is None:
                sizes = np.array([m.shape[0] for m in mats], np.int64)
            else:
                sizes = np.asarray(sizes, np.int64)
        if not mats:
            raise ValueError("empty graph batch")
        n = int(max(m.shape[0] for m in mats)) if n_max is None else int(n_max)
        if any(m.shape[0] > n for m in mats):
            raise ValueError(f"n_max={n} smaller than largest graph")
        # The fresh padded stack, one copy (JAX: np.full, apsp.py:338).
        out = sr.eye(n, torch.float32, device).expand(len(mats), n, n).clone()  # lint: allow-copy  stack
        for i, m in enumerate(mats):
            k = m.shape[0]
            if k:
                out[i, :k, :k] = torch.as_tensor(m, dtype=torch.float32)
        return out, sizes


def _solve_stack(stack, with_pred, method, semiring=TROPICAL, donate=False, **kwargs):
    """Run one (G, N, N) padded stack through the batched solver, or, for a
    method without one, through its solver slice by padded slice (what
    ``jax.vmap`` computes; donation stops there, as in JAX)."""
    batch_fn = BATCH_METHODS.get(method)
    if batch_fn is not None:
        return batch_fn(stack, with_pred, semiring=semiring, donate=donate, **kwargs)
    out = [METHODS[method](h, with_pred, semiring=semiring, **kwargs) for h in stack]
    dist = torch.stack([d for d, _ in out])
    return dist, torch.stack([p for _, p in out]) if with_pred else None


def _bucket_edge(n: int) -> int:
    """Padded edge for a size-n graph: next power of two, floor 8."""
    return next_pow2(n, 8)


def _bucket_count(c: int) -> int:
    """Padded slot count for a c-graph bucket: next power of two up to 8,
    then next multiple of 8 — keeps the set of (count, edge) shapes small
    and reused across serving cycles."""
    if c <= 8:
        return next_pow2(c)
    return -(-c // 8) * 8


def _solve_bucketed(
    hs, sizes: Optional[Sequence[int]], n_max: Optional[int], method: str, with_pred: bool,
    semiring=TROPICAL, donate=True, dtype=None, device=None, **kwargs
) -> Tuple[torch.Tensor, Optional[torch.Tensor], np.ndarray]:
    """Size-bucketed batched solve: graphs grouped by power-of-two padded
    edge, one batched solve a bucket, results scattered back into the
    common (G, n, n) frame, which is built on the solve's device.
    Bit-identical to the single-stack path — padding is inert either way —
    but a ragged corpus does ~size^3 work per graph instead of n_max^3.
    Per-bucket stacks are fresh, so they donate unless the caller opted
    out; ``dtype`` casts each bucket's stack and the result frame.  Returns
    the frame's distances and predecessors and the true sizes."""
    with span("repro_torch.bucket"):
        if _is_stack(hs):
            sizes = (np.full(hs.shape[0], hs.shape[1], np.int64)
                     if sizes is None else np.asarray(sizes, np.int64))
            mats = [h[:k, :k] for h, k in zip(hs, sizes)]
        else:
            mats = list(hs)
            sizes = (np.array([m.shape[0] for m in mats], np.int64)
                     if sizes is None else np.asarray(sizes, np.int64))
        if not mats:
            raise ValueError("empty graph batch")
        n = int(max(sizes.max(), 1)) if n_max is None else int(n_max)
        if int(sizes.max()) > n:
            raise ValueError(f"n_max={n} smaller than largest graph")
        g = len(mats)
        out_dtype = torch.float32 if dtype is None else dtype
        # The result frame of the buckets (JAX: np.full, apsp.py:397).
        dist = semiring.eye(n, out_dtype, device).expand(g, n, n).clone()  # lint: allow-copy  frame
        pred = None
        if with_pred:
            idx = torch.arange(n, dtype=torch.int32, device=device)
            pred = torch.full((g, n, n), -1, dtype=torch.int32, device=device)
            pred[:, idx, idx] = idx

        buckets: Dict[int, List[int]] = {}
        for i, k in enumerate(sizes):
            buckets.setdefault(_bucket_edge(int(k)), []).append(i)

    for edge, members in sorted(buckets.items()):
        slots = _bucket_count(len(members))
        sub = [mats[i] for i in members]
        sub += [np.zeros((0, 0), np.float32)] * (slots - len(members))
        stack, _ = pad_batch(sub, n_max=edge, semiring=semiring, device=device)
        if dtype is not None:
            stack = stack.to(dtype)
        # pad_batch built a fresh stack -> safe to donate per bucket
        with span("repro_torch.dispatch"):
            d, p = _solve_stack(stack, with_pred, method, semiring=semiring, donate=donate,
                                **kwargs)
        with span("repro_torch.scatter"):
            for j, i in enumerate(members):
                k = int(sizes[i])
                dist[i, :k, :k] = d[j, :k, :k]
                if with_pred:
                    pred[i, :k, :k] = p[j, :k, :k]
    return dist, pred, sizes


def solve_batch(
    hs: Union[torch.Tensor, np.ndarray, Sequence],
    sizes: Optional[Sequence[int]] = None,
    *,
    method: str = "blocked_fw",
    with_pred: bool = False,
    n_max: Optional[int] = None,
    bucket_by_size: bool = False,
    semiring: SemiringLike = "tropical",
    donate: Optional[bool] = None,
    dtype: Optional[torch.dtype] = None,
    validate: bool = True,
    device=None,
    **kwargs,
) -> BatchAPSPResult:
    """Solve the all-pairs path problem on a batch of independent graphs.

    ``hs`` is a (G, N, N) stack or a ragged list of (n_i, n_i) matrices
    (auto-padded; see :func:`pad_batch`), tensors or host arrays.  Every
    registered method and semiring is supported; results agree with
    per-graph :func:`solve` on the unpadded blocks.  Use
    :meth:`BatchAPSPResult.unpadded` to slice graph i back out.

    ``bucket_by_size=True`` turns on the ragged-batch scheduler: graphs are
    grouped into power-of-two edge buckets and each bucket runs as its own
    batched solve, so a mixed-size corpus pays ~size^3 per graph rather
    than n_max^3.  Output is bit-identical to the single-stack path.

    ``device``, ``donate``, ``dtype`` and ``validate`` follow :func:`solve`:
    the padded stack is a fresh tensor (except a full-size float32 stack
    already on the device), so by default the solve may overwrite it;
    ``validate`` rejects NaN inputs and checks each graph's unpadded
    diagonal for negative cycles (tropical).
    """
    with span("repro_torch.solve_batch"):
        _check_method(method)
        semiring = get_semiring(semiring)
        device = default_device(device)
        if validate:
            with span("repro_torch.validate"):
                for m in [hs] if _is_stack(hs) else hs:
                    _reject_nan(m, semiring)
        if bucket_by_size:
            dist, pred, sizes = _solve_bucketed(
                hs, sizes, n_max, method, with_pred, semiring=semiring,
                donate=donate is not False, dtype=dtype, device=device, **kwargs
            )
        else:
            stack, sizes = pad_batch(hs, sizes, n_max=n_max, semiring=semiring, device=device)
            if dtype is not None:
                stack = stack.to(dtype)
            if donate is None:
                donate = _fresh(stack, hs)        # fresh packed stack -> overwrite it
            with span("repro_torch.dispatch"):
                dist, pred = _solve_stack(stack, with_pred, method, semiring=semiring,
                                          donate=donate, **kwargs)
        if validate:
            check_negative_cycles(dist, semiring, sizes=sizes)
        return BatchAPSPResult(dist=dist, pred=pred, sizes=sizes, method=method)
