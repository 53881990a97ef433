"""Closure of a stack of B x B tiles, with and without predecessors: the
CUDA kernels' wrappers and their plain versions.

Ports ``repro.kernels.fw_block.fw_block_pallas`` and
``fw_block_pred_pallas`` (the TPU kernels).  On a (B, B) tile or a
(T, B, B) stack of independent tiles, B sequential pivot steps:

  fw_block       D <- D ⊕ D[:, k] ⊗ D[k, :]
  fw_block_pred  the same, and pred[i, j] <- pred[k, j] where the value
                 strictly improves (``p`` holds global node ids)

Each step reads the old row and column k, as the JAX step does.  A NaN
candidate never improves and a NaN value is never replaced in the pred
closure, as in the JAX oracle.

* :func:`fw_block_torch` and :func:`fw_block_pred_torch` are the plain
  versions (the oracles of ``kernels/ref.py`` in f32, rounded once to the
  storage dtype, as ``repro.kernels.ops`` runs them): they run for CPU
  tensors, and the tests and ``chip_smoke.py`` hold the kernels against
  them.
* :func:`fw_block_cuda` and :func:`fw_block_pred_cuda` launch the
  hand-written kernels (``csrc/fw_block.cu``) on float32 CUDA tensors, any
  B: up to ``MAX_BLOCK`` one thread-block cluster of ``CLUSTER`` CTAs a
  tile, laid out by :func:`closure_plan`; above it the grid closure, one
  cooperative launch of ``GRID_THREADS``-thread CTAs for the stack with a
  scratch of :func:`grid_lines_words` words.  :func:`closure_launch` picks
  the plan by B (the fused round's closure takes the same plans).

On ``meta`` tensors (the dry run) the ``*_cuda`` wrappers allocate the same
outputs and scratch and launch nothing.

``launches`` counts the calls of each wrapper that launched its kernel.
Each call, launched or on ``meta``, reports its work
(``roofline.kernels.fw_block_work``) and plan to the dry run's counter, if
one runs (``roofline.op_cost.report_kernel``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.semiring import SemiringLike, get_semiring
from repro_torch.roofline import op_cost
from repro_torch.roofline.kernels import fw_block_work

from . import _counts
from ._codes import semiring_code
from .ref import fw_block_pred_ref, fw_block_ref

__all__ = [
    "fw_block_torch",
    "fw_block_pred_torch",
    "fw_block_cuda",
    "fw_block_pred_cuda",
    "launches",
    "MAX_BLOCK",
    "CLUSTER",
    "ClosurePlan",
    "closure_plan",
    "GRID_THREADS",
    "closure_launch",
    "grid_lines_words",
]

# Largest tile the cluster closure takes (csrc/fw_closure.cuh kCloseMaxB);
# larger tiles close on the grid closure.
MAX_BLOCK = 256
# CTAs a closure cluster: the portable maximum (csrc/fw_closure.cuh kClusterMax).
CLUSTER = 8
# Pivots a cluster barrier, and the rows of one thread in registers at most
# (csrc/fw_closure.cuh kCloseStep, kCloseMaxRows).
STEP = 8
MAX_ROWS = 32
# Threads a CTA of the grid closure (csrc/fw_closure.cuh kGridThreads).
GRID_THREADS = 512


class ClosurePlan(NamedTuple):
    """Launch plan of one tile closure (``csrc/fw_closure.cuh``): a cluster
    of ``cluster`` CTAs of ``threads`` threads; CTA c owns rows
    ``rows_of(c)``, R = ``rows`` values (and preds) a thread in registers;
    ``shared_bytes`` of dynamic shared memory a CTA for the published rows
    and columns of each group of ``STEP`` pivots."""

    cluster: int
    rows: int
    threads: int
    shared_bytes: int

    def rows_of(self, c: int, b: int) -> range:
        return range(min(b, c * self.rows), min(b, (c + 1) * self.rows))


def closure_plan(b: int, pred: bool = False) -> ClosurePlan:
    """The plan the kernels take for a B x B tile, 1 <= B <= ``MAX_BLOCK``:
    ``CLUSTER`` CTAs, R = ceil(B / CLUSTER) rows each rounded up to a
    multiple of ``STEP`` (so that the pivots of one cluster barrier lie in
    one CTA; CTAs past the last row own none and still join every barrier),
    one thread a column rounded up to a warp, and the slots of
    ``close_smem_bytes``: old and stepped columns [3][STEP][32] floats, the
    pivot-row coefficients [STEP][STEP], rows [2][STEP][B] floats and, with
    preds, [2][STEP][B] int32."""
    if not 1 <= b <= MAX_BLOCK:
        raise ValueError(f"a closure takes tiles of 1 to {MAX_BLOCK} nodes, got B={b}")
    rows = -(-b // (CLUSTER * STEP)) * STEP
    threads = -(-b // 32) * 32
    shared = 4 * (3 * STEP * MAX_ROWS + STEP * STEP + 2 * STEP * b * (2 if pred else 1))
    return ClosurePlan(CLUSTER, rows, threads, shared)


def grid_lines_words(b: int, tiles: int, pred: bool = False) -> int:
    """int32 words of the grid closure's scratch (csrc/fw_closure.cuh
    ``grid_lines_words``): the barrier counter (4 words), then the old row
    and column of the current pivot of each tile, double-buffered, and with
    preds the old pred row: ``4 + 2 * tiles * b * (3 if pred else 2)``."""
    return 4 + 2 * tiles * b * (3 if pred else 2)


def closure_launch(b: int, pred: bool = False) -> ClosurePlan:
    """The launch plan the closure kernels take for a B x B tile: the
    cluster plan (:func:`closure_plan`) for B <= ``MAX_BLOCK``; above it the
    grid closure's, no cluster (0), no rows in registers (0),
    ``GRID_THREADS`` threads, no dynamic shared memory (``grid_plan_ok`` in
    ``csrc/fw_closure.cuh``)."""
    if b > MAX_BLOCK:
        return ClosurePlan(0, 0, GRID_THREADS, 0)
    return closure_plan(b, pred)


launches = {"fw_block": 0, "fw_block_pred": 0}


def _f32(d: torch.Tensor) -> torch.Tensor:
    return d.float() if d.dtype == torch.bfloat16 else d


def fw_block_torch(d: torch.Tensor, *, semiring: SemiringLike = "tropical") -> torch.Tensor:
    """The plain version: the closed tile(s), in ``d``'s dtype."""
    return fw_block_ref(_f32(d), semiring).to(d.dtype)


def fw_block_pred_torch(
    d: torch.Tensor, p: torch.Tensor, *, semiring: SemiringLike = "tropical"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (closed tile(s) in ``d``'s dtype, int32 preds)."""
    z, pz = fw_block_pred_ref(_f32(d), p, semiring)
    return z.to(d.dtype), pz


def _launch(name: str, d, p, semiring) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    sr = get_semiring(semiring)
    for t, dtype in ((d, torch.float32), (p, torch.int32)):
        if t is None:
            continue
        if not (t.is_cuda or t.is_meta):
            raise ValueError(f"{name} takes CUDA (or meta) tensors, got one on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} takes {dtype} here, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if d.ndim not in (2, 3) or d.shape[-1] != d.shape[-2]:
        raise ValueError(f"{name} takes (B, B) or (T, B, B) tiles, got {tuple(d.shape)}")
    if p is not None and p.shape != d.shape:
        raise ValueError(f"{name}: preds {tuple(p.shape)} differ from tiles {tuple(d.shape)}")
    b = d.shape[-1]
    tiles = d.shape[0] if d.ndim == 3 else 1
    if b < 1 or tiles < 1:
        raise ValueError(f"{name} takes at least one tile of at least one node, got "
                         f"{tuple(d.shape)}")
    code = semiring_code(sr, name)
    z = torch.empty_like(d)
    pz = None if p is None else torch.empty_like(p)
    plan = closure_launch(b, pred=p is not None)
    lines = (torch.empty(grid_lines_words(b, tiles, p is not None), dtype=torch.int32,
                         device=d.device) if b > MAX_BLOCK else None)
    work = fw_block_work(tiles, b, pred=p is not None)
    report = dict(shape=f"T={tiles} B={b}", plan=tuple(plan))
    if d.is_meta:
        op_cost.report_kernel(name, work, **report)
        return z, pz
    from . import _build

    fn = _build.function("fw_block", "fw_block_launch",
                         [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p] * 2)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(code, int(p is not None), d.data_ptr(), None if p is None else p.data_ptr(),
             z.data_ptr(), None if pz is None else pz.data_ptr(), tiles, b, *plan,
             None if lines is None else lines.data_ptr(), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _counts.bump(launches, name)
    op_cost.report_kernel(name, work, **report)
    return z, pz


def fw_block_cuda(d: torch.Tensor, *, semiring: SemiringLike = "tropical") -> torch.Tensor:
    """Launch the CUDA closure kernel: a new tensor of closed tiles."""
    return _launch("fw_block", d, None, semiring)[0]


def fw_block_pred_cuda(
    d: torch.Tensor, p: torch.Tensor, *, semiring: SemiringLike = "tropical"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA pred closure kernel: new (tiles, int32 preds)."""
    return _launch("fw_block_pred", d, p, semiring)
