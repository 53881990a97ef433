"""The row-restricted relaxation pass of the dynamic engine: the CUDA
kernel's wrapper and its plain version.

Ports ``repro.kernels.row_close.row_close_pallas`` (the TPU kernel).  On an
(n, n) matrix ``d`` and an int32 list of r row ids ``rows`` (repeats
allowed), one pass of

    Z = d[rows, :] ⊕ (d[rows, :] ⊗ d)

returns the (r, n) panel Z and, with ``track``, its int32 witness K*: the
smallest k whose candidate strictly improved on ``d[rows, :]``, -1 where
that value was kept.  The caller writes the panel back into the state
(``kernels.ops.row_restricted_close``); neither version writes ``d``.

* :func:`row_close_torch` is the plain version: the gathered panel through
  the plain ⊕⊗ folds with ``a = panel``, as the JAX package's XLA branch
  runs it.  It runs for CPU tensors, and the tests and ``chip_smoke.py``
  hold the kernel against it.  bf16 works as in ``minplus_torch``.
* :func:`row_close_cuda` launches the hand-written kernel
  (``csrc/row_close.cu``), which gathers the rows itself, on a float32 CUDA
  matrix.  It checks every row id against [0, n) before the launch.

Witness and NaN rules are those of ``kernels/minplus.py``.  ``launches``
counts the calls of the wrapper that launched its kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import SemiringLike, get_semiring

from ._codes import semiring_code
from .minplus import minplus_argmin_torch, minplus_torch

__all__ = ["row_close_torch", "row_close_cuda", "launches"]

launches = {"row_close": 0}


def row_close_torch(
    d: torch.Tensor,
    rows: torch.Tensor,
    *,
    track: bool = False,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version: (Z, K* or None) for ``d[rows] ⊕ d[rows] ⊗ d``."""
    sr = get_semiring(semiring)
    panel = d.index_select(0, rows.long())
    if track:
        return minplus_argmin_torch(panel, d, panel, semiring=sr)
    return minplus_torch(panel, d, panel, semiring=sr), None


def _check(d: torch.Tensor, rows: torch.Tensor) -> Tuple[int, int]:
    """(r, n) of operands the kernel takes; raises on anything else."""
    if not (d.is_cuda and rows.is_cuda):
        raise ValueError(f"row_close takes CUDA tensors, got {d.device} and {rows.device}")
    if d.dtype != torch.float32:
        raise TypeError(f"row_close takes a float32 matrix (ops upcasts bf16), got {d.dtype}")
    if rows.dtype != torch.int32:
        raise TypeError(f"row_close takes int32 row ids, got {rows.dtype}")
    if d.ndim != 2 or d.shape[0] != d.shape[1] or rows.ndim != 1 or rows.numel() == 0:
        raise ValueError(f"row_close takes an (n, n) matrix and r >= 1 row ids, got "
                         f"{tuple(d.shape)} and {tuple(rows.shape)}")
    if not (d.is_contiguous() and rows.is_contiguous()):
        raise ValueError("row_close takes contiguous tensors")
    n = d.shape[0]
    if bool(((rows < 0) | (rows >= n)).any()):
        raise IndexError(f"row_close: a row id lies outside [0, {n})")
    return rows.numel(), n


def row_close_cuda(
    d: torch.Tensor,
    rows: torch.Tensor,
    *,
    track: bool = False,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel: new (Z float32, K* int32 or None) tensors."""
    sr = get_semiring(semiring)
    r, n = _check(d, rows)
    code = semiring_code(sr, "row_close")
    z = torch.empty((r, n), dtype=torch.float32, device=d.device)
    ks = torch.empty((r, n), dtype=torch.int32, device=d.device) if track else None
    from . import _build

    fn = _build.load("row_close").row_close_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(code, int(track), d.data_ptr(), rows.data_ptr(), z.data_ptr(),
             None if ks is None else ks.data_ptr(), r, n, stream)
    if err:
        raise RuntimeError(f"row_close kernel launch failed: cudaError_t {err}")
    launches["row_close"] += 1
    return z, ks
