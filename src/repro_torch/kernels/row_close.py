"""The row-restricted relaxation pass of the dynamic engine: the CUDA
kernel's wrappers and their plain versions.

Ports ``repro.kernels.row_close.row_close_pallas`` (the TPU kernel) and the
predecessor rule ``repro.kernels.ops.row_restricted_close`` applies to its
witness.  On an (n, n) matrix ``d`` and an int32 list of r row ids ``rows``
(repeats allowed), one pass of

    Z = d[rows, :] ⊕ (d[rows, :] ⊗ d)

in three modes:

  row_close         Z
  row_close_argmin  (Z, K*): the smallest k whose candidate strictly
                    improved on ``d[rows, :]``, -1 where that value was kept
  row_close_pred    (Z, P): P derived from K* by ``pred_from_kstar``'s rule
                    with ``pred[rows]`` as x's preds and as the fallback, and
                    ``pred`` as y's; the kernel derives it in its epilogue
                    and never stores K*

The caller writes the panel back into the state
(``kernels.ops.row_restricted_close``); no version writes ``d``.

* :func:`row_close_torch` and :func:`row_close_pred_torch` are the plain
  versions: the gathered panel through the plain ⊕⊗ folds with
  ``a = panel``, as the JAX package's XLA branch runs it, then
  ``pred_from_kstar``.  They run for CPU tensors, and the tests and
  ``chip_smoke.py`` hold the kernel against them.  bf16 works as in
  ``minplus_torch``.
* :func:`row_close_cuda` and :func:`row_close_pred_cuda` launch the
  hand-written kernels (``csrc/row_close.cu``), which gather the rows
  themselves, on a float32 CUDA matrix, with the plan of
  :func:`launch_plan` (its fill rule, or the tuner's knobs ``tile_rows``
  and ``chunks``).  They check every row id against [0, n) before the
  launch.

Witness and NaN rules are those of ``kernels/minplus.py``.  ``launches``
counts the calls of each wrapper mode that launched its kernel.  On
``meta`` tensors (the dry run) the ``*_cuda`` wrappers plan for the H100
(``roofline.analysis.HW.SMS``), allocate the same outputs and scratch, skip
the row check (it reads the ids) and launch nothing.  Each call, launched or
on ``meta``, reports its work (``roofline.kernels.row_close_work``) and plan
to the dry run's counter, if one runs (``roofline.op_cost.report_kernel``).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.semiring import SemiringLike, get_semiring
from repro_torch.roofline import op_cost
from repro_torch.roofline.analysis import HW
from repro_torch.roofline.kernels import row_close_work

from . import _counts
from ._codes import semiring_code
from .minplus import minplus_argmin_torch, minplus_torch, pred_from_kstar, split_k, tile

__all__ = [
    "row_close_torch",
    "row_close_pred_torch",
    "row_close_cuda",
    "row_close_pred_cuda",
    "launches",
    "RowClosePlan",
    "launch_plan",
]

launches = {"row_close": 0, "row_close_argmin": 0, "row_close_pred": 0}

# The kernels' resident CTAs an SM (csrc/row_close.cu kMinBlocks), the
# shortest k chunk a CTA folds, and the share of the last wave's slots the
# grid must fill before k is split no further.
CTAS_PER_SM = 3
MIN_CHUNK = 256
WAVE_FILL = 0.9


class RowClosePlan(NamedTuple):
    """Launch plan of one pass (``csrc/row_close.cu``): output tiles of
    ``rows`` x ``cols`` over (n / cols, r / rows) CTAs, k slices of
    ``depth``, k split into ``chunks`` chunks of ``chunk`` (the last may be
    shorter) over grid z; ``pitch`` the row pitch of the k-major copy of
    ``d[rows]``; ``scratch_bytes`` the device bytes the wrapper allocates
    beside the outputs: that copy, the partial (value, k) planes when
    ``chunks`` > 1, and an aligned copy of ``d`` when n is not a multiple
    of 4."""

    rows: int
    cols: int
    depth: int
    chunk: int
    chunks: int
    pitch: int
    scratch_bytes: int

    def k_of(self, c: int, n: int) -> range:
        """The k that chunk c folds."""
        return range(c * self.chunk, min(n, (c + 1) * self.chunk))


def _tile(r: int, track: bool) -> Tuple[int, int, int]:
    """(rows, cols, depth) of the compiled tile the fill rule takes for r
    rows: 16, 32 or 64 rows (``minplus.tile``, the product lattice that
    ``csrc/row_close.cu`` compiles), 128 threads of 8 x 8 outputs (values)
    or 8 x 4 (witness), a ring slice of at most 32 k."""
    return tile(16 if r <= 16 else 32 if r <= 32 else 64, track)


def wave_fill(ctas: int, sms: int = 132) -> float:
    """The share of its last wave of ``CTAS_PER_SM * sms`` CTAs that a grid
    of ``ctas`` CTAs fills."""
    wave = CTAS_PER_SM * sms
    return ctas / (-(-ctas // wave) * wave)


def launch_plan(r: int, n: int, track: bool, sms: int = 132, *,
                tile_rows: Optional[int] = None, chunks: Optional[int] = None) -> RowClosePlan:
    """The plan the kernels take for r rows of an (n, n) matrix on a card of
    ``sms`` SMs, with (``track``) or without a witness.  The knobs:
    ``tile_rows``, the tile's rows (16, 32 or 64; default the fewest that hold r), and
    ``chunks``, k split into at most that many chunks of whole slices
    (``minplus.split_k``).  Without ``chunks`` the fill rule splits: k stays
    whole while the grid fills at least ``WAVE_FILL`` of its last wave of
    ``CTAS_PER_SM * sms`` CTAs; otherwise it splits into the fewest chunks
    (of whole slices, at least ``MIN_CHUNK`` long) that do, or, if none
    does, into those that fill the most."""
    if r < 1 or n < 1:
        raise ValueError(f"row_close takes r >= 1 rows and n >= 1, got r={r} n={n}")
    bm, bn, bk = _tile(r, track) if tile_rows is None else tile(tile_rows, track)
    tiles = -(-r // bm) * -(-n // bn)

    def fill(c: int) -> float:
        return wave_fill(tiles * split_k(n, c, bk)[1], sms)

    if chunks is None:
        most = max(1, n // MIN_CHUNK)
        chunks = next((c for c in range(1, most + 1) if fill(c) >= WAVE_FILL),
                      max(range(1, most + 1), key=fill))
    chunk, nc = split_k(n, chunks, bk)
    pitch = -(-r // 32) * 32
    scratch = 4 * n * pitch
    if nc > 1:
        scratch += nc * r * n * (8 if track else 4)
    if n % 4:
        scratch += 4 * n * -(-n // 32) * 32
    return RowClosePlan(bm, bn, bk, chunk, nc, pitch, scratch)


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


def row_close_pred_torch(
    d: torch.Tensor,
    rows: torch.Tensor,
    pred: torch.Tensor,
    *,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the pred mode: the witness fold, then
    ``pred_from_kstar`` with ``pred[rows]`` as x's preds and the fallback."""
    z, kstar = row_close_torch(d, rows, track=True, semiring=semiring)
    ppanel = pred.index_select(0, rows.long())
    return z, pred_from_kstar(kstar, ppanel, pred, fallback=ppanel)


def _check(d: torch.Tensor, rows: torch.Tensor) -> Tuple[int, int]:
    """(r, n) of operands the kernel takes; raises on anything else (on
    ``meta`` the row ids are not read)."""
    if not ((d.is_cuda and rows.is_cuda) or (d.is_meta and rows.is_meta)):
        raise ValueError(f"row_close takes CUDA (or meta) tensors, got {d.device} and "
                         f"{rows.device}")
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
    # The ids are checked on the host before the gather (ROADMAP: out-of-range ids
    # raise where JAX clamps); the kernel's gather then needs no bounds check.
    if not d.is_meta and bool(((rows < 0) | (rows >= n)).any()):  # repro: allow-host-sync  ids
        raise IndexError(f"row_close: a row id lies outside [0, {n})")
    return rows.numel(), n


def _prepare(name: str, d: torch.Tensor, rows: torch.Tensor, pred: Optional[torch.Tensor],
             semiring, plan: Optional[RowClosePlan] = None, *,
             tile_rows: Optional[int] = None, chunks: Optional[int] = None
             ) -> Tuple[Callable[[], int], torch.Tensor, Optional[torch.Tensor], RowClosePlan]:
    """Check the operands, plan the launch and allocate the outputs and
    scratches of one pass in mode ``name``: (launch, Z, K* or preds, plan),
    where ``launch()`` runs the pass's grids on the current stream and
    returns their cudaError_t (on ``meta``: runs nothing, returns 0).
    ``chip_smoke.py`` times ``launch`` alone: the row check here
    synchronises with the card.  ``tile_rows`` and ``chunks`` are
    :func:`launch_plan`'s knobs; ``plan`` replaces its plan (the grid
    verifier hands the C entry point defective plans)."""
    sr = get_semiring(semiring)
    r, n = _check(d, rows)
    mode = ("row_close", "row_close_argmin", "row_close_pred").index(name)
    if mode == 2 and not (pred.device == d.device and pred.dtype == torch.int32
                          and pred.shape == d.shape and pred.is_contiguous()):
        raise ValueError(f"row_close_pred takes a contiguous int32 pred of "
                         f"{tuple(d.shape)}, got {pred.dtype} {tuple(pred.shape)} on "
                         f"{pred.device}")
    code = semiring_code(sr, name)
    sms = (HW.SMS if d.is_meta
           else torch.cuda.get_device_properties(d.device).multi_processor_count)
    if plan is None:
        plan = launch_plan(r, n, mode != 0, sms, tile_rows=tile_rows, chunks=chunks)
    dev = d.device
    z = torch.empty((r, n), dtype=torch.float32, device=dev)
    out = torch.empty((r, n), dtype=torch.int32, device=dev) if mode else None
    xt = torch.empty((n, plan.pitch), dtype=torch.float32, device=dev)
    pz = pk = None
    if plan.chunks > 1:
        pz = torch.empty((plan.chunks, r, n), dtype=torch.float32, device=dev)
        pk = torch.empty((plan.chunks, r, n), dtype=torch.int32, device=dev) if mode else None
    y, ny = d, n
    if n % 4 or d.data_ptr() % 16:
        # The ring copies 16-byte chunks: rows of d that are not so aligned
        # are copied into rows of pitch n rounded up to 32 floats.
        ny = -(-n // 32) * 32
        y = torch.empty((n, ny), dtype=torch.float32, device=dev)
        y[:, :n].copy_(d)
    if d.is_meta:
        return (lambda: 0), z, out, plan
    from . import _build

    fn = _build.function("row_close", "row_close_launch",
                         [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                         + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (code, mode, d.data_ptr(), y.data_ptr(), y.stride(0), ny, rows.data_ptr(),
            xt.data_ptr(), plan.pitch, ptr(pred), z.data_ptr(), ptr(out), ptr(pz), ptr(pk),
            r, n, plan.rows, plan.cols, plan.depth, plan.chunk, plan.chunks,
            torch.cuda.current_stream(dev).cuda_stream)
    def launch(held=(d, y, rows, xt, pred, pz, pk)) -> int:   # the buffers live as long
        return fn(*args)

    return launch, z, out, plan


def _launch(name: str, d: torch.Tensor, rows: torch.Tensor, pred: Optional[torch.Tensor],
            semiring, plan: Optional[RowClosePlan] = None, **knobs
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    launch, z, out, plan = _prepare(name, d, rows, pred, semiring, plan, **knobs)
    r, n = rows.numel(), d.shape[0]
    report = dict(shape=f"r={r} n={n}", plan=tuple(plan))
    if d.is_meta:
        op_cost.report_kernel(name, row_close_work(name, r, n), **report)
        return z, out
    err = launch()
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _counts.bump(launches, name)
    op_cost.report_kernel(name, row_close_work(name, r, n), **report)
    return z, out


def row_close_cuda(
    d: torch.Tensor,
    rows: torch.Tensor,
    *,
    track: bool = False,
    semiring: SemiringLike = "tropical",
    tile_rows: Optional[int] = None,
    chunks: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel (``row_close``, or ``row_close_argmin`` with
    ``track``): new (Z float32, K* int32 or None) tensors, with the tile
    rows and k chunks of :func:`launch_plan`'s knobs."""
    return _launch("row_close_argmin" if track else "row_close", d, rows, None, semiring,
                   tile_rows=tile_rows, chunks=chunks)


def row_close_pred_cuda(
    d: torch.Tensor,
    rows: torch.Tensor,
    pred: torch.Tensor,
    *,
    semiring: SemiringLike = "tropical",
    tile_rows: Optional[int] = None,
    chunks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel in its pred mode (``row_close_pred``): new
    (Z float32, preds int32) tensors, the preds derived from the witnesses
    in the epilogue by :func:`row_close_pred_torch`'s rule (K* is never
    stored).  ``pred`` is the (n, n) int32 state."""
    return _launch("row_close_pred", d, rows, pred, semiring, tile_rows=tile_rows,
                   chunks=chunks)
