"""One fused blocked-FW round: the CUDA kernel's wrapper and its plain version.

Ports ``repro.kernels.fw_round.fw_round_pallas`` (the TPU kernel) and
``repro.kernels.minplus_xla.fw_round_xla`` (its chunked-XLA fallback).  On
(N, N) or (G, N, N) storage with the pivot block at element offset ``o``:

  A*   = FW(D[o:o+B, o:o+B])       closure in f32
  col' = D[:, o:o+B] ⊗ A*
  out  = D ⊕ col' ⊗ D[o:o+B, :]

bf16 storage keeps f32 arithmetic and rounds at the closed pivot, at col'
and at the output, the three points of the TPU kernel.  ⊕ is selective and
every candidate ``x ⊗ y`` is one rounded operation, so any fold over the same
candidates gives the same bits: the kernel, the plain version and both JAX
paths agree exactly.

* :func:`fw_round_torch` is the plain version: it runs for CPU tensors, and
  the tests and ``chip_smoke.py`` hold the kernel against it.
* :func:`fw_round_cuda` launches the hand-written kernel
  (``csrc/fw_round.cu``) on CUDA tensors.  It updates ``d`` in place.
* :func:`fw_round` picks between them by the tensor's device
  (``ops.backend``).

On ``meta`` tensors (the dry run) :func:`fw_round_cuda` allocates the same
scratch and launches nothing.  Each call, launched or on ``meta``, reports
its work (``roofline.kernels.fw_round_work``) and plan to the dry run's
counter, if one runs (``roofline.op_cost.report_kernel``).

``rounds`` counts the calls of :func:`fw_round_cuda` that launched the
kernel's round (four grids each: the closure, ``fw_panels``,
``fw_colpanel`` and ``fw_update``; the closure is the cluster closure
``fw_closure`` up to B = 256 and the grid closure ``fw_closure_grid``
above).  The wrapper computes the round's launch plan (:func:`launch_plan`:
the closure's plan ``fw_block.closure_launch``, the grids of the other
three, the ring's tile, the scratches of :func:`scratch_shapes` in rows of
pitch :func:`pitch`) and passes it to ``fw_round_launch``, which checks it
against the plan it would launch and refuses any other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.semiring import SemiringLike, get_semiring
from repro_torch.roofline import op_cost
from repro_torch.roofline.kernels import fw_round_work

from . import _counts
from ._codes import semiring_code
from .fw_block import MAX_BLOCK, ClosurePlan, closure_launch, fw_block_torch, grid_lines_words
from .minplus import minplus_torch

__all__ = ["fw_round", "fw_round_torch", "fw_round_cuda", "rounds", "pitch",
           "scratch_shapes", "RoundPlan", "launch_plan"]

rounds = 0

# The ring's tile of fw_colpanel and fw_update (csrc/fw_round.cu UM, UN,
# UK, kStages): 64 x 128 outputs a CTA of 128 threads, k slices of 32,
# three slots.
TILE_ROWS, TILE_COLS, DEPTH, STAGES, THREADS = 64, 128, 32, 3, 128


def pitch(n: int) -> int:
    """Row pitch of the scratches that the ring reads: N (or B) rounded up
    to a multiple of 32 floats, so that every row starts 16-byte aligned for
    the 16-byte asynchronous copies whatever N is."""
    return -(-n // 32) * 32


def scratch_shapes(g: int, n: int, b: int) -> dict:
    """Shapes of the f32 scratches of one round of G graphs of N nodes at
    tile B: the closed pivots ``apiv`` (G, B, B) and their copy ``apv``
    (G, B, Bp), col'^T ``colt``, the row-panel copy ``rowp`` and the
    transposed column panel ``coln`` (G, B, Np), and, above ``MAX_BLOCK``,
    the grid closure's int32 ``lines`` (``fw_block.grid_lines_words``)."""
    np_ = pitch(n)
    shapes = {"apiv": (g, b, b), "colt": (g, b, np_), "rowp": (g, b, np_),
              "coln": (g, b, np_), "apv": (g, b, pitch(b))}
    if b > MAX_BLOCK:
        shapes["lines"] = (grid_lines_words(b, g),)
    return shapes


class RoundPlan(NamedTuple):
    """Launch plan of one round (``csrc/fw_round.cu``) of G graphs of N
    nodes at tile B: the closure's plan ``closure``
    (``fw_block.closure_launch``); the scratches' row pitches ``np`` (N) and
    ``bp`` (B); the grids of ``fw_panels`` (32 x 32 tiles over (N, B)),
    ``fw_colpanel`` (``rows`` x ``cols`` ring tiles over col'^T's (B, N)) and
    ``fw_update`` (ring tiles over (N, N)), grid z G; the ring's k slices of
    ``depth``, ``threads`` and ``shared_bytes`` a ring CTA; the scratch
    shapes (:func:`scratch_shapes`)."""

    closure: ClosurePlan
    np: int
    bp: int
    panels_grid: Tuple[int, int, int]
    colpanel_grid: Tuple[int, int, int]
    update_grid: Tuple[int, int, int]
    rows: int
    cols: int
    depth: int
    threads: int
    shared_bytes: int
    scratch: dict

    def c_args(self) -> "_Plan":
        return _Plan(self.np, self.bp, *self.panels_grid[:2], *self.colpanel_grid[:2],
                     *self.update_grid[:2], self.rows, self.cols, self.depth, self.threads,
                     self.shared_bytes)


class _Plan(ctypes.Structure):
    """``RoundPlan`` of ``csrc/fw_round.cu``."""

    _fields_ = [(f, ctypes.c_int) for f in ("np", "bp", "px", "py", "cx", "cy", "ux", "uy",
                                              "um", "un", "uk", "threads", "smem")]


def launch_plan(g: int, n: int, b: int) -> RoundPlan:
    """The plan the kernel runs for one round of G graphs of N nodes at
    tile B (B divides N)."""
    if g < 1 or b < 1 or n < b or n % b:
        raise ValueError(f"a round takes G >= 1 and a tile B that divides N, got G={g} "
                         f"N={n} B={b}")

    def ring(rows: int, cols: int) -> Tuple[int, int, int]:
        return (-(-cols // TILE_COLS), -(-rows // TILE_ROWS), g)

    return RoundPlan(closure_launch(b), pitch(n), pitch(b), (-(-n // 32), -(-b // 32), g),
                     ring(b, n), ring(n, n), TILE_ROWS, TILE_COLS, DEPTH, THREADS,
                     STAGES * DEPTH * (TILE_ROWS + TILE_COLS) * 4, scratch_shapes(g, n, b))


@functools.lru_cache(maxsize=256)
def _cached_plan(g: int, n: int, b: int) -> Tuple[RoundPlan, _Plan]:
    """The plan of (g, n, b) and its C struct, made once: a solve launches
    n/B rounds of one shape."""
    plan = launch_plan(g, n, b)
    return plan, plan.c_args()


def fw_round_torch(
    d: torch.Tensor, o: int, *, block_size: int, semiring: SemiringLike = "tropical"
) -> torch.Tensor:
    """The plain version: a new tensor holding one fused round of ``d``.
    Folds as ``fw_round_xla`` does, with bf16 rounded at the same points:
    the closed pivot, col' and the output (``minplus_torch`` rounds to its
    first operand's dtype)."""
    sr = get_semiring(semiring)
    b = block_size
    pivot = fw_block_torch(d[..., o:o + b, o:o + b], semiring=sr)
    colp = minplus_torch(d[..., :, o:o + b], pivot, semiring=sr)
    return minplus_torch(colp, d[..., o:o + b, :], d, semiring=sr)


def fw_round_cuda(
    d: torch.Tensor, o: int, *, block_size: int, semiring: SemiringLike = "tropical"
) -> torch.Tensor:
    """Launch the CUDA kernel's round on ``d``, in place; returns ``d`` (on
    ``meta``: launches nothing)."""
    return _round(d, o, int(block_size), get_semiring(semiring))


def _round(d: torch.Tensor, o: int, b: int, sr, plan: Optional[RoundPlan] = None) -> torch.Tensor:
    """:func:`fw_round_cuda`'s body; ``plan`` replaces :func:`launch_plan`'s
    (the grid verifier hands the C entry point defective plans, which it
    must refuse)."""
    global rounds
    if not (d.is_cuda or d.is_meta):
        raise ValueError(f"fw_round_cuda takes a CUDA (or meta) tensor, got one on {d.device}")
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fw_round_cuda takes float32 or bfloat16, got {d.dtype}")
    if not d.is_contiguous():
        raise ValueError("fw_round_cuda takes a contiguous tensor")
    if d.ndim not in (2, 3) or d.shape[-1] != d.shape[-2]:
        raise ValueError(f"fw_round_cuda takes (N, N) or (G, N, N), got {tuple(d.shape)}")
    n = d.shape[-1]
    g = d.shape[0] if d.ndim == 3 else 1
    if b < 1 or n % b:
        raise ValueError(f"block_size must divide N and be at least 1; got B={b}, N={n}")
    o = int(o)
    if o % b or not 0 <= o < n:
        raise ValueError(f"pivot offset {o} is not a block of N={n}, B={b}")
    code = semiring_code(sr, "fw_round")
    plan, c_plan = _cached_plan(g, n, b) if plan is None else (plan, plan.c_args())
    shapes = plan.scratch
    f32 = dict(dtype=torch.float32, device=d.device)
    w = {k: torch.empty(shapes[k], **f32) for k in ("apiv", "colt", "rowp", "coln", "apv")}
    lines = (torch.empty(shapes["lines"], dtype=torch.int32, device=d.device)
             if "lines" in shapes else None)
    report = dict(shape=f"G={g} N={n} B={b}", plan=plan)
    work = fw_round_work(g, n, b, d.element_size())
    if d.is_meta:
        op_cost.report_kernel("fw_round", work, **report)
        return d
    from . import _build

    fn = _build.function("fw_round", "fw_round_launch",
                         [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 4 + [ctypes.POINTER(_Plan)] + [ctypes.c_int] * 4
                         + [ctypes.c_void_p] * 2)
    stream = torch.cuda.current_stream(d.device).cuda_stream
    err = fn(code, int(d.dtype == torch.bfloat16), d.data_ptr(),
             *(w[k].data_ptr() for k in ("apiv", "colt", "rowp", "coln", "apv")), g, n, b, o,
             ctypes.byref(c_plan), *plan.closure,
             None if lines is None else lines.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fw_round kernel launch failed: cudaError_t {err}")
    with _counts.lock:
        rounds += 1
    op_cost.report_kernel("fw_round", work, **report)
    return d


def fw_round(
    d: torch.Tensor, o: int, *, block_size: int, semiring: SemiringLike = "tropical"
) -> torch.Tensor:
    """One fused round: the CUDA kernel for a CUDA tensor (in place; on a
    ``meta`` tensor its wrapper launches nothing), the plain version for a
    CPU tensor, as ``ops.backend`` decides."""
    from .ops import backend

    fn = fw_round_torch if backend(d) == "torch" else fw_round_cuda
    return fn(d, o, block_size=block_size, semiring=semiring)
