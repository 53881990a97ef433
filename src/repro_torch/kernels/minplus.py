"""The tiled ⊕⊗ product, with and without a witness, and with the
predecessors derived from the witness: the CUDA kernel's wrappers and their
plain versions.

Ports ``repro.kernels.minplus.minplus_pallas`` and ``minplus_argmin_pallas``
(the TPU kernels, one body with two flags), the folds of
``repro.kernels.minplus_xla`` (``minplus_xla``, ``minplus_argmin_xla``) and
the predecessor rule of ``repro.kernels.ops.minplus_pred``.  On (M, K) x
(K, N) operands, or a batch (G, M, K) x (G, K, N):

  minplus         Z = [A ⊕] ⊕_k X[:, k] ⊗ Y[k, :]
  minplus_argmin  (Z, K*): K*[i, j] the smallest k whose candidate strictly
                  improved on the start value (A, or the semiring zero), -1
                  where none did.  Strict improvement from the zero leaves -1
                  exactly where the reference's ``is_zero`` mask does.
  minplus_pred    (Z, P): P derived from K* by :func:`pred_from_kstar`
                  (``PA``, or -1, where K* is -1); the kernel derives it in
                  its epilogue and never stores K*.

All fold k in ascending order.  ⊕ is selective and each candidate is one
rounded operation, so the value folds agree bit for bit with the kernel and
with both JAX paths; the witness folds agree with them on NaN-free inputs.

**NaN rule of the port's witness folds** (kernel and plain version alike):
a NaN candidate never improves and a NaN accumulator is never replaced.
The plain version maps NaN candidates to the value that never strictly
improves (+inf under a min ⊕, -inf under a max ⊕) before each chunk's
reduce; the kernel gets the same from its strict comparison.  The
JAX package has no one rule here: its chunked folds drop a whole chunk that
holds a NaN, and its oracle returns the NaN.  The value fold
(``minplus``) propagates NaN, as ``jnp.minimum`` does.

bf16 operands are upcast by ``kernels.ops``, which rounds the value once.
The plain versions also take bf16 themselves, as ``minplus_xla`` does:
f32 arithmetic, output in ``x``'s dtype.

* :func:`minplus_torch`, :func:`minplus_argmin_torch` and
  :func:`minplus_pred_torch` are the plain versions: they run for CPU
  tensors, and the tests and ``chip_smoke.py`` hold the kernel against them.
* :func:`minplus_cuda`, :func:`minplus_argmin_cuda` and
  :func:`minplus_pred_cuda` launch the hand-written kernel
  (``csrc/minplus.cu``) on float32 CUDA tensors (int32 preds).  Operands may
  be strided views with unit column stride; each launch is two grids, the
  k-major copy of X (``kmajor``) and the product.  On ``meta`` tensors (the
  dry run) they allocate the same outputs and scratch and launch nothing.

Each launch runs the plan of :func:`launch_plan` (the tile, the k chunks,
both grids, X^T's pitch, the ring's column limit ``ny``, the shared
bytes), which the wrapper passes to ``minplus_launch``; the C entry point
checks it against the tile lattice (``plan_is``) and refuses any plan
outside it.  The wrappers take the tuner's knobs (``kernels.autotune``):
``tile_rows`` (16, 32 or 64, :func:`tile`) and ``chunks`` (k split across
CTAs, :func:`split_k`); with no knob the plan is the 64-row tile with k
whole.  A split plan's product writes (chunks, G, M, N) partials and
``minplus_combine`` (:func:`minplus_combine_cuda`; plain versions
:func:`minplus_partials_torch` and :func:`minplus_combine_torch`) folds
them in ascending chunk order into Z (and K* or the preds): the unsplit
fold's bits, ties still to the smallest k.

``launches`` counts the calls of each wrapper that launched its kernel,
and ``minplus_combine`` each combine launched.  While a profiler runs, the
witness modes' launches also add the kernel's witness-fold counts to a
buffer on the card (:data:`FOLD_COUNTS`; off a profiler the kernel is
given none and counts nothing); :func:`fold_counts` reads them, with a
synchronise, so never inside a timed window.
Each call, launched or on ``meta``, reports its work
(``roofline.kernels.minplus_work``) and plan to the dry run's counter, if
one runs (``roofline.op_cost.report_kernel``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import _spans
from repro_torch.core.semiring import Semiring, SemiringLike, get_semiring
from repro_torch.roofline import op_cost
from repro_torch.roofline.kernels import minplus_combine_work, minplus_work

from . import _counts
from ._codes import semiring_code

__all__ = [
    "minplus_torch",
    "minplus_argmin_torch",
    "minplus_pred_torch",
    "pred_from_kstar",
    "ring_rows",
    "minplus_cuda",
    "minplus_argmin_cuda",
    "minplus_pred_cuda",
    "minplus_partials_torch",
    "minplus_combine_torch",
    "minplus_combine_cuda",
    "launches",
    "MODES",
    "ProductPlan",
    "launch_plan",
    "tile",
    "split_k",
    "LATTICE_ROWS",
    "FOLD_COUNTS",
    "fold_counts",
]

# Elements of the (..., rows, k chunk, N) broadcast the plain version builds
# at a time: a k chunk of 1 at N = 8192, the whole k at the tests' sizes.
_FOLD_BUDGET = 1 << 24

launches = {"minplus": 0, "minplus_argmin": 0, "minplus_pred": 0, "minplus_combine": 0}

# The kernel's modes, in the order of ``minplus_launch``'s mode codes.
MODES = ("minplus", "minplus_argmin", "minplus_pred")
# The tile lattice of csrc/minplus_tile.cuh (ProductTile), which the product
# and row_close compile: 64, 32 or 16 rows at 128 threads of 8 x 8 outputs
# (values) or 8 x 4 (witness), the columns widening as the rows narrow, k in
# slices of at most 32 through a ring of 3 slots.  The default tile is the
# 64-row one: 64 x 128 for values, 64 x 64 with a witness.
TILE_ROWS, DEPTH, STAGES, THREADS = 64, 32, 3, 128
LATTICE_ROWS = (16, 32, 64)
TILE_COLS = {False: 128, True: 64}
# The witness fold's counts (csrc/minplus_tile.cuh kFoldCounts), in order:
# warp slices folded, warp slices run eagerly, rescan passes (each deferred
# warp slice makes as many as its busiest lane has moved outputs), outputs
# resolved.
FOLD_COUNTS = ("slices", "eager", "rescans", "resolved")
# Threads a CTA of the split-k combine (csrc/minplus.cu kCombineThreads).
COMBINE_THREADS = 256


def tile(rows: int, track: bool) -> Tuple[int, int, int]:
    """(rows, cols, depth) of the lattice's tile of ``rows`` rows, with
    (``track``) or without a witness: ``ProductTile`` of
    ``csrc/minplus_tile.cuh``."""
    if rows not in LATTICE_ROWS:
        raise ValueError(f"tile rows must be one of {LATTICE_ROWS}, got {rows!r}")
    tn = 4 if track else 8
    depth = min(32, rows) if track else min(32, rows // 2)
    return rows, 16 * tn * 64 // rows, depth


def split_k(k: int, chunks: int, depth: int) -> Tuple[int, int]:
    """(chunk, chunks) of k split into at most ``chunks`` chunks of whole
    slices of ``depth``: chunk = ceil(k / chunks) rounded up to the slice,
    and as many chunks as that takes (none empty); (0, 1) when k == 0."""
    if not isinstance(chunks, int) or chunks < 1:
        raise ValueError(f"chunks must be an int >= 1, got {chunks!r}")
    if k == 0:
        return 0, 1
    chunk = -(-(-(-k // chunks)) // depth) * depth
    return chunk, -(-k // chunk)


class ProductPlan(NamedTuple):
    """Launch plan of one product (``csrc/minplus.cu``): the product grid
    ``grid`` = (column tiles, row tiles, G x ``chunks``) of ``rows`` x
    ``cols`` outputs a CTA, k folded in slices of ``depth``; the k-major
    copy's grid ``kmajor_grid`` = (xt_pitch / 32, k / 32, G) of 32 x 32
    tiles ((0, 0, 0) when k == 0) into an f32 (G, k, ``xt_pitch``)
    scratch; y's rows read up to column ``ny``; ``threads`` and
    ``shared_bytes`` of dynamic shared memory a product CTA; k in
    ``chunks`` chunks of ``chunk`` (the last may be shorter; one chunk of k
    rounded up to the slice by default).  With ``chunks`` > 1 the product
    writes (chunks, G, M, N) partials of ``partial_bytes`` (values, and k
    with a witness) and ``minplus_combine`` finishes them over
    ``combine_grid`` = (N / 256, min(G * M, 65535), 1) CTAs; otherwise
    ``combine_grid`` is (0, 0, 0) and ``partial_bytes`` 0."""

    rows: int
    cols: int
    depth: int
    grid: Tuple[int, int, int]
    kmajor_grid: Tuple[int, int, int]
    xt_pitch: int
    ny: int
    threads: int
    shared_bytes: int
    chunk: int = 0
    chunks: int = 1
    combine_grid: Tuple[int, int, int] = (0, 0, 0)
    partial_bytes: int = 0

    def c_args(self) -> "_Plan":
        return _c_plan(self)

    def k_of(self, c: int, k: int) -> range:
        """The k that chunk c folds."""
        return range(c * self.chunk, min(k, (c + 1) * self.chunk))

    def knobs(self) -> dict:
        """The tuner's knobs that give this plan (``launch_plan``'s
        ``tile_rows`` and ``chunks``)."""
        return {"tile_rows": self.rows, "chunks": self.chunks}


@functools.lru_cache(maxsize=1024)
def _c_plan(plan: ProductPlan) -> "_Plan":
    """The plan as ``minplus_launch`` takes it (by address), made once a plan."""
    return _Plan(plan.rows, plan.cols, plan.depth, *plan.grid, *plan.kmajor_grid,
                 plan.xt_pitch, plan.threads, plan.shared_bytes, plan.chunk, plan.chunks,
                 plan.ny)


@functools.lru_cache(maxsize=1024)
def launch_plan(g: int, m: int, k: int, n: int, mode: str = "minplus",
                ny: Optional[int] = None, *, tile_rows: Optional[int] = None,
                chunks: Optional[int] = None) -> ProductPlan:
    """The plan the kernel runs for a (G, M, K) x (G, K, N) product in
    ``mode`` (one of :data:`MODES`), y's rows read up to column ``ny``
    (default N rounded up to 4, the limit of rows that lie ready,
    :func:`_ring_limit`).  The knobs: ``tile_rows``, the tile's rows (one of
    :data:`LATTICE_ROWS`, default 64), and ``chunks``, k split into at most
    that many chunks of whole slices (:func:`split_k`, default 1).  With no
    knob it is the plan the kernel ran before the lattice: the 64-row
    tile and k whole."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if g < 1 or m < 1 or n < 1 or k < 0:
        raise ValueError(f"a product takes G, M, N >= 1 and K >= 0, got {g}, {m}, {k}, {n}")
    bm, bn, bk = tile(TILE_ROWS if tile_rows is None else tile_rows, mode != "minplus")
    chunk, nc = split_k(k, 1 if chunks is None else chunks, bk)
    mp = -(-m // 32) * 32
    kgrid = (mp // 32, -(-k // 32), g) if k else (0, 0, 0)
    split = nc > 1
    return ProductPlan(
        bm, bn, bk, (-(-n // bn), -(-m // bm), g * nc), kgrid, mp,
        -(-n // 4) * 4 if ny is None else int(ny), THREADS, STAGES * bk * (bm + bn) * 4,
        chunk, nc,
        (-(-n // COMBINE_THREADS), min(g * m, 65535), 1) if split else (0, 0, 0),
        nc * g * m * n * (4 if mode == "minplus" else 8) if split else 0)


def _operands(x, y, a):
    """(output dtype, x, y, a), the operands in the compute dtype: f32 when
    any operand is bf16 (the mixed mode), else x's dtype."""
    out = x.dtype
    mixed = any(t is not None and t.dtype == torch.bfloat16 for t in (x, y, a))
    cd = torch.float32 if mixed else out
    return out, x.to(cd), y.to(cd), None if a is None else a.to(cd)


def _chunk(x: torch.Tensor, y: torch.Tensor) -> int:
    m, k = x.shape[-2:]
    n = y.shape[-1]
    lead = math.prod(x.shape[:-2])
    return max(1, min(k, _FOLD_BUDGET // max(1, lead * m * n)))


def _zero_like_out(x, y, sr: Semiring) -> torch.Tensor:
    shape = x.shape[:-1] + y.shape[-1:]
    return torch.full(shape, sr.zero, dtype=x.dtype, device=x.device)


def _worst(sr: Semiring) -> float:
    """The value no candidate strictly improves on: +inf under a min ⊕
    (tropical), -inf under a max ⊕ (the others)."""
    # Two host scalars decide the direction of ⊕; nothing waits for the card.
    better = bool(sr.better(torch.tensor(0.0), torch.tensor(1.0)))  # repro: allow-host-sync  CPU scalars
    return float("inf") if better else float("-inf")


def minplus_torch(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> torch.Tensor:
    """The plain version: ``a`` (or the semiring zero) ⊕ x ⊗ y, k folded a
    chunk at a time in ascending order.  The port's one plain fold:
    ``fw_round_torch`` calls it too."""
    sr = get_semiring(semiring)
    out, x, y, a = _operands(x, y, a)
    acc = _zero_like_out(x, y, sr) if a is None else a
    k = x.shape[-1]
    kc = _chunk(x, y)
    for k0 in range(0, k, kc):
        cand = sr.reduce(
            sr.mul(x[..., :, k0:k0 + kc, None], y[..., None, k0:k0 + kc, :]), dim=-2
        )
        acc = sr.add(acc, cand)
    return acc.to(out)


def minplus_argmin_torch(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the witness product: (Z, K*) with K* int32, as
    ``minplus_argmin_xla`` folds it (ascending k chunks, strict improvement,
    ties to the smallest k), under the port's NaN rule."""
    sr = get_semiring(semiring)
    out, x, y, a = _operands(x, y, a)
    acc = _zero_like_out(x, y, sr) if a is None else a
    idx = torch.full(acc.shape, -1, dtype=torch.int32, device=acc.device)
    never = _worst(sr)
    k = x.shape[-1]
    kc = _chunk(x, y)
    for k0 in range(0, k, kc):
        l = sr.mul(x[..., :, k0:k0 + kc, None], y[..., None, k0:k0 + kc, :])
        l.masked_fill_(torch.isnan(l), never)
        cand = sr.reduce(l, dim=-2)
        ka = sr.argreduce(l, dim=-2).to(torch.int32) + k0
        better = sr.better(cand, acc)
        acc = torch.where(better, cand, acc)
        idx = torch.where(better, ka, idx)
    return acc.to(out), idx


def pred_from_kstar(
    kstar: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    *,
    k_offset: int = 0,
    j_offset: int = 0,
    fallback: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Derive predecessors from argmin winners — the one shared rule, in
    plain torch (``ops.pred_from_kstar``; the oracle of ``minplus_pred``'s
    epilogue).

    ``k*`` wins for (i, j), so the path is i --(x-path)--> k* --(y-path)--> j
    and the predecessor of j is ``py[k*, j]``, unless the y-path is empty
    (k*'s global id, ``k* + k_offset``, is j's, ``j + j_offset``): then it is
    x's own last hop ``px[i, k*]``.  Where ``kstar < 0`` the entry comes from
    ``fallback`` (the old predecessors), or is -1.  Batched (G, ·, ·)
    operands work as they are.
    """
    ks = kstar.clamp(min=0).long()
    p_via = torch.gather(py, -2, ks)
    p_own = torch.gather(px, -1, ks)
    cols = torch.arange(kstar.shape[-1], device=kstar.device)
    pz = torch.where(ks + k_offset == cols + j_offset, p_own, p_via)
    kept = torch.full_like(pz, -1) if fallback is None else fallback
    return torch.where(kstar < 0, kept, pz)


def minplus_pred_torch(
    x: torch.Tensor,
    y: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    pa: Optional[torch.Tensor] = None,
    *,
    k_offset: int = 0,
    j_offset: int = 0,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the pred product: :func:`minplus_argmin_torch`
    followed by :func:`pred_from_kstar` (``pa`` the fallback)."""
    z, ks = minplus_argmin_torch(x, y, a, semiring=semiring)
    return z, pred_from_kstar(ks, px, py, k_offset=k_offset, j_offset=j_offset, fallback=pa)


class _View(ctypes.Structure):
    """``View`` of ``csrc/minplus.cu``: a (G, R, C) operand with unit column
    stride, element (g, r, c) at ``p[g * gs + r * rs + c]``."""

    _fields_ = [("p", ctypes.c_void_p), ("gs", ctypes.c_longlong), ("rs", ctypes.c_longlong)]


class _Plan(ctypes.Structure):
    """``ProductPlan`` of ``csrc/minplus.cu``."""

    _fields_ = [(f, ctypes.c_int) for f in ("bm", "bn", "bk", "gx", "gy", "gz", "kx", "ky",
                                              "kz", "mp", "threads", "smem", "chunk",
                                              "chunks")] + [
        ("ny", ctypes.c_longlong)]


def _view(t: Optional[torch.Tensor]) -> _View:
    if t is None:
        return _View(None, 0, 0)
    return _View(t.data_ptr() or None, t.stride(0) if t.ndim == 3 else 0, t.stride(-2))


def _rows_ok(t: torch.Tensor) -> bool:
    """Unit column stride (the kernel reads rows through their pitch)."""
    return t.shape[-1] <= 1 or t.stride(-1) == 1


def _check(name: str, x, y, a, dtype=torch.float32,
           what=("x", "y", "a")) -> Tuple[int, int, int, int]:
    """(g, m, k, n) of operands the kernel takes; raises on anything else."""
    for label, t in zip(what, (x, y, a)):
        if t is None:
            continue
        if not (t.is_cuda or t.is_meta):
            raise ValueError(f"{name} takes CUDA (or meta) tensors, got {label} on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} takes {dtype} {label} (ops upcasts bf16), got {t.dtype}")
        if not _rows_ok(t):
            raise ValueError(f"{name} takes {label} with unit column stride, got strides "
                             f"{t.stride()}")
    if x.ndim not in (2, 3) or y.ndim != x.ndim or x.shape[:-2] != y.shape[:-2]:
        raise ValueError(f"{name} takes (M, K) x (K, N) or (G, ·, ·) operands, got "
                         f"{tuple(x.shape)} x {tuple(y.shape)}")
    m, k = x.shape[-2:]
    k2, n = y.shape[-2:]
    if k != k2:
        raise ValueError(f"{name}: inner dimensions differ, {tuple(x.shape)} x {tuple(y.shape)}")
    if a is not None and a.shape != x.shape[:-1] + (n,):
        raise ValueError(f"{name}: {what[2]} {tuple(a.shape)} is not {x.shape[:-1] + (n,)}")
    g = x.shape[0] if x.ndim == 3 else 1
    return g, m, k, n


def _ring_limit(y: torch.Tensor, n: int) -> Optional[int]:
    """The column limit ny (N rounded up to 4) up to which the ring can copy
    y's rows as they lie, or None where it cannot: the ring copies 16-byte
    chunks, so rows must be 16-byte aligned (base, row and batch pitch a
    multiple of 4 floats), must not overlap up to ny, and the storage must
    hold the last row up to ny.  Columns in [N, ny) are read but only reach
    output columns that are never stored."""
    k = y.shape[-2]
    ny = -(-n // 4) * 4
    if not (y.data_ptr() % 16 == 0 and y.stride(-2) % 4 == 0
            and (y.ndim == 2 or y.stride(0) % 4 == 0) and (k <= 1 or y.stride(-2) >= ny)):
        return None
    if ny > n:
        g = y.shape[0] if y.ndim == 3 else 1
        end = (y.storage_offset() + (g - 1) * (y.stride(0) if y.ndim == 3 else 0)
               + (k - 1) * y.stride(-2) + ny)
        if end * y.element_size() > y.untyped_storage().nbytes():
            return None
    return ny


def ring_rows(y: torch.Tensor) -> torch.Tensor:
    """``y`` as the product kernel's ring reads it: ``y`` itself where its
    rows lie ready (:func:`_ring_limit`), else a copy into rows of pitch N
    rounded up to 32 floats, returned as a view of ``y``'s shape.  Every
    launch does this to its ``y``; a caller that passes one ``y`` to many
    launches (``spd_features``, once a hop) calls it once instead, so the
    copy is made once."""
    n = y.shape[-1]
    if y.shape[-2] == 0 or _ring_limit(y, n) is not None:
        return y
    yp = torch.empty(y.shape[:-1] + (-(-n // 32) * 32,), dtype=y.dtype, device=y.device)
    yp[..., :n].copy_(y)
    return yp[..., :n]


# The witness-fold counts' buffer of each device, made at the first witness
# launch under a profiler.
_fold_buffers: dict = {}


def _fold_buffer(device: torch.device) -> Optional[torch.Tensor]:
    """The device's counts buffer while a profiler runs on this thread,
    else None (the kernel is then given a null pointer)."""
    if not _spans._on():
        return None
    buf = _fold_buffers.get(device)
    if buf is None:
        buf = _fold_buffers[device] = torch.zeros(len(FOLD_COUNTS), dtype=torch.int64,
                                                  device=device)
    return buf


def fold_counts(device=None, *, reset: bool = False) -> dict:
    """The witness fold's counts (:data:`FOLD_COUNTS`) that the witness
    launches under a profiler have added on ``device`` (default: the
    current CUDA device), all 0 where none ran; ``reset`` sets them back
    to 0.  Synchronises with the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    buf = _fold_buffers.get(dev)
    if buf is None:
        return dict.fromkeys(FOLD_COUNTS, 0)
    counts = dict(zip(FOLD_COUNTS, buf.tolist()))  # repro: allow-host-sync  the reader's one sync
    if reset:
        buf.zero_()
    return counts


def _launch(name: str, mode: int, x, y, a, semiring, px=None, py=None, pa=None,
            k_offset: int = 0, j_offset: int = 0, plan: Optional[ProductPlan] = None,
            tile_rows: Optional[int] = None, chunks: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Check, plan with the knobs ``tile_rows`` and ``chunks``
    (:func:`launch_plan`; ``plan`` replaces it: the grid verifier hands the
    C entry point defective plans, which it must refuse), allocate and
    launch; a split plan's partials are finished by :func:`_combine`."""
    sr = get_semiring(semiring)
    g, m, k, n = _check(name, x, y, a)
    if mode == 2:
        _check(name, px, py, pa, torch.int32, ("px", "py", "pa"))
        if px.shape != x.shape:
            raise ValueError(f"{name}: px {tuple(px.shape)} is not {tuple(x.shape)}")
        if py.shape != y.shape:
            raise ValueError(f"{name}: py {tuple(py.shape)} is not {tuple(y.shape)}")
    code = semiring_code(sr, name)
    shape = x.shape[:-1] + (n,)
    z = torch.empty(shape, dtype=torch.float32, device=x.device)
    out = torch.empty(shape, dtype=torch.int32, device=x.device) if mode else None
    ny = n
    if k:
        y = ring_rows(y)
        ny = _ring_limit(y, n)
    if plan is None:
        plan = launch_plan(g, m, k, n, name, ny=ny, tile_rows=tile_rows, chunks=chunks)
    xt = torch.empty((g, k, plan.xt_pitch), dtype=torch.float32, device=x.device)
    pz = pk = None
    if plan.chunks > 1:
        pz = torch.empty((plan.chunks,) + shape, dtype=torch.float32, device=x.device)
        if mode:
            pk = torch.empty((plan.chunks,) + shape, dtype=torch.int32, device=x.device)
    work = minplus_work(g, m, k, n, mode=name, accumulate=a is not None)
    report = dict(shape=f"{g}x{m}x{k}x{n}" + (" accumulate" if a is not None else ""),
                  plan=plan)
    if not x.is_meta:
        from . import _build

        fn = _build.function("minplus", "minplus_launch",
                             [ctypes.c_int] * 3 + [_View, ctypes.c_void_p, _View, _View,
                                                   ctypes.c_void_p, ctypes.c_void_p, _View,
                                                   _View, _View, ctypes.c_void_p,
                                                   ctypes.c_void_p] + [ctypes.c_int] * 6
                             + [ctypes.POINTER(_Plan), ctypes.c_void_p, ctypes.c_void_p])
        stream = torch.cuda.current_stream(x.device).cuda_stream
        stats = _fold_buffer(x.device) if mode else None
        err = fn(code, mode, int(a is not None), _view(x), xt.data_ptr() or None, _view(y),
                 _view(a), z.data_ptr(), None if out is None else out.data_ptr(), _view(px),
                 _view(py), _view(pa), _ptr(pz), _ptr(pk), g, m, k, n, int(k_offset),
                 int(j_offset), ctypes.byref(plan.c_args()), _ptr(stats), stream)
        if err:
            raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
        _counts.bump(launches, name)
    op_cost.report_kernel(name, work, **report)
    if plan.chunks > 1:
        _combine(name, code, a, pz, pk, z, out, px, py, pa, k_offset, j_offset,
                 plan.combine_grid[:2])
    return z, out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr() or None


def _combine(name: str, code: int, a, pz, pk, z, out, px, py, pa, k_offset: int,
             j_offset: int, grid: Tuple[int, int]) -> None:
    """Launch ``minplus_combine`` over the (chunks, [G,] M, N) partials of
    a product in mode ``name`` into ``z`` and ``out`` (on ``meta``: report
    it, launch nothing)."""
    chunks = pz.shape[0]
    g = pz.shape[1] if pz.ndim == 4 else 1
    m, n = pz.shape[-2:]
    mode = MODES.index(name)
    work = minplus_combine_work(g, m, n, chunks, mode=name, accumulate=a is not None)
    report = dict(shape=f"{chunks}x{g}x{m}x{n} {name}" + (" accumulate" if a is not None
                                                         else ""),
                  plan=(chunks, *grid))
    if not pz.is_meta:
        from . import _build

        fn = _build.function("minplus", "minplus_combine_launch",
                             [ctypes.c_int] * 3 + [_View] + [ctypes.c_void_p] * 4
                             + [_View] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        err = fn(code, mode, int(a is not None), _view(a), _ptr(pz), _ptr(pk), z.data_ptr(),
                 _ptr(out), _view(px), _view(py), _view(pa), g, m, n, int(k_offset),
                 int(j_offset), chunks, *grid, torch.cuda.current_stream(pz.device).cuda_stream)
        if err:
            raise RuntimeError(f"minplus_combine kernel launch failed: cudaError_t {err}")
        _counts.bump(launches, "minplus_combine")
    op_cost.report_kernel("minplus_combine", work, **report)


def minplus_partials_torch(
    x: torch.Tensor,
    y: torch.Tensor,
    chunk: int,
    *,
    track: bool = False,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of a split product's first grid: each k chunk of
    ``chunk`` folded from the semiring zero, as (values, global k* or None)
    of shape (chunks,) + the output's (k* -1 where nothing in the chunk
    strictly improved on the zero)."""
    sr = get_semiring(semiring)
    vals, ks = [], []
    for k0 in range(0, x.shape[-1], chunk):
        xs, ys = x[..., k0:k0 + chunk], y[..., k0:k0 + chunk, :]
        if track:
            v, kk = minplus_argmin_torch(xs, ys, semiring=sr)
            ks.append(torch.where(kk < 0, kk, kk + k0))
        else:
            v = minplus_torch(xs, ys, semiring=sr)
        vals.append(v)
    return torch.stack(vals), torch.stack(ks) if track else None


def minplus_combine_torch(
    pz: torch.Tensor,
    pk: Optional[torch.Tensor] = None,
    a: Optional[torch.Tensor] = None,
    px: Optional[torch.Tensor] = None,
    py: Optional[torch.Tensor] = None,
    pa: Optional[torch.Tensor] = None,
    *,
    mode: str = "minplus",
    k_offset: int = 0,
    j_offset: int = 0,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of the split-k combine: the (chunks, [G,] M, N)
    partials folded in ascending chunk order into ``a`` (or the zero) with
    ⊕ (``mode`` "minplus"), or with the strict improvement (the witness
    modes: (Z, K*), or (Z, preds) by :func:`pred_from_kstar`)."""
    sr = get_semiring(semiring)
    acc = (torch.full(pz.shape[1:], sr.zero, dtype=torch.float32, device=pz.device)
           if a is None else a.float())
    if mode == "minplus":
        for q in range(pz.shape[0]):
            acc = sr.add(acc, pz[q])
        return acc, None
    idx = torch.full(pz.shape[1:], -1, dtype=torch.int32, device=pz.device)
    for q in range(pz.shape[0]):
        better = sr.better(pz[q], acc)
        acc = torch.where(better, pz[q], acc)
        idx = torch.where(better, pk[q], idx)
    if mode == "minplus_argmin":
        return acc, idx
    return acc, pred_from_kstar(idx, px, py, k_offset=k_offset, j_offset=j_offset,
                                fallback=pa)


def minplus_combine_cuda(
    pz: torch.Tensor,
    pk: Optional[torch.Tensor] = None,
    a: Optional[torch.Tensor] = None,
    px: Optional[torch.Tensor] = None,
    py: Optional[torch.Tensor] = None,
    pa: Optional[torch.Tensor] = None,
    *,
    mode: str = "minplus",
    k_offset: int = 0,
    j_offset: int = 0,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the split-k combine alone (the kernel a split plan's product
    launches after its partials): contiguous float32 ``pz`` and int32
    ``pk`` (witness modes) of (chunks, [G,] M, N), the rest as
    :func:`minplus_combine_torch` takes them; new (Z, K* or preds or None)
    tensors."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    sr = get_semiring(semiring)
    track = mode != "minplus"
    if not ((pz.is_cuda or pz.is_meta) and pz.dtype == torch.float32 and pz.is_contiguous()
            and pz.ndim in (3, 4)):
        raise ValueError(f"minplus_combine takes a contiguous float32 pz of (chunks, [G,] M, "
                         f"N) on the card, got {pz.dtype} {tuple(pz.shape)} on {pz.device}")
    if track and (pk is None or pk.device != pz.device or pk.dtype != torch.int32
                  or not pk.is_contiguous() or pk.shape != pz.shape):
        raise ValueError(f"minplus_combine in mode {mode} takes a contiguous int32 pk of "
                         f"{tuple(pz.shape)} beside pz")
    if a is not None and not (a.device == pz.device and a.dtype == torch.float32
                              and a.shape == pz.shape[1:] and _rows_ok(a)):
        raise ValueError(f"minplus_combine takes a float32 a of {tuple(pz.shape[1:])} with "
                         f"unit column stride beside pz, got {a.dtype} {tuple(a.shape)} on "
                         f"{a.device}")
    if mode == "minplus_pred":
        m = pz.shape[-2]
        if px is None or py is None or px.shape[-2] != m or py.shape[-1] != pz.shape[-1]:
            raise ValueError("minplus_combine in the pred mode takes px (.., M, K) and py "
                             "(.., K, N)")
        _check("minplus_combine", px, py, pa, torch.int32, ("px", "py", "pa"))
    shape = pz.shape[1:]
    z = torch.empty(shape, dtype=torch.float32, device=pz.device)
    out = torch.empty(shape, dtype=torch.int32, device=pz.device) if track else None
    g = pz.shape[1] if pz.ndim == 4 else 1
    m, n = pz.shape[-2:]
    _combine(mode, semiring_code(sr, mode), a, pz, pk if track else None, z, out, px, py, pa,
             k_offset, j_offset, (-(-n // COMBINE_THREADS), min(g * m, 65535)))
    return z, out


def minplus_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
    tile_rows: Optional[int] = None,
    chunks: Optional[int] = None,
) -> torch.Tensor:
    """Launch the CUDA kernel: a new tensor ``a ⊕ x ⊗ y`` (float32), with
    the tile rows and k chunks of :func:`launch_plan`'s knobs."""
    return _launch("minplus", 0, x, y, a, semiring, tile_rows=tile_rows, chunks=chunks)[0]


def minplus_argmin_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
    tile_rows: Optional[int] = None,
    chunks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA witness kernel: new (Z float32, K* int32) tensors."""
    return _launch("minplus_argmin", 1, x, y, a, semiring, tile_rows=tile_rows, chunks=chunks)


def minplus_pred_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    pa: Optional[torch.Tensor] = None,
    *,
    k_offset: int = 0,
    j_offset: int = 0,
    semiring: SemiringLike = "tropical",
    tile_rows: Optional[int] = None,
    chunks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA witness kernel in its pred mode: new (Z float32,
    preds int32) tensors, the preds derived from the witnesses in the
    epilogue by :func:`pred_from_kstar`'s rule (K* is never stored).  px,
    py and pa (int32) may be strided views with unit column stride."""
    return _launch("minplus_pred", 2, x, y, a, semiring, px, py, pa, k_offset, j_offset,
                   tile_rows=tile_rows, chunks=chunks)
