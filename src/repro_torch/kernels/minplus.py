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

``launches`` counts the calls of each wrapper that launched its kernel.
Each call, launched or on ``meta``, reports its work
(``roofline.kernels.minplus_work``) to the dry run's counter, if one runs
(``roofline.op_cost.report_kernel``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring, SemiringLike, get_semiring
from repro_torch.roofline import op_cost
from repro_torch.roofline.kernels import minplus_work

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
    "launches",
]

# Elements of the (..., rows, k chunk, N) broadcast the plain version builds
# at a time: a k chunk of 1 at N = 8192, the whole k at the tests' sizes.
_FOLD_BUDGET = 1 << 24

launches = {"minplus": 0, "minplus_argmin": 0, "minplus_pred": 0}


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
    return float("inf") if bool(sr.better(torch.tensor(0.0), torch.tensor(1.0))) else float("-inf")


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


def _launch(name: str, mode: int, x, y, a, semiring, px=None, py=None, pa=None,
            k_offset: int = 0, j_offset: int = 0) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
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
    mp = -(-m // 32) * 32
    xt = torch.empty((g, k, mp), dtype=torch.float32, device=x.device)
    ny = n
    if k:
        y = ring_rows(y)
        ny = _ring_limit(y, n)
    work = minplus_work(g, m, k, n, mode=name, accumulate=a is not None)
    report = dict(shape=f"{g}x{m}x{k}x{n}" + (" accumulate" if a is not None else ""),
                  plan={"xt_pitch": mp, "ny": ny})
    if x.is_meta:
        op_cost.report_kernel(name, work, **report)
        return z, out
    from . import _build

    fn = _build.function("minplus", "minplus_launch",
                         [ctypes.c_int] * 3 + [_View, ctypes.c_void_p, ctypes.c_int, _View,
                                               ctypes.c_longlong, _View, ctypes.c_void_p,
                                               ctypes.c_void_p, _View, _View, _View]
                         + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(code, mode, int(a is not None), _view(x), xt.data_ptr() or None, mp,
             _view(y), ny, _view(a), z.data_ptr(), None if out is None else out.data_ptr(),
             _view(px), _view(py), _view(pa), g, m, k, n, int(k_offset), int(j_offset), stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    _counts.bump(launches, name)
    op_cost.report_kernel(name, work, **report)
    return z, out


def minplus_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> torch.Tensor:
    """Launch the CUDA kernel: a new tensor ``a ⊕ x ⊗ y`` (float32)."""
    return _launch("minplus", 0, x, y, a, semiring)[0]


def minplus_argmin_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA witness kernel: new (Z float32, K* int32) tensors."""
    return _launch("minplus_argmin", 1, x, y, a, semiring)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA witness kernel in its pred mode: new (Z float32,
    preds int32) tensors, the preds derived from the witnesses in the
    epilogue by :func:`pred_from_kstar`'s rule (K* is never stored).  px,
    py and pa (int32) may be strided views with unit column stride."""
    return _launch("minplus_pred", 2, x, y, a, semiring, px, py, pa, k_offset, j_offset)
