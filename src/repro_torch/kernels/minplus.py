"""The tiled ⊕⊗ product, with and without a witness: the CUDA kernel's
wrappers and their plain versions.

Ports ``repro.kernels.minplus.minplus_pallas`` and ``minplus_argmin_pallas``
(the TPU kernels, one body with two flags) and the folds of
``repro.kernels.minplus_xla`` (``minplus_xla``, ``minplus_argmin_xla``).  On
(M, K) x (K, N) operands, or a batch (G, M, K) x (G, K, N):

  minplus         Z = [A ⊕] ⊕_k X[:, k] ⊗ Y[k, :]
  minplus_argmin  (Z, K*): K*[i, j] the smallest k whose candidate strictly
                  improved on the start value (A, or the semiring zero), -1
                  where none did.  Strict improvement from the zero leaves
                  -1 exactly where the reference's ``is_zero`` mask does.

Both fold k in ascending order.  ⊕ is selective and each candidate is one
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

* :func:`minplus_torch` and :func:`minplus_argmin_torch` are the plain
  versions: they run for CPU tensors, and the tests and ``chip_smoke.py``
  hold the kernel against them.
* :func:`minplus_cuda` and :func:`minplus_argmin_cuda` launch the
  hand-written kernel (``csrc/minplus.cu``) on float32 CUDA tensors.

``launches`` counts the calls of each wrapper that launched its kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.semiring import Semiring, SemiringLike, get_semiring

from ._codes import semiring_code

__all__ = [
    "minplus_torch",
    "minplus_argmin_torch",
    "minplus_cuda",
    "minplus_argmin_cuda",
    "launches",
]

# Elements of the (..., rows, k chunk, N) broadcast the plain version builds
# at a time: a k chunk of 1 at N = 8192, the whole k at the tests' sizes.
_FOLD_BUDGET = 1 << 24

launches = {"minplus": 0, "minplus_argmin": 0}


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


def _check(name: str, x, y, a) -> Tuple[int, int, int, int]:
    """(g, m, k, n) of operands the kernel takes; raises on anything else."""
    for t in (x, y) + (() if a is None else (a,)):
        if not t.is_cuda:
            raise ValueError(f"{name} takes CUDA tensors, got one on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 (ops upcasts bf16), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if x.ndim not in (2, 3) or y.ndim != x.ndim or x.shape[:-2] != y.shape[:-2]:
        raise ValueError(f"{name} takes (M, K) x (K, N) or (G, ·, ·) operands, got "
                         f"{tuple(x.shape)} x {tuple(y.shape)}")
    m, k = x.shape[-2:]
    k2, n = y.shape[-2:]
    if k != k2:
        raise ValueError(f"{name}: inner dimensions differ, {tuple(x.shape)} x {tuple(y.shape)}")
    if a is not None and a.shape != x.shape[:-1] + (n,):
        raise ValueError(f"{name}: accumulator {tuple(a.shape)} is not {x.shape[:-1] + (n,)}")
    g = x.shape[0] if x.ndim == 3 else 1
    return g, m, k, n


def _launch(name: str, x, y, a, track: bool, semiring) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    sr = get_semiring(semiring)
    g, m, k, n = _check(name, x, y, a)
    code = semiring_code(sr, name)
    shape = x.shape[:-1] + (n,)
    z = torch.empty(shape, dtype=torch.float32, device=x.device)
    ks = torch.empty(shape, dtype=torch.int32, device=x.device) if track else None
    from . import _build

    fn = _build.load("minplus").minplus_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(code, int(track), int(a is not None), x.data_ptr(), y.data_ptr(),
             None if a is None else a.data_ptr(), z.data_ptr(),
             None if ks is None else ks.data_ptr(), g, m, k, n, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launches[name] += 1
    return z, ks


def minplus_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> torch.Tensor:
    """Launch the CUDA kernel: a new tensor ``a ⊕ x ⊗ y`` (float32)."""
    return _launch("minplus", x, y, a, False, semiring)[0]


def minplus_argmin_cuda(
    x: torch.Tensor,
    y: torch.Tensor,
    a: Optional[torch.Tensor] = None,
    *,
    semiring: SemiringLike = "tropical",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA witness kernel: new (Z float32, K* int32) tensors."""
    return _launch("minplus_argmin", x, y, a, True, semiring)
