"""The semiring codes of ``csrc/semiring.cuh``, shared by the kernel
wrappers.  The CUDA kernels know the four built-in semirings only."""

from __future__ import annotations

from repro_torch.core.semiring import BOOLEAN, BOTTLENECK, RELIABILITY, TROPICAL, Semiring

__all__ = ["semiring_code"]

_CODES = {TROPICAL: 0, BOTTLENECK: 1, RELIABILITY: 2, BOOLEAN: 3}


def semiring_code(sr: Semiring, kernel: str) -> int:
    """The code the CUDA kernels take for ``sr``; raises for a semiring
    they do not know."""
    code = _CODES.get(sr)
    if code is None:
        raise NotImplementedError(
            f"the CUDA {kernel} kernel knows the built-in semirings only, not {sr.name!r}"
        )
    return code
