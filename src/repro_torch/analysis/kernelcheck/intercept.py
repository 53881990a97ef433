"""Capture the launch plans of the six CUDA wrappers, on ``meta`` tensors.

The counterpart of ``repro.analysis.kernelcheck.intercept``, which swaps
``pl.pallas_call`` for a recorder.  The port's wrappers already report
every launch, with its plan, to the running counter
(``roofline.op_cost.report_kernel``), and on ``meta`` tensors they compute
the plan, allocate nothing real and launch nothing.  So the verifier runs
a wrapper on ``meta`` copies of a case's operands inside an
``op_cost.KernelLog`` and reads back exactly the plan the card would be
handed: ``minplus.ProductPlan``, ``fw_round.RoundPlan``,
``fw_block.ClosurePlan`` and ``row_close.RowClosePlan`` (the last two are
reported as plain tuples and typed again here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List

import torch

from repro_torch.roofline import op_cost

__all__ = ["Launch", "capture", "to_meta"]


@dataclass
class Launch:
    """One reported launch: the wrapper's kernel name, shape label, plan
    and work (``roofline.kernels.Work``)."""

    kernel: str
    shape: str
    plan: Any
    work: Any


def to_meta(t):
    """A ``meta`` tensor with ``t``'s shape, strides, storage offset and
    storage size (the plan depends on the strides: the ring's ``ny``)."""
    if not isinstance(t, torch.Tensor):
        return t
    store = torch.empty(t.untyped_storage().nbytes() // t.element_size(), dtype=t.dtype,
                        device="meta")
    return store.as_strided(t.shape, t.stride(), t.storage_offset())


def _typed(kernel: str, plan):
    """The closures and the row pass report their plans as plain tuples:
    back to ``ClosurePlan`` / ``RowClosePlan``."""
    import importlib

    if kernel.startswith("fw_block"):
        return importlib.import_module("repro_torch.kernels.fw_block").ClosurePlan(*plan)
    if kernel.startswith("row_close"):
        return importlib.import_module("repro_torch.kernels.row_close").RowClosePlan(*plan)
    return plan


def capture(fn: Callable, *args, **kwargs) -> List[Launch]:
    """The launches ``fn(*args, **kwargs)`` reports, with its tensor
    arguments moved to ``meta`` first."""
    margs = [to_meta(a) for a in args]
    mkw = {k: to_meta(v) for k, v in kwargs.items()}
    with op_cost.KernelLog() as log:
        fn(*margs, **mkw)
    return [Launch(name, shape, _typed(name, plan), work)
            for name, shape, plan, work in log.launches]
