"""Kernels of the PyTorch port: one hand-written CUDA kernel for each Pallas
TPU kernel of ``repro.kernels``, each beside its plain PyTorch version.

The package binds ``repro.kernels``' names: the ``ops`` dispatchers
``minplus``, ``minplus_argmin``, ``minplus_pred``, ``pred_from_kstar``,
``fw_block``, ``fw_block_pred``, ``fw_round`` and ``fw_round_pred``, and the
oracle module ``ref``, beside the ``*_cuda`` / ``*_torch`` pairs.  Three of
those names are also submodules (``minplus``, ``fw_block``, ``fw_round``):
the attribute is the function, as in ``repro.kernels``, so reach a
submodule with ``importlib.import_module("repro_torch.kernels.fw_round")``
or ``from repro_torch.kernels.fw_round import <name>``.

The CUDA sources live in ``csrc/`` and are built at first use
(``_build``), so importing this package needs neither ``nvcc`` nor CUDA.
"""

# ``ops`` imports the submodules first, so that it holds them as modules
# before the names below rebind to its functions.
from . import ops, ref
from .fw_block import fw_block_cuda, fw_block_pred_cuda, fw_block_pred_torch, fw_block_torch
from .fw_round import fw_round_cuda, fw_round_torch
from .minplus import (
    minplus_argmin_cuda,
    minplus_argmin_torch,
    minplus_cuda,
    minplus_pred_cuda,
    minplus_pred_torch,
    minplus_torch,
)
from .ops import (
    fw_block,
    fw_block_pred,
    fw_round,
    fw_round_pred,
    minplus,
    minplus_argmin,
    minplus_pred,
    pred_from_kstar,
)
from .row_close import row_close_cuda, row_close_pred_cuda, row_close_pred_torch, row_close_torch

__all__ = [
    "ops", "ref", "minplus", "minplus_argmin", "minplus_pred",
    "pred_from_kstar", "fw_block", "fw_block_pred", "fw_round",
    "fw_round_pred",
    "fw_round_cuda", "fw_round_torch",
    "minplus_cuda", "minplus_torch", "minplus_argmin_cuda", "minplus_argmin_torch",
    "minplus_pred_cuda", "minplus_pred_torch",
    "fw_block_cuda", "fw_block_torch", "fw_block_pred_cuda", "fw_block_pred_torch",
    "row_close_cuda", "row_close_torch", "row_close_pred_cuda", "row_close_pred_torch",
]
