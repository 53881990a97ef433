"""Kernels of the PyTorch port: one hand-written CUDA kernel for each Pallas
TPU kernel of ``repro.kernels``, each beside its plain PyTorch version.

The CUDA sources live in ``csrc/`` and are built at first use
(``_build``), so importing this package needs neither ``nvcc`` nor CUDA.
"""

from . import ops
from .fw_block import fw_block_cuda, fw_block_pred_cuda, fw_block_pred_torch, fw_block_torch
from .fw_round import fw_round_cuda, fw_round_torch
from .minplus import minplus_argmin_cuda, minplus_argmin_torch, minplus_cuda, minplus_torch
from .row_close import row_close_cuda, row_close_torch

__all__ = [
    "ops",
    "fw_round_cuda", "fw_round_torch",
    "minplus_cuda", "minplus_torch", "minplus_argmin_cuda", "minplus_argmin_torch",
    "fw_block_cuda", "fw_block_torch", "fw_block_pred_cuda", "fw_block_pred_torch",
    "row_close_cuda", "row_close_torch",
]
