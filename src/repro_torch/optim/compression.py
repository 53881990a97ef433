"""Gradient compression for the cross-pod all-reduce, ported from
``repro.optim.compression``: per-tensor symmetric int8 with error feedback
(1-bit-Adam style residual carrying) before the reduction over the
mesh's ``pod`` axis:

    q, scale = quantize(g + err)        # per-tensor symmetric int8
    g_hat    = sum(q) * mean(scale) / n_pods
    err'     = (g + err) - dequant(q)   # local residual, fed back next step

The q sum runs in int32 (no overflow across <= 127 * n pods) and the
scales are averaged over the pods, the reference's formula (each pod
contributed q_i * scale_i; the mean scale approximates them).  The two
reductions are ``all_reduce``s over the mesh's ``pod`` group; on a mesh
without process groups (one process) they are the identity with n = 1.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum", "init_error_state"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric quantization to int8 -> (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, mesh, axis: str = "pod"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf's int8 error-feedback reduction over ``axis`` of ``mesh``
    -> (the reduced mean gradient in g's dtype, the new float32 residual)."""
    n = mesh.axis_size(axis)
    x = g.float() + err
    q, scale = quantize_int8(x)
    summed = q.to(torch.int32)
    scale_sum = scale.clone()
    if mesh.groups is not None and n > 1:
        group = mesh.group(axis)
        dist.all_reduce(summed, group=group)
        dist.all_reduce(scale_sum, group=group)      # the scales differ per pod
    mean_scale = scale_sum / n
    reduced = summed.float() * mean_scale / n
    return reduced.to(g.dtype), x - dequantize_int8(q, scale)
