"""Shared layer pieces of the PyTorch port, ported from
``repro.models.layers``: the initializer the GNN stack and NequIP use,
and the walk that hands a module's parameters out in the JAX layout.

Divergence by design: ``dense_init`` draws from an explicit
``torch.Generator``, so the same seed gives other numbers than
``jax.random``; parity tests carry the JAX parameters across
(``core.convert.gnn_params_from_jax``).  ``constrain`` (a sharding
constraint, used only by the LM trainer) and the transformer layers
(norms, attention, MLPs) wait for the LM substrate slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["dense_init", "module_tree"]


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)) weights, fan_in = ``shape[0]`` (1 for
    a vector), drawn in float32 on the generator's device and cast to
    ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / (fan_in ** 0.5)
    return (torch.randn(tuple(shape), generator=generator, device=generator.device)
            * std).to(dtype)


def module_tree(module: nn.Module):
    """The module's parameters (these tensors, not copies) in the JAX
    layout: a ParameterDict is a dict, a ModuleList a list, any other
    module a dict of its own parameters and children."""
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    if isinstance(module, nn.ModuleList):
        return [module_tree(m) for m in module]
    out = dict(module.named_parameters(recurse=False))
    out.update({k: module_tree(m) for k, m in module.named_children()})
    return out
