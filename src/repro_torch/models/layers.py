"""Shared layer pieces of the PyTorch port, ported from
``repro.models.layers``: the initializer the GNN stack uses.

Divergence by design: ``dense_init`` draws from an explicit
``torch.Generator``, so the same seed gives other numbers than
``jax.random``; parity tests carry the JAX parameters across
(``core.convert.gnn_params_from_jax``).  ``constrain`` (a sharding
constraint) waits for the distributed slice; the transformer layers
(norms, attention, MLPs) wait for the LM substrate slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["dense_init"]


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)) weights, fan_in = ``shape[0]`` (1 for
    a vector), drawn in float32 on the generator's device and cast to
    ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / (fan_in ** 0.5)
    return (torch.randn(tuple(shape), generator=generator, device=generator.device)
            * std).to(dtype)
