"""Data pipelines of the PyTorch port: copies of ``repro.data``'s numpy-only
modules (synthetic token / graph / interaction streams and the fanout
neighbour sampler), host arrays bit-equal to the reference's.  Callers move
them to a device."""

from .pipeline import (
    lm_batch_stream,
    mind_batch_stream,
    molecule_batch_stream,
    synthetic_graph,
)
from .sampler import CSRGraph, NeighborSampler

__all__ = [
    "lm_batch_stream",
    "mind_batch_stream",
    "synthetic_graph",
    "molecule_batch_stream",
    "CSRGraph",
    "NeighborSampler",
]
