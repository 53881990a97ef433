"""Atomic checkpoints of the PyTorch port, in the JAX package's step-dir
format (``repro.checkpoint``): a checkpoint written by either package
loads in the other."""

from .checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    load_engine_checkpoint,
    restore_onto_mesh,
    save_checkpoint,
    save_engine_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "latest_step",
    "load_checkpoint",
    "load_engine_checkpoint",
    "restore_onto_mesh",
    "save_checkpoint",
    "save_engine_checkpoint",
]
