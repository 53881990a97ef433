"""Optimizers, schedules and clipping of the PyTorch port, ported from
``repro.optim``.  Gradient compression (``optim/compression.py``) waits for
the LM substrate slice, its only user being the LM trainer (ROADMAP.md
queue 1)."""

from .optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    make_optimizer,
    sgd,
    warmup_cosine,
)

__all__ = [
    "Optimizer", "adafactor", "adamw", "clip_by_global_norm", "make_optimizer",
    "sgd", "warmup_cosine",
]
