"""Optimizers, schedules, clipping and the int8 gradient compression of the
PyTorch port, ported from ``repro.optim``."""

from .compression import compressed_psum, dequantize_int8, init_error_state, quantize_int8
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
    "sgd", "warmup_cosine", "quantize_int8", "dequantize_int8", "compressed_psum",
    "init_error_state",
]
