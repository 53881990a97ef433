"""The train steps of the PyTorch port, ported from ``repro.train``."""

from .steps import (
    TrainState,
    init_train_state,
    make_compressed_train_step,
    make_train_step,
    pod_rows,
    train_state_specs,
)

__all__ = ["TrainState", "init_train_state", "train_state_specs", "make_train_step",
           "make_compressed_train_step", "pod_rows"]
