"""The train step of the PyTorch port, ported from ``repro.train``."""

from .steps import TrainState, init_train_state, make_train_step

__all__ = ["TrainState", "init_train_state", "make_train_step"]
