"""The traffic kinds: closed loops over the program's entry points, found
by name.

A traffic file (``traffic/<mix>.json``) names its ``kind`` and its
parameters; the kind is ``kinds/<kind>.py``, whose ``Loop`` class builds
the cell's inputs from the configuration and the seed, warms up, runs one
step of the loop, and after the window judges what the steps produced
against the plain reference.  One client waits for each answer before it
sends the next.  A later change adds a kind as a new file and edits none
of these.

A loop has ``warm()``, ``step(i)``, ``judge() -> {check: {value, limit}}``,
``failed`` (steps whose kept answer was off, set by ``judge``),
``items_per_step`` and ``work_per_step``; ``counters()``, where a kind has
it, returns counts of the window that the run merges into its record's
``counters`` for the metric readers.

Every comparison is exact: the costs are integers, and every distance is a
float32 integer.
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch

# rows of the sample table: step i keeps the rows of picks[i % PICK_TABLE]
PICK_TABLE = 4096


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check(value, limit) -> Dict[str, float]:
    return {"value": value, "limit": limit}


def load(kind: str) -> type:
    """The ``Loop`` class of ``kinds/<kind>.py``."""
    return importlib.import_module(f"apspbench.kinds.{kind}").Loop
