"""APSP workload configs — the paper's own technique as dry-run cells.
A copy of ``repro.configs.apsp_arch`` (the same data).

Four cells spanning the paper's regime and beyond:
  square_4k    N=4096   paper-faithful tropical squaring (FW-GPU), distributed
  blocked_16k  N=16384  distributed 3-phase blocked FW (O(n^3))
  rkleene_16k  N=16384  distributed R-Kleene (SUMMA quadrant products)
  blocked_64k  N=65536  the scale the paper could not reach (24 GB wall) —
                        65536^2 f32 = 17 GB total, 67 MB/device at 256 chips

The paper's N<=1000 ceiling came from materializing N^3; every cell here
streams tiles, so memory is N^2/devices.
"""

from __future__ import annotations

from dataclasses import dataclass

from .base import ArchDef, ShapeCell

__all__ = ["APSP", "APSPConfig"]


@dataclass(frozen=True)
class APSPConfig:
    name: str
    n: int
    method: str            # squaring | fw | rkleene
    block_size: int = 512


APSP = ArchDef(
    arch_id="apsp", family="apsp",
    source="[this paper: Anjary 2023 + D'Alberto&Nicolau 2006]",
    make_config=lambda **over: APSPConfig(**{**dict(
        name="apsp", n=16384, method="fw", block_size=512), **over}),
    smoke_config=lambda: APSPConfig(name="apsp-smoke", n=96, method="fw",
                                    block_size=16),
    cells={
        "square_4k": ShapeCell("square_4k", "apsp",
                               {"n": 4096, "method": "squaring"}),
        "blocked_16k": ShapeCell("blocked_16k", "apsp",
                                 {"n": 16384, "method": "fw", "block_size": 512}),
        "rkleene_16k": ShapeCell("rkleene_16k", "apsp",
                                 {"n": 16384, "method": "rkleene",
                                  "block_size": 512, "leaf": 8192}),
        "blocked_64k": ShapeCell("blocked_64k", "apsp",
                                 {"n": 65536, "method": "fw", "block_size": 1024}),
    },
    notes="the paper's contribution as first-class workload cells.",
)
