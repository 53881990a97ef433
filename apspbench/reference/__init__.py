"""The plain reference of the benchmark's comparison.

Plain PyTorch over the inputs the harness made: it imports nothing of the
program under test and takes nothing the program made but the outputs it
judges.
"""

from .apsp import bellman_off, in_edges, pred_off, relax, sssp_rows

__all__ = ["bellman_off", "in_edges", "pred_off", "relax", "sssp_rows"]
