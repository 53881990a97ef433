"""The yardstick of the kernels' roofline: the card's peak and the
problem's own work.

Peak: one (min, +) candidate a FP32 lane a cycle on an H100 SXM (NVIDIA's
data sheet): 132 SMs x 128 lanes x 1980 MHz = 3.345e13 candidates/s, the
same lane-cycles as its 67 TFLOP/s FP32.  The kernels spend two
instructions a candidate (an add and a min), so they read at most half of
it; a fused add-min could approach it, and nothing exact in float32 can
pass it.

Work: the candidates the problem itself needs, never a launch plan's: N^3
for one N-node all-pairs solve, and the sum of V_i^3 over a corpus's true
sizes.  Padding, extra rounds or a recursion that does more work therefore
read as a lower share.
"""

from __future__ import annotations

from typing import Iterable

SMS = 132
FP32_LANES_PER_SM = 128
CLOCK_MHZ = 1980
CANDIDATES_PER_S = SMS * FP32_LANES_PER_SM * CLOCK_MHZ * 1e6


def solve_work(n: int) -> int:
    """Candidates of one all-pairs solve of n nodes."""
    return int(n) ** 3


def corpus_work(sizes: Iterable[int]) -> int:
    """Candidates of a corpus solve: each graph at its true size."""
    return sum(int(v) ** 3 for v in sizes)
