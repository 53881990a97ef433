"""The least time of one launch of each hand-written kernel on the card.

A launch's :class:`Work` is what its shapes make it do: candidates (each
``x ⊗ y`` folded by ⊕), instructions a candidate (two for a value fold:
⊗ and ⊕; four with a witness: ⊗, compare and two selects) and the bytes it
must move (each input read once, each output written once).  Its bound is
the larger of the instructions over the card's FP32 issue rate
(:func:`lane_rate`: SMs x lanes x clock, one instruction a lane a cycle)
and the bytes over the HBM rate.

One function a kernel, over its shapes: ``fw_round``, ``minplus`` (value,
witness and pred modes) and its split-k combine, ``fw_block`` (with and without preds) and
``row_close`` (three modes), plus the pass shapes ``chip_smoke.py`` prices
(the batched rank-k pass, an ``spd_features`` hop).  The wrappers report
the same :class:`Work` of each launch to the dry run's recorder
(``op_cost.report_kernel``), so a cell's predicted kernel time and the
kernel table's bounds are one arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .analysis import HW

__all__ = ["FP32_LANES_PER_SM", "HBM_BYTES_PER_S", "lane_rate", "Work", "fw_round_work",
           "minplus_work", "minplus_combine_work", "fw_block_work", "row_close_work", "rank_k_pass_work",
           "spd_hop_work"]

# Published H100 SXM constants (NVIDIA's data sheet): FP32 lanes an SM
# (each issues one ⊗ or one ⊕ a cycle) and the HBM3 rate.
FP32_LANES_PER_SM = HW.FP32_LANES_PER_SM
HBM_BYTES_PER_S = HW.HBM_BW


def lane_rate(sms: int = HW.SMS, clock_mhz: float = HW.CLOCK_MHZ) -> float:
    """FP32 instructions a second of ``sms`` SMs at ``clock_mhz``."""
    return sms * FP32_LANES_PER_SM * clock_mhz * 1e6


@dataclass(frozen=True)
class Work:
    """One launch's work: ``candidates`` at ``instructions`` each, and the
    ``bytes`` it must move."""

    candidates: int
    instructions: int
    bytes: int

    def ops_ms(self, rate: Optional[float] = None) -> float:
        return self.instructions * self.candidates / (rate or lane_rate()) * 1e3

    def bytes_ms(self) -> float:
        return self.bytes / HBM_BYTES_PER_S * 1e3

    def bound(self, rate: Optional[float] = None) -> Tuple[float, str]:
        """(least ms, ``"operations"`` or ``"bytes"``, whichever bounds it)."""
        o, b = self.ops_ms(rate), self.bytes_ms()
        return max(o, b), "operations" if o >= b else "bytes"


def fw_round_work(g: int, n: int, b: int, elem_size: int = 4) -> Work:
    """One fused round of G graphs of N nodes at tile B: N*N*B (update) +
    N*B*B (col') + B^3 (closure) candidates a graph at two instructions,
    against reading and writing D once."""
    return Work(g * (n * n * b + n * b * b + b ** 3), 2, g * 2 * n * n * elem_size)


_MODE_INSTRUCTIONS = {"minplus": 2, "minplus_argmin": 4, "minplus_pred": 4}


def minplus_work(g: int, m: int, k: int, n: int, *, mode: str = "minplus",
                 accumulate: bool = False) -> Work:
    """One (G, M, K) x (G, K, N) product in ``mode``: X and Y (and A) read
    once, Z written once; a witness writes K* too; the pred mode reads the
    old preds of A (with ``accumulate``) and one pred an output (the
    winner's) and writes the preds."""
    mn = m * n
    words = m * k + k * n + (mn if accumulate else 0) + mn
    if mode == "minplus_argmin":
        words += mn
    elif mode == "minplus_pred":
        words += (mn if accumulate else 0) + mn + mn
    return Work(g * m * k * n, _MODE_INSTRUCTIONS[mode], 4 * g * words)


def minplus_combine_work(g: int, m: int, n: int, chunks: int, *, mode: str = "minplus",
                         accumulate: bool = False) -> Work:
    """The split-k combine of a (G, M, K) x (G, K, N) product in ``mode``:
    ``chunks`` partials an output folded (one ⊕ each, or a compare and two
    selects with a witness), the partial values (and their k) read once,
    A read once with ``accumulate``, Z (and K* or the preds) written once;
    the pred mode reads the old preds of A and one pred an output."""
    mn = g * m * n
    track = mode != "minplus"
    words = chunks * mn * (2 if track else 1) + (mn if accumulate else 0) + mn
    if mode == "minplus_argmin":
        words += mn
    elif mode == "minplus_pred":
        words += (mn if accumulate else 0) + mn + mn
    return Work(chunks * mn, 3 if track else 1, 4 * words)


def fw_block_work(tiles: int, b: int, pred: bool = False) -> Work:
    """The closure of T tiles of B nodes: B^3 candidates a tile (four
    instructions with preds), the tiles (and preds) read and written once."""
    return Work(tiles * b ** 3, 4 if pred else 2, 4 * (4 if pred else 2) * tiles * b * b)


def row_close_work(mode: str, r: int, n: int) -> Work:
    """One row-close pass over r rows of an (n, n) matrix: r*n*n candidates
    at two instructions (four with a witness); D read once, the row ids, Z
    written once and, with a witness, K* or the preds written once and, for
    the preds, one pred read an output (the kept pred[R[i], j] or the
    winner's pred[k*, j])."""
    track = mode != "row_close"
    words = n * n + r + r * n * {"row_close": 1, "row_close_argmin": 2, "row_close_pred": 3}[mode]
    return Work(r * n * n, 4 if track else 2, 4 * words)


def rank_k_pass_work(g: int, n: int, k: int, pred: bool) -> Work:
    """One batched rank-k pass (``ops.rank_k_update`` on (G, n, n)): G*n*n*K
    candidates, the state (and preds) read and the new one written."""
    return Work(g * n * n * k, 4 if pred else 2, g * n * n * 4 * 2 * (2 if pred else 1))


def spd_hop_work(n_lm: int, n: int) -> Work:
    """One ``spd_features`` hop, ``minplus(d, h, d)`` on L x N rows: d read
    once (it is both X and A), h read once, the new d written once."""
    return Work(n_lm * n * n, 2, 4 * (n * n + 2 * n_lm * n))
