"""Three-term roofline of a counted (dry-run) step on the H100, ported from
``repro.roofline.analysis``.

    compute    = the step's counted work / the card's rates     (per rank)
    memory     = counted HBM bytes / HBM bandwidth              (per rank)
    collective = collective bytes / link bandwidth              (per rank)

The reference reads XLA's per-device module; the port counts rank 0's
program as it runs on ``meta`` tensors (``op_cost.OpCounter``), so the
terms divide by one card's rates directly.  Collective bytes are what the
recorded collectives would send (``Mesh.broadcast``, the all-reduces).

The compute term prices each kind of work at its own rate: bf16 and fp16
products on the tensor cores, float32 products on the CUDA cores (the port
runs them with TF32 off), elementwise PyTorch ops at one instruction an
element, and the hand-written (min, +) kernels at one instruction a lane a
cycle, two a candidate (⊗ and ⊕), four with a witness.  ``peak_flops`` of a
report is the rate that prices its counted FLOPs in that time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["HW", "RooflineReport", "collective_bytes", "analyze_counted"]


class HW:
    """One card's published rates: NVIDIA H100 80GB HBM3 (SXM5), 700 W,
    dense rates without sparsity (NVIDIA's H100 data sheet)."""

    # NVIDIA H100 80GB HBM3, 700 W: dense BF16 on the tensor cores.
    PEAK_FLOPS_BF16 = 989.4e12
    # NVIDIA H100 80GB HBM3, 700 W: FP32 on the CUDA cores (an FMA is two).
    PEAK_FLOPS_FP32 = 66.9e12
    # NVIDIA H100 80GB HBM3, 700 W: 132 SMs x 128 FP32 lanes at the 1980 MHz
    # boost clock, one instruction a lane a cycle.
    SMS = 132
    FP32_LANES_PER_SM = 128
    CLOCK_MHZ = 1980.0
    LANE_RATE = SMS * FP32_LANES_PER_SM * CLOCK_MHZ * 1e6
    # The (min, +) rate in ops/s: a candidate is two instructions (⊗ and ⊕)
    # and two ops, as ``model_flops`` counts the APSP cells (2 n^3).
    PEAK_FLOPS_MINPLUS = LANE_RATE
    # NVIDIA H100 80GB HBM3, 700 W: HBM3 bandwidth.
    HBM_BW = 3.35e12
    # NVIDIA H100 80GB HBM3, 700 W: NVLink 4, 450 GB/s each way.  Links
    # between hosts are slower; the dry run's mesh does not model them.
    NVLINK_BW = 450e9
    # NVIDIA H100 80GB HBM3: device memory, in bytes, as the dry run's
    # "fits" reads it.
    HBM_BYTES = 80e9


def rate_of(dtype: str) -> float:
    """FLOP/s of a product whose result has ``dtype`` (a torch dtype's name)."""
    return HW.PEAK_FLOPS_BF16 if dtype in ("bfloat16", "float16") else HW.PEAK_FLOPS_FP32


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Bytes per collective kind from recorded ``(kind, bytes)`` pairs (the
    reference parses them out of the HLO)."""
    out: Dict[str, int] = {}
    for kind, nbytes in records:
        out[kind] = out.get(kind, 0) + int(nbytes)
    return out


@dataclass
class RooflineReport:
    name: str
    flops: float                   # per-rank counted flops
    bytes_accessed: float          # per-rank counted HBM bytes
    coll_bytes: Dict[str, int]
    model_flops: float             # analytical reference (global)
    n_chips: int
    peak_flops: float = HW.PEAK_FLOPS_BF16
    extra: dict = field(default_factory=dict)

    @property
    def coll_total(self) -> int:
        return sum(self.coll_bytes.values())

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HW.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_total / HW.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops aggregated over ranks)."""
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful work time / achievable step time (max of the three terms)."""
        t_star = max(self.t_compute, self.t_memory, self.t_collective)
        t_useful = (self.model_flops / self.n_chips) / self.peak_flops
        return t_useful / t_star if t_star else 0.0

    def row(self) -> dict:
        return {
            "cell": self.name,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "counted_gflops_per_chip": self.flops / 1e9,
            "hbm_gb_per_chip": self.bytes_accessed / 1e9,
            "coll_gb_per_chip": self.coll_total / 1e9,
            "model_gflops_global": self.model_flops / 1e9,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            **self.extra,
        }


def analyze_counted(
    name: str,
    cost,
    model_flops: float,
    n_chips: int,
    *,
    peak_flops: Optional[float] = None,
) -> RooflineReport:
    """A report from an ``op_cost.OpCost`` (the reference's
    ``analyze_compiled``): ``peak_flops``, if not given, is the rate that
    prices the counted FLOPs in :meth:`OpCost.compute_s`'s time."""
    t = cost.compute_s()
    peak = peak_flops or (cost.flops / t if t else HW.PEAK_FLOPS_BF16)
    return RooflineReport(
        name=name,
        flops=cost.flops,
        bytes_accessed=cost.hbm_bytes,
        coll_bytes=dict(cost.coll_bytes),
        model_flops=model_flops,
        n_chips=n_chips,
        peak_flops=peak,
        extra={
            "dot_flops": cost.dot_flops,
            "dot_flops_by_dtype": dict(cost.dot_flops_by_dtype),
            "elem_ops": cost.elem_ops,
            "kernel_ops": cost.kernel_ops,
            "ops": cost.ops,
        },
    )
