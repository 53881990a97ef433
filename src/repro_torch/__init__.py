"""PyTorch port of the ``repro`` APSP system, for NVIDIA Hopper GPUs.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names, imports neither it nor JAX, and runs each TPU kernel's work as a
hand-written CUDA kernel.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs.
"""

from .core import (
    APSPError,
    DynamicAPSP,
    APSPResult,
    InputValidationError,
    NegativeCycleError,
    SEMIRINGS,
    Semiring,
    UpdateError,
    UpdateJournal,
    domain_violations,
    generate_edge_updates,
    generate_np,
    get_semiring,
    path_cost,
    reconstruct_path,
    register_semiring,
    solve,
    validate_tree,
)

__all__ = [
    "solve", "APSPResult", "Semiring", "SEMIRINGS", "get_semiring",
    "register_semiring", "generate_np", "generate_edge_updates",
    "DynamicAPSP", "UpdateJournal", "domain_violations",
    "reconstruct_path", "path_cost", "validate_tree",
    "APSPError", "InputValidationError", "NegativeCycleError", "UpdateError",
]
