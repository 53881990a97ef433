"""PyTorch port of the ``repro`` APSP system, for NVIDIA Hopper GPUs.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names, imports neither it nor JAX, and runs each TPU kernel's work as a
hand-written CUDA kernel.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs.
"""

from .core import (
    APSPError,
    BATCH_METHODS,
    BatchAPSPResult,
    DynamicAPSP,
    APSPResult,
    METHODS,
    InputValidationError,
    NegativeCycleError,
    SEMIRINGS,
    Semiring,
    UpdateError,
    UpdateJournal,
    blocked_fw_batch,
    domain_violations,
    fw_classic,
    fw_classic_batch,
    fw_squaring,
    fw_squaring_batch,
    fw_squaring_early_exit,
    generate_batch,
    generate_edge_updates,
    generate_np,
    get_semiring,
    minplus,
    minplus_3d,
    minplus_3d_argmin,
    minplus_pred,
    pad_batch,
    paper_corpus,
    path_cost,
    reconstruct_path,
    register_semiring,
    rkleene,
    softmin_matmul,
    solve,
    solve_batch,
    spd_features,
    tropical_eye,
    validate_tree,
)

__all__ = [
    "solve", "solve_batch", "pad_batch", "APSPResult", "BatchAPSPResult",
    "METHODS", "BATCH_METHODS", "Semiring", "SEMIRINGS", "get_semiring",
    "register_semiring", "generate_np", "generate_batch", "paper_corpus",
    "generate_edge_updates", "blocked_fw_batch", "fw_classic",
    "fw_classic_batch", "fw_squaring", "fw_squaring_batch",
    "fw_squaring_early_exit", "rkleene", "minplus", "minplus_3d",
    "minplus_3d_argmin", "minplus_pred", "softmin_matmul", "tropical_eye",
    "DynamicAPSP", "UpdateJournal", "domain_violations",
    "reconstruct_path", "path_cost", "validate_tree", "spd_features",
    "APSPError", "InputValidationError", "NegativeCycleError", "UpdateError",
]
