"""Core closed-semiring APSP library of the PyTorch port (the counterpart of
``repro.core``): the five solvers (squaring, its 3D-tensor form, classic
FW, blocked FW, R-Kleene) behind ``solve`` and the batch engine
``solve_batch``, predecessors and path reconstruction, the paper's graph
generator and corpus, the dynamic engine ``DynamicAPSP`` with its update
journal, and ``spd_features``, the landmark shortest-path features of the
GNN stack."""

from .apsp import (
    APSPResult,
    BATCH_METHODS,
    BatchAPSPResult,
    METHODS,
    check_negative_cycles,
    pad_batch,
    register_method,
    solve,
    solve_batch,
    validate_cost_matrix,
)
from .blocked_fw import blocked_fw, blocked_fw_batch, closure_block
from .dynamic import DynamicAPSP, UpdateJournal, apply_updates_batched, domain_violations
from .errors import (
    APSPError,
    InputValidationError,
    NegativeCycleError,
    UpdateError,
)
from .floyd_warshall import (
    fw_classic,
    fw_classic_batch,
    fw_squaring,
    fw_squaring_batch,
    fw_squaring_early_exit,
    init_pred,
)
from .graphgen import (
    GraphSample,
    generate,
    generate_batch,
    generate_edge_updates,
    generate_np,
    graph_stats,
    paper_corpus,
)
from .paths import (
    path_cost,
    reconstruct_path,
    reconstruct_path_device,
    reconstruct_path_jit,
    spd_features,
    validate_tree,
)
from .rkleene import rkleene
from .semiring import (
    SEMIRINGS,
    Semiring,
    get_semiring,
    minplus,
    minplus_3d,
    minplus_3d_argmin,
    minplus_pred,
    pad_pred_to_multiple,
    register_semiring,
    semiring_eye,
    softmin_matmul,
    tropical_eye,
)

__all__ = [
    "APSPResult", "BatchAPSPResult", "METHODS", "BATCH_METHODS",
    "register_method", "solve", "solve_batch", "pad_batch",
    "validate_cost_matrix", "check_negative_cycles", "blocked_fw",
    "blocked_fw_batch", "closure_block", "fw_classic", "fw_classic_batch",
    "fw_squaring", "fw_squaring_batch", "fw_squaring_early_exit", "init_pred",
    "rkleene", "minplus", "minplus_3d", "minplus_3d_argmin", "minplus_pred",
    "softmin_matmul", "tropical_eye",
    "DynamicAPSP", "UpdateJournal", "apply_updates_batched", "domain_violations",
    "GraphSample", "generate", "generate_batch", "generate_edge_updates",
    "generate_np", "graph_stats", "paper_corpus",
    "reconstruct_path", "reconstruct_path_device", "reconstruct_path_jit", "path_cost",
    "validate_tree", "spd_features",
    "Semiring", "SEMIRINGS", "get_semiring", "register_semiring",
    "semiring_eye", "pad_pred_to_multiple",
    "APSPError", "InputValidationError", "NegativeCycleError", "UpdateError",
]
