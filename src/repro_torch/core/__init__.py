"""Core closed-semiring APSP library of the PyTorch port (the counterpart of
``repro.core``; so far the blocked-FW solver with every round mode and
predecessors, path reconstruction, and the dynamic engine ``DynamicAPSP``
with its update journal)."""

from .apsp import (
    APSPResult,
    METHODS,
    check_negative_cycles,
    register_method,
    solve,
    validate_cost_matrix,
)
from .blocked_fw import blocked_fw, closure_block
from .dynamic import DynamicAPSP, UpdateJournal, domain_violations
from .errors import (
    APSPError,
    InputValidationError,
    NegativeCycleError,
    UpdateError,
)
from .floyd_warshall import init_pred
from .graphgen import (
    GraphSample,
    generate,
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
    validate_tree,
)
from .semiring import (
    SEMIRINGS,
    Semiring,
    get_semiring,
    pad_pred_to_multiple,
    register_semiring,
    semiring_eye,
)

__all__ = [
    "APSPResult", "METHODS", "register_method", "solve",
    "validate_cost_matrix", "check_negative_cycles", "blocked_fw",
    "closure_block", "init_pred",
    "DynamicAPSP", "UpdateJournal", "domain_violations",
    "GraphSample", "generate", "generate_edge_updates", "generate_np",
    "graph_stats", "paper_corpus",
    "reconstruct_path", "reconstruct_path_device", "reconstruct_path_jit", "path_cost",
    "validate_tree",
    "Semiring", "SEMIRINGS", "get_semiring", "register_semiring",
    "semiring_eye", "pad_pred_to_multiple",
    "APSPError", "InputValidationError", "NegativeCycleError", "UpdateError",
]
