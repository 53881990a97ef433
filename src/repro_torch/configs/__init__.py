"""Architecture registry of the PyTorch port: ``get_arch(id)`` /
``ARCH_IDS``, the JAX package's 11 ids: the five LMs (yi-9b, qwen2-1.5b,
llama3-405b, deepseek-v2-236b, arctic-480b), NequIP, the GNNs gcn-cora,
gin-tu and pna, MIND and the paper's APSP workloads.  An unknown id raises
``KeyError``, as in the JAX package."""

from .apsp_arch import APSP, APSPConfig
from .base import ArchDef, ShapeCell
from .gnn_archs import GCN_CORA, GIN_TU, NEQUIP, PNA
from .lm_archs import ARCTIC_480B, DEEPSEEK_V2_236B, LLAMA3_405B, QWEN2_1_5B, YI_9B
from .recsys_archs import MIND

REGISTRY = {
    a.arch_id: a
    for a in (
        YI_9B, QWEN2_1_5B, LLAMA3_405B, DEEPSEEK_V2_236B, ARCTIC_480B,
        NEQUIP, GCN_CORA, GIN_TU, PNA,
        MIND,
        APSP,
    )
}

ARCH_IDS = list(REGISTRY)
ASSIGNED_IDS = [a for a in ARCH_IDS if a != "apsp"]


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return REGISTRY[arch_id]


__all__ = ["REGISTRY", "ARCH_IDS", "ASSIGNED_IDS", "get_arch", "ArchDef", "ShapeCell",
           "APSPConfig"]
