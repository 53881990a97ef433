"""Architecture registry of the PyTorch port: ``get_arch(id)`` /
``ARCH_IDS``, the ids the port runs (the paper's APSP workloads, NequIP
and the GNNs gcn-cora, gin-tu and pna).

An id the JAX package knows but the port has not ported yet raises
``NotImplementedError`` naming the slice it waits for (ROADMAP.md queue
1); an unknown id raises ``KeyError``, as in the JAX package."""

from .apsp_arch import APSP, APSPConfig
from .base import ArchDef, ShapeCell
from .gnn_archs import GCN_CORA, GIN_TU, NEQUIP, PNA

REGISTRY = {a.arch_id: a for a in (NEQUIP, GCN_CORA, GIN_TU, PNA, APSP)}

ARCH_IDS = list(REGISTRY)

# The JAX package's other ids, by the slice of the port they wait for.
_LM = "the LM and MIND substrate slice (models/transformer, moe, mla, kvcache, mind)"
UNPORTED = {
    "yi-9b": _LM, "qwen2-1.5b": _LM, "llama3-405b": _LM, "deepseek-v2-236b": _LM,
    "arctic-480b": _LM, "mind": _LM,
}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet: it waits for "
            f"{UNPORTED[arch_id]} (ROADMAP.md queue 1); the ported ids are {ARCH_IDS}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return REGISTRY[arch_id]


__all__ = ["REGISTRY", "ARCH_IDS", "UNPORTED", "get_arch", "ArchDef", "ShapeCell",
           "APSPConfig"]
