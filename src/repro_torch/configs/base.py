"""Config schema: one ArchDef per assigned architecture (+ APSP workloads).

A copy of ``repro.configs.base`` (the same data; the port imports nothing
of the JAX package).  An ArchDef carries the exact published
configuration, its shape-cell table, the optimizer/precision policy, and a
reduced smoke configuration.  ``launch.builders`` and the dry run
(``launch/dryrun.py``) turn each (arch, cell) into a step on ``meta``
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

__all__ = ["ShapeCell", "ArchDef", "LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"]


@dataclass(frozen=True)
class ShapeCell:
    shape_id: str
    kind: str              # lm_train | lm_prefill | lm_decode | gnn_train |
                           # nequip_train | mind_train | mind_serve |
                           # mind_retrieval | apsp
    settings: Dict[str, Any] = field(default_factory=dict)
    skip_reason: Optional[str] = None


@dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str            # lm | gnn | nequip | recsys | apsp
    source: str            # provenance note "[arXiv:...; tier]"
    make_config: Callable[..., Any]      # full published config (kw overrides)
    smoke_config: Callable[[], Any]      # reduced same-family config
    cells: Dict[str, ShapeCell]
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    microbatches: Optional[int] = None
    notes: str = ""


def LM_SHAPES(*, skip_long: bool, decode: bool = True) -> Dict[str, ShapeCell]:
    cells = {
        "train_4k": ShapeCell("train_4k", "lm_train",
                              {"seq_len": 4096, "batch": 256}),
        "prefill_32k": ShapeCell("prefill_32k", "lm_prefill",
                                 {"seq_len": 32768, "batch": 32}),
        "decode_32k": ShapeCell("decode_32k", "lm_decode",
                                {"seq_len": 32768, "batch": 128}),
        "long_500k": ShapeCell(
            "long_500k", "lm_decode", {"seq_len": 524288, "batch": 1},
            skip_reason=(
                "pure full-attention arch: 524k-token quadratic attention; "
                "instruction sheet says skip for non-SSM/linear archs"
            ) if skip_long else None,
        ),
    }
    if not decode:
        for k in ("decode_32k", "long_500k"):
            cells[k] = ShapeCell(cells[k].shape_id, cells[k].kind, cells[k].settings,
                                 skip_reason="encoder-only arch has no decode step")
    return cells


def GNN_SHAPES(d_feat_override: Optional[int] = None) -> Dict[str, ShapeCell]:
    return {
        "full_graph_sm": ShapeCell("full_graph_sm", "gnn_train",
                                   {"n_nodes": 2708, "n_edges": 10556,
                                    "d_feat": d_feat_override or 1433}),
        "minibatch_lg": ShapeCell("minibatch_lg", "gnn_train",
                                  {"n_nodes": 232965, "n_edges": 114615892,
                                   "batch_nodes": 1024, "fanouts": (15, 10),
                                   "d_feat": d_feat_override or 602,
                                   "sampled": True}),
        "ogb_products": ShapeCell("ogb_products", "gnn_train",
                                  {"n_nodes": 2449029, "n_edges": 61859140,
                                   "d_feat": d_feat_override or 100}),
        "molecule": ShapeCell("molecule", "gnn_train",
                              {"n_nodes": 30, "n_edges": 64, "batch": 128,
                               "d_feat": d_feat_override or 64}),
    }


def RECSYS_SHAPES() -> Dict[str, ShapeCell]:
    return {
        "train_batch": ShapeCell("train_batch", "mind_train", {"batch": 65536}),
        "serve_p99": ShapeCell("serve_p99", "mind_serve", {"batch": 512}),
        "serve_bulk": ShapeCell("serve_bulk", "mind_serve", {"batch": 262144}),
        "retrieval_cand": ShapeCell("retrieval_cand", "mind_retrieval",
                                    {"batch": 1, "n_candidates": 1_000_000}),
    }
