"""The GNN architectures of the PyTorch port: nequip, gcn-cora, gin-tu and
pna, the published configs and smoke configs of ``repro.configs.gnn_archs``
letter for letter, on the port's ``NequIPConfig`` and ``GNNConfig`` (dtype
fields are torch dtypes).

Paper-technique tie-in: GCN/GIN/PNA can take landmark shortest-path
features computed by the tropical solver (``core.paths.spd_features``)
appended to their node features, as ``examples/gnn_node_classification.py``
does; off by default, to keep the published architectures unmodified.
NequIP trains on energy alone, as the reference does; its forces are one
gradient with respect to the positions.
"""

from __future__ import annotations

from repro_torch.models.gnn import GNNConfig
from repro_torch.models.nequip import NequIPConfig

from .base import GNN_SHAPES, ArchDef

__all__ = ["NEQUIP", "GCN_CORA", "GIN_TU", "PNA"]


NEQUIP = ArchDef(
    arch_id="nequip", family="nequip", source="[arXiv:2101.03164; paper]",
    make_config=lambda **over: NequIPConfig(
        **{**dict(name="nequip", n_layers=5, d_hidden=32, l_max=2, n_rbf=8,
                  cutoff=5.0, n_species=64), **over}
    ),
    smoke_config=lambda: NequIPConfig(
        name="nequip-smoke", n_layers=2, d_hidden=8, n_rbf=4, n_species=8
    ),
    cells=GNN_SHAPES(),
    optimizer="adamw", learning_rate=1e-3,
    notes="E(3)-equivariant tensor products l<=2; energy model, forces via "
          "autodiff. Runs the GNN shape cells on positions/species inputs.",
)


GCN_CORA = ArchDef(
    arch_id="gcn-cora", family="gnn", source="[arXiv:1609.02907; paper]",
    make_config=lambda **over: GNNConfig(
        **{**dict(name="gcn-cora", kind="gcn", n_layers=2, d_hidden=16,
                  d_feat=1433, n_classes=7, aggregator="mean"), **over}
    ),
    smoke_config=lambda: GNNConfig(
        name="gcn-smoke", kind="gcn", n_layers=2, d_hidden=8, d_feat=16,
        n_classes=4,
    ),
    cells=GNN_SHAPES(),
    optimizer="adamw", learning_rate=1e-2,
)

GIN_TU = ArchDef(
    arch_id="gin-tu", family="gnn", source="[arXiv:1810.00826; paper]",
    make_config=lambda **over: GNNConfig(
        **{**dict(name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
                  d_feat=64, n_classes=2, aggregator="sum",
                  learnable_eps=True), **over}
    ),
    smoke_config=lambda: GNNConfig(
        name="gin-smoke", kind="gin", n_layers=2, d_hidden=8, d_feat=8,
        n_classes=2,
    ),
    cells=GNN_SHAPES(),
    optimizer="adamw", learning_rate=1e-2,
)

PNA = ArchDef(
    arch_id="pna", family="gnn", source="[arXiv:2004.05718; paper]",
    make_config=lambda **over: GNNConfig(
        **{**dict(name="pna", kind="pna", n_layers=4, d_hidden=75,
                  d_feat=75, n_classes=10,
                  aggregator="mean-max-min-std"), **over}
    ),
    smoke_config=lambda: GNNConfig(
        name="pna-smoke", kind="pna", n_layers=2, d_hidden=8, d_feat=8,
        n_classes=3,
    ),
    cells=GNN_SHAPES(),
    optimizer="adamw", learning_rate=3e-3,
    notes="aggregators mean/max/min/std x scalers id/amplification/attenuation.",
)
