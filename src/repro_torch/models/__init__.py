"""Models of the PyTorch port, ported from ``repro.models``: the GNNs
(GCN / GIN / PNA), NequIP and the initializer they share.  The LM stack
and MIND wait for a later slice (ROADMAP.md queue 1)."""

from . import gnn, layers, nequip
from .gnn import GNN, GNNConfig, forward_gnn, init_gnn, loss_gnn
from .nequip import NequIP, NequIPConfig, init_nequip, nequip_energy, nequip_energy_forces

__all__ = ["gnn", "layers", "nequip", "GNN", "GNNConfig", "init_gnn", "forward_gnn",
           "loss_gnn", "NequIP", "NequIPConfig", "init_nequip", "nequip_energy",
           "nequip_energy_forces"]
