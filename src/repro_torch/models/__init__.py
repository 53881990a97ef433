"""Models of the PyTorch port, ported from ``repro.models``: the GNNs
(GCN / GIN / PNA) and the initializer they share.  NequIP, the LM stack
and MIND wait for later slices (ROADMAP.md queue 1)."""

from . import gnn, layers
from .gnn import GNN, GNNConfig, forward_gnn, init_gnn, loss_gnn

__all__ = ["gnn", "layers", "GNN", "GNNConfig", "init_gnn", "forward_gnn", "loss_gnn"]
