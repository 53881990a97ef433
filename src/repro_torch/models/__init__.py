"""Models of the PyTorch port, ported from ``repro.models``: the GNNs
(GCN / GIN / PNA), NequIP, the decoder-only LM (dense / MoE / MLA, with
its KV caches), MIND and the layers they share."""

from . import gnn, kvcache, layers, mind, mla, moe, nequip, transformer
from .gnn import GNN, GNNConfig, forward_gnn, init_gnn, loss_gnn
from .mind import MINDConfig, init_mind, mind_loss, retrieval_scores, serve_user, user_interests
from .nequip import NequIP, NequIPConfig, init_nequip, nequip_energy, nequip_energy_forces
from .transformer import LM, LMConfig, decode_step, forward, init_lm, loss_fn, prefill

__all__ = ["gnn", "kvcache", "layers", "mind", "mla", "moe", "nequip", "transformer",
           "GNN", "GNNConfig", "init_gnn", "forward_gnn", "loss_gnn", "NequIP",
           "NequIPConfig", "init_nequip", "nequip_energy", "nequip_energy_forces", "LM",
           "LMConfig", "init_lm", "forward", "loss_fn", "decode_step", "prefill",
           "MINDConfig", "init_mind", "user_interests", "mind_loss", "serve_user",
           "retrieval_scores"]
