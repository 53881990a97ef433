"""Message-passing GNNs (GCN / GIN / PNA), ported from ``repro.models.gnn``.

Messages are gathered at the edges' sources, transformed, and scattered to
their destinations:

    messages = h[src] (gather)  ->  transform  ->  scatter over dst

The scatters are PyTorch's own (``index_add``, ``scatter_reduce``), as the
reference's are XLA's ``segment_sum`` / ``segment_max``: no Pallas kernel
stands behind them, so none is written here.  Graphs are dicts of dense
padded tensors, as in the reference:

    node_feat  (N, F)      float
    edge_index (2, E)      int [src; dst], padded edges point at node N-1
    node_mask  (N,)        bool (False = padding)
    edge_mask  (E,)        bool
    labels     (N,)        int (node classification) or (G,) graph tasks
    graph_ids  (N,)        int (readout segments, batched-small-graph mode)

Parameters are a tree of dicts and lists with the reference's layout
(``{"layers": [...], "out": {"w", "b"}}``); :class:`GNN` holds them as an
``nn.Module`` whose ``state_dict`` key is the JAX tree path joined with
``.`` (``layers.0.mlp.1.w``; GIN's scalar ``eps`` is a parameter), and
``GNN.tree()`` hands out the same tensors in the JAX layout for the
functional :func:`forward_gnn` / :func:`loss_gnn`.

Where the reductions tie, the gradients split as JAX's do: ``scatter_max``
shares a tied maximum's gradient evenly among the tied messages (torch's
``amax`` backward and JAX's scatter-max JVP give the same rule), and every
``maximum`` with a constant is ``torch.maximum``, which gives each side
half at a tie, as ``jnp.maximum`` does (a node with one in-edge has
variance exactly 0 in PNA's ``std``).

Divergences by design: ``init_gnn`` draws from a ``torch.Generator``
(other numbers than ``jax.random`` for the same seed) and returns the
parameter tree only (no sharding specs: the GNN cells run on one card).
On the card ``index_add`` sums in no fixed order, so results there agree
with the CPU within a tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch import nn

from .layers import dense_init, module_tree

__all__ = ["GNNConfig", "GNN", "init_gnn", "forward_gnn", "loss_gnn",
           "scatter_sum", "scatter_mean", "scatter_max", "scatter_min"]


@dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                  # gcn | gin | pna
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    aggregator: str = "mean"   # gcn: sym-norm; gin: sum; pna: mean-max-min-std
    learnable_eps: bool = True # gin
    avg_degree: float = 4.0    # pna scaler normalizer (delta)
    dropout: float = 0.0
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    batch_axes: Tuple[str, ...] = ("data",)   # the reference's sharding axes; unused here

    def with_batch_axes(self, axes) -> "GNNConfig":
        return dataclasses.replace(self, batch_axes=tuple(axes))


# ---------------------------------------------------------------------------
# scatter primitives
# ---------------------------------------------------------------------------

def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``segment_sum``: row e of ``messages`` added into row ``dst[e]``."""
    out = messages.new_zeros((n_nodes,) + tuple(messages.shape[1:]))
    return out.index_add(0, dst, messages)


def scatter_mean(messages, dst, n_nodes, edge_w=None):
    s = scatter_sum(messages, dst, n_nodes)
    ones = (messages.new_ones((messages.shape[0], 1)) if edge_w is None
            else edge_w[:, None])
    cnt = scatter_sum(ones, dst, n_nodes)
    return s / torch.maximum(cnt, cnt.new_tensor(1.0))


def scatter_max(messages, dst, n_nodes):
    """``segment_max``: -inf on a segment that receives nothing."""
    idx = dst.view((-1,) + (1,) * (messages.ndim - 1)).expand_as(messages)
    out = messages.new_full((n_nodes,) + tuple(messages.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, idx, messages, reduce="amax", include_self=True)


def scatter_min(messages, dst, n_nodes):
    return -scatter_max(-messages, dst, n_nodes)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _dense(gen, d_in, d_out, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({"w": nn.Parameter(dense_init(gen, (d_in, d_out), dtype)),
                             "b": nn.Parameter(torch.zeros(d_out, dtype=dtype))})


def _mlp_init(gen, dims, dtype) -> nn.ModuleList:
    return nn.ModuleList(_dense(gen, a, b, dtype) for a, b in zip(dims[:-1], dims[1:]))


class GNN(nn.Module):
    """The reference's GNN as a module.  ``generator`` draws the weights on
    the CPU (a seed-0 generator if None), so one seed gives one
    initial state on every device; the module is then moved to
    ``device``."""

    def __init__(self, cfg: GNNConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        dt = cfg.param_dtype
        self.layers = nn.ModuleList()
        d_in = cfg.d_feat
        for _ in range(cfg.n_layers):
            d_out = cfg.d_hidden
            layer = nn.Module()                 # GIN / PNA: named parameter groups
            if cfg.kind == "gcn":
                layer = _dense(gen, d_in, d_out, dt)
            elif cfg.kind == "gin":
                layer.mlp = _mlp_init(gen, (d_in, d_out, d_out), dt)
                layer.eps = nn.Parameter(torch.zeros((), dtype=dt))
            elif cfg.kind == "pna":
                # 4 aggregators x 3 scalers on [h_src || h_dst] messages
                layer.pre = _mlp_init(gen, (2 * d_in, d_out), dt)
                layer.post = _mlp_init(gen, (12 * d_out + d_in, d_out), dt)
            else:
                raise ValueError(cfg.kind)
            self.layers.append(layer)
            d_in = d_out
        self.out = _dense(gen, d_in, cfg.n_classes, dt)
        self.to(device)

    def tree(self) -> dict:
        """The parameters (these tensors, not copies) in the JAX layout."""
        return module_tree(self)

    def forward(self, graph: dict) -> torch.Tensor:
        return forward_gnn(self.tree(), graph, self.cfg)


def init_gnn(generator: Optional[torch.Generator], cfg: GNNConfig, *, device="cuda") -> dict:
    """The parameter tree of a new :class:`GNN` on ``device``."""
    return GNN(cfg, generator, device).tree()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mlp(params, x, act=torch.relu):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"].to(x.dtype) + lyr["b"].to(x.dtype)
        if i < len(params) - 1:
            x = act(x)
    return x


def _gcn_layer(p, h, src, dst, edge_mask, n, deg_isqrt):
    msg = h[src] * (deg_isqrt[src] * deg_isqrt[dst])[:, None]
    msg = torch.where(edge_mask[:, None], msg, 0.0)
    agg = scatter_sum(msg, dst, n) + h * deg_isqrt[:, None] ** 2  # self loop
    return agg @ p["w"].to(h.dtype) + p["b"].to(h.dtype)


def _gin_layer(p, h, src, dst, edge_mask, n):
    msg = torch.where(edge_mask[:, None], h[src], 0.0)
    agg = scatter_sum(msg, dst, n)
    return _mlp(p["mlp"], (1.0 + p["eps"]) * h + agg)


def _pna_layer(p, h, src, dst, edge_mask, n, deg, delta):
    msg = _mlp(p["pre"], torch.cat([h[src], h[dst]], dim=-1))
    m = edge_mask[:, None]
    ew = edge_mask.to(msg.dtype)
    msg0 = torch.where(m, msg, 0.0)
    big_neg = msg.new_tensor(-1e30)
    msg_mx = torch.where(m, msg, big_neg)
    mean = scatter_mean(msg0, dst, n, edge_w=ew)
    mx = torch.maximum(scatter_max(msg_mx, dst, n), big_neg)
    mx = torch.where(mx <= big_neg / 2, 0.0, mx)
    mn = scatter_min(torch.where(m, msg, -big_neg), dst, n)
    mn = torch.where(mn >= -big_neg / 2, 0.0, mn)
    sq = scatter_mean(msg0 * msg0, dst, n, edge_w=ew)
    std = torch.sqrt(torch.maximum(sq - mean * mean, sq.new_tensor(0.0)) + 1e-5)
    aggs = torch.cat([mean, mx, mn, std], dim=-1)                  # (N, 4d)
    logd = torch.log1p(deg)[:, None]
    amp = logd / delta
    att = delta / torch.maximum(logd, logd.new_tensor(1e-5))
    scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)      # (N, 12d)
    return _mlp(p["post"], torch.cat([scaled, h], dim=-1))


def forward_gnn(params, graph: dict, cfg: GNNConfig) -> torch.Tensor:
    """Returns per-node logits (N, n_classes)."""
    h = graph["node_feat"].to(cfg.compute_dtype)
    src, dst = graph["edge_index"].long()
    edge_mask = graph["edge_mask"]
    n = h.shape[0]
    ew = edge_mask.to(cfg.compute_dtype)
    deg = scatter_sum(ew, dst, n)                                   # in-degree

    if cfg.kind == "gcn":
        deg_isqrt = torch.rsqrt(deg + 1.0)                          # +1: self loop
    delta = torch.log(torch.tensor(1.0 + cfg.avg_degree, dtype=cfg.compute_dtype,
                                   device=h.device))

    for i, p in enumerate(params["layers"]):
        if cfg.kind == "gcn":
            h = _gcn_layer(p, h, src, dst, edge_mask, n, deg_isqrt)
        elif cfg.kind == "gin":
            h = _gin_layer(p, h, src, dst, edge_mask, n)
        else:
            h = _pna_layer(p, h, src, dst, edge_mask, n, deg, delta)
        if i < len(params["layers"]) - 1:
            h = torch.relu(h)
    return h @ params["out"]["w"].to(h.dtype) + params["out"]["b"].to(h.dtype)


def loss_gnn(params, graph: dict, cfg: GNNConfig):
    """Masked node-classification cross entropy -> (loss, {"loss", "acc"})."""
    logits = forward_gnn(params, graph, cfg)
    if "graph_ids" in graph:                                      # graph-level task
        g = int(graph["n_graphs"])
        logits = scatter_sum(logits, graph["graph_ids"].long(), g)
        labels = graph["labels"]
        mask = torch.ones((g,), dtype=torch.bool, device=logits.device)
    else:
        labels = graph["labels"]
        mask = graph.get("label_mask", graph["node_mask"])
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    nll = torch.where(mask, nll, 0.0)
    count = torch.clamp(mask.sum(), min=1)
    loss = nll.sum() / count
    acc = torch.where(mask, logp.argmax(-1) == labels, False).sum() / count
    return loss, {"loss": loss, "acc": acc}
