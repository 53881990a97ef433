"""(ArchDef, cell, mesh) -> dry-runnable step, ported from
``repro.launch.builders``: fn + abstract args + in/out shardings.  One
builder per cell kind; all state is abstract: tensors on the ``meta``
device, the counterpart of ``jax.ShapeDtypeStruct``, so nothing is
allocated for the dry run, not even at ``llama3-405b`` width.

What a :class:`DryRunnable` runs on the mesh is rank 0's program.  The
APSP cells run the distributed solvers on the rank's block, as they run on
real ranks.  The LM, GNN, NequIP and MIND steps of the port run one program
a rank and the port has no FSDP or tensor-parallel execution, so their
steps are traced in the **data-parallel view**: the full-width parameters
and state (``trace_local`` False), the rank's block of the batch
(``trace_local`` True).  The in/out shardings keep the reference's specs,
and the argument bytes a rank holds are read from them.

``DryRunnable.concrete(device, seed)`` draws real arguments of the same
shapes and dtypes (parameters from the model's own init, ids inside their
tables, a generated graph for APSP): what ``chip_smoke.py`` runs on the card
against the dry run's prediction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._device import _device_constructors

from repro_torch.configs import ArchDef, ShapeCell
from repro_torch.launch.mesh import Mesh
from repro_torch.models import kvcache as kvc
from repro_torch.models.gnn import init_gnn, loss_gnn
from repro_torch.models.mind import init_mind, mind_loss, retrieval_scores, serve_user
from repro_torch.models.nequip import init_nequip, nequip_energy, nequip_energy_batch
from repro_torch.models.transformer import decode_step, init_lm, loss_fn as lm_loss, prefill
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.sharding import P, Sharding, batch_axes_for, make_shardings
from repro_torch.train import init_train_state, make_train_step, train_state_specs
from repro_torch.tree import leaves, tree_map

__all__ = ["DryRunnable", "build_cell", "abstract_init", "abstract_cache", "meta_factories"]

META = torch.device("meta")


def _pad_to(n: int, m: int = 512) -> int:
    """Round a sharded dim up to a multiple of every mesh size (512 covers
    256 too) — padded tail is masked out semantically."""
    return (n + m - 1) // m * m


@dataclass
class DryRunnable:
    name: str
    fn: Callable
    args: Tuple            # trees of meta tensors at the global shapes
    in_shardings: Any
    out_shardings: Any
    model_flops: float     # 6*N*D (dense) / 6*N_active*D analytical reference
    note: str = ""
    donate_argnums: Tuple[int, ...] = ()
    # Per argument: whether the trace takes the rank's block (True) or the
    # whole argument (False: the data-parallel view's full-width state).
    trace_local: Tuple[bool, ...] = ()
    train: bool = False    # a train step (autograd on); else run under no_grad
    # Draws real arguments: (device, seed) -> args.
    make_args: Optional[Callable] = field(default=None, repr=False)

    def concrete(self, device, seed: int = 0) -> Tuple:
        """Real arguments of the args' shapes and dtypes on ``device``."""
        return self.make_args(torch.device(device), seed)


class meta_factories(TorchFunctionMode):
    """Inside it every tensor factory (``torch.randn``, ``zeros``, ``empty``,
    ...) makes its tensor on ``meta``, whatever device it names: an init
    run inside draws nothing, on the host or the card."""

    _constructors = _device_constructors()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._constructors:
            kwargs["device"] = META
        return func(*args, **kwargs)


def abstract_init(init_fn, cfg, generator: Optional[torch.Generator] = None):
    """(params, specs) of ``init_fn(generator, cfg)`` on ``meta``: nothing is
    drawn (the reference's ``eval_shape``)."""
    with meta_factories():
        return init_fn(generator or torch.Generator(), cfg)


def _tree_size(tree) -> int:
    return sum(math.prod(l.shape) if l.shape else 1 for l in leaves(tree))


def _param_count(params) -> int:
    return _tree_size(params)


def abstract_cache(init_cache, cfg, b, sl):
    """(cache, specs) of ``init_cache(cfg, b, sl)`` on ``meta``."""
    return init_cache(cfg, b, sl, device=META)


def _sh(mesh, spec):
    return Sharding(mesh, spec)


def _scalar_sh(mesh):
    return Sharding(mesh, P())


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _draw(sds: dict, highs: Dict[str, int], device, gen: torch.Generator) -> dict:
    """Real leaves for a batch of meta leaves: integer ids uniform below
    ``highs[key]``, masks all True, floats standard normal."""
    out = {}
    for k, v in sds.items():
        if v.dtype == torch.bool:
            out[k] = torch.ones(v.shape, dtype=torch.bool, device=device)
        elif v.dtype.is_floating_point:
            out[k] = torch.randn(v.shape, generator=gen, device=device).to(v.dtype)
        else:
            out[k] = torch.randint(0, highs[k], v.shape, generator=gen, device=device,
                                   dtype=v.dtype)
    return out


def _gen(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_active_params(cfg, n_params: int) -> float:
    """Active params per token for the MODEL_FLOPS = 6*N_active*D reference."""
    if not cfg.moe:
        return float(n_params)
    # subtract non-activated expert weights
    expert = 3 * cfg.d_model * cfg.moe_d_ff
    moe_layers = cfg.n_layers - cfg.first_k_dense
    inactive = moe_layers * (cfg.n_experts - cfg.moe_top_k) * expert
    return float(n_params - inactive)


def _lm_params(cfg, device, seed):
    return init_lm(_gen(device, seed), cfg)[0]


def build_lm_train(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    ba = batch_axes_for(mesh)
    cfg = arch.make_config(batch_axes=ba)
    s = cell.settings
    b, sl = s["batch"], s["seq_len"]
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 2000, 100_000))

    params_sds, param_specs = abstract_init(init_lm, cfg)
    with meta_factories():
        state_sds = init_train_state(params_sds, opt)
    state_specs = train_state_specs(param_specs, opt)
    state_sh = make_shardings(mesh, state_specs)

    batch_sds = {
        "tokens": _meta((b, sl), torch.int32),
        "labels": _meta((b, sl), torch.int32),
    }
    batch_sh = {k: _sh(mesh, P(ba, None)) for k in batch_sds}

    step = make_train_step(
        lambda p, bt: lm_loss(p, bt, cfg), opt, microbatches=arch.microbatches,
        param_specs=param_specs,
    )
    n = _param_count(params_sds)
    tokens = b * sl
    model_flops = 6.0 * _lm_active_params(cfg, n) * tokens

    def make_args(device, seed):
        state = init_train_state(_lm_params(cfg, device, seed), opt)
        return state, _draw(batch_sds, {"tokens": cfg.vocab, "labels": cfg.vocab}, device,
                            _gen(device, seed + 1))

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=step,
        args=(state_sds, batch_sds),
        in_shardings=(state_sh, batch_sh),
        out_shardings=(state_sh, _scalar_sh(mesh)),
        model_flops=model_flops,
        note=f"params={n/1e9:.1f}B tokens/step={tokens}",
        trace_local=(False, True),
        train=True,
        make_args=make_args,
    )


def build_lm_prefill(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    ba = batch_axes_for(mesh)
    cfg = arch.make_config(batch_axes=ba)
    s = cell.settings
    b, sl = s["batch"], s["seq_len"]
    params_sds, param_specs = abstract_init(init_lm, cfg)
    params_sh = make_shardings(mesh, param_specs)

    init_cache = kvc.init_mla_cache if cfg.mla else kvc.init_gqa_cache
    _, cache_specs = abstract_cache(init_cache, cfg, b, sl)
    cache_sh = make_shardings(mesh, cache_specs)

    fn = lambda p, t: prefill(p, t, cfg, sl)
    tok_sds = _meta((b, sl), torch.int32)
    n = _param_count(params_sds)
    model_flops = 2.0 * _lm_active_params(cfg, n) * b * sl   # fwd only

    def make_args(device, seed):
        return (_lm_params(cfg, device, seed),
                _draw({"t": tok_sds}, {"t": cfg.vocab}, device, _gen(device, seed + 1))["t"])

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=fn,
        args=(params_sds, tok_sds),
        in_shardings=(params_sh, _sh(mesh, P(ba, None))),
        out_shardings=(_sh(mesh, P(ba, None)), cache_sh),
        model_flops=model_flops,
        note=f"params={n/1e9:.1f}B prefill tokens={b*sl}",
        trace_local=(False, True),
        make_args=make_args,
    )


def build_lm_decode(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    ba = batch_axes_for(mesh)
    cfg = arch.make_config(batch_axes=ba)
    s = cell.settings
    b, sl = s["batch"], s["seq_len"]
    params_sds, param_specs = abstract_init(init_lm, cfg)
    params_sh = make_shardings(mesh, param_specs)

    init_cache = kvc.init_mla_cache if cfg.mla else kvc.init_gqa_cache
    cache_sds, cache_specs = abstract_cache(init_cache, cfg, b, sl)
    cache_sh = make_shardings(mesh, cache_specs)

    fn = lambda p, c, t: decode_step(p, c, t, cfg)   # cache written in place
    tok_sds = _meta((b, 1), torch.int32)
    n = _param_count(params_sds)
    model_flops = 2.0 * _lm_active_params(cfg, n) * b        # one token each

    def make_args(device, seed):
        cache, _ = init_cache(cfg, b, sl, device=device)
        cache.length.fill_(sl - 1)
        return (_lm_params(cfg, device, seed), cache,
                _draw({"t": tok_sds}, {"t": cfg.vocab}, device, _gen(device, seed + 1))["t"])

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=fn,
        args=(params_sds, cache_sds, tok_sds),
        in_shardings=(params_sh, cache_sh, _sh(mesh, P(ba, None))),
        out_shardings=(_sh(mesh, P(ba, "model")), cache_sh),
        model_flops=model_flops,
        note=f"params={n/1e9:.1f}B decode batch={b} kv={sl}",
        donate_argnums=(1,),
        trace_local=(False, True, True),
        make_args=make_args,
    )


# ---------------------------------------------------------------------------
# GNN cells (gcn / gin / pna)
# ---------------------------------------------------------------------------

def _gnn_graph_sds(s: dict, edge_axes) -> Tuple[dict, dict]:
    if s.get("sampled"):
        seeds, fanouts = s["batch_nodes"], s["fanouts"]
        n = seeds
        max_nodes, max_edges = seeds, 0
        for f in fanouts:
            e = n * f
            max_edges += e
            max_nodes += e
            n = e
        nn, ne = max_nodes, max_edges
    else:
        nn, ne = s["n_nodes"], s["n_edges"]
    ne = _pad_to(ne)                      # edge dim shards over all devices
    # big graphs: shard the node dim too (padded); small ones replicate
    node_axes = edge_axes if nn > 500_000 else None
    if node_axes is not None:
        nn = _pad_to(nn)
    d = s["d_feat"]
    sds = {
        "node_feat": _meta((nn, d), torch.float32),
        "edge_index": _meta((2, ne), torch.int32),
        "edge_mask": _meta((ne,), torch.bool),
        "node_mask": _meta((nn,), torch.bool),
        "labels": _meta((nn,), torch.int32),
    }
    sh = {
        "node_feat": P(node_axes, None),
        "edge_index": P(None, edge_axes),
        "edge_mask": P(edge_axes),
        "node_mask": P(node_axes),
        "labels": P(node_axes),
    }
    if s.get("sampled"):
        sds["label_mask"] = _meta((nn,), torch.bool)
        sh["label_mask"] = P(None)
    return sds, sh


def _replicated_init(init_fn, device=META):
    """An init of the port that returns the parameter tree alone (the GNN,
    NequIP: drawn on the host, then moved) as ``(params, specs)`` on
    ``device``, every spec replicated, as the reference's are."""
    def init(gen, cfg):
        params = init_fn(gen, cfg, device=device)
        return params, tree_map(lambda _: P(), params)

    return init


def build_gnn_train(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    s = dict(cell.settings)
    all_axes = tuple(mesh.axis_names)          # edges shard over every axis

    cfg = arch.make_config(d_feat=s["d_feat"], batch_axes=all_axes)
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 100, 10_000))
    if s.get("batch"):                          # molecule: disjoint union batch
        nn = s["n_nodes"] * s["batch"]
        ne = s["n_edges"] * s["batch"]
        s = {**s, "n_nodes": nn, "n_edges": ne, "sampled": False}

    params_sds, param_specs = abstract_init(_replicated_init(init_gnn), cfg)
    with meta_factories():
        state_sds = init_train_state(params_sds, opt)
    state_specs = train_state_specs(param_specs, opt)
    state_sh = make_shardings(mesh, state_specs)

    graph_sds, graph_spec = _gnn_graph_sds(s, all_axes)
    graph_sh = {k: _sh(mesh, v) for k, v in graph_spec.items()}

    step = make_train_step(lambda p, g: loss_gnn(p, g, cfg), opt)
    ne = graph_sds["edge_index"].shape[1]
    nn = graph_sds["node_feat"].shape[0]
    # reference flops: gather+2 matmuls per layer ~ 2*E*d_in*1 + 2*N*d_in*d_out
    model_flops = float(cfg.n_layers) * (2.0 * ne * cfg.d_hidden + 2.0 * nn * cfg.d_hidden * cfg.d_hidden) * 3

    def make_args(device, seed):
        params = init_gnn(torch.Generator().manual_seed(seed), cfg, device=device)
        highs = {"edge_index": nn, "labels": cfg.n_classes}
        return init_train_state(params, opt), _draw(graph_sds, highs, device,
                                                    _gen(device, seed + 1))

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=step,
        args=(state_sds, graph_sds),
        in_shardings=(state_sh, graph_sh),
        out_shardings=(state_sh, _scalar_sh(mesh)),
        model_flops=model_flops,
        note=f"nodes={nn} edges={ne}",
        trace_local=(False, True),
        train=True,
        make_args=make_args,
    )


# ---------------------------------------------------------------------------
# NequIP cells
# ---------------------------------------------------------------------------

def build_nequip_train(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    s = dict(cell.settings)
    all_axes = tuple(mesh.axis_names)
    cfg = arch.make_config(batch_axes=all_axes)
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 100, 10_000))

    batched = bool(s.get("batch"))
    if s.get("sampled"):
        seeds, fanouts = s["batch_nodes"], s["fanouts"]
        n = seeds
        nn, ne = seeds, 0
        for f in fanouts:
            e = n * f
            ne += e
            nn += e
            n = e
    else:
        nn, ne = s["n_nodes"], s["n_edges"]
    if not s.get("batch"):
        ne = _pad_to(ne)

    params_sds, param_specs = abstract_init(_replicated_init(init_nequip), cfg)
    with meta_factories():
        state_sds = init_train_state(params_sds, opt)
    state_specs = train_state_specs(param_specs, opt)
    state_sh = make_shardings(mesh, state_specs)

    if batched:
        b = s["batch"]
        ba = batch_axes_for(mesh)
        batch_sds = {
            "positions": _meta((b, nn, 3), torch.float32),
            "species": _meta((b, nn), torch.int32),
            "edge_index": _meta((b, 2, ne), torch.int32),
            "edge_mask": _meta((b, ne), torch.bool),
            "node_mask": _meta((b, nn), torch.bool),
            "energy": _meta((b,), torch.float32),
        }
        batch_sh = {
            k: _sh(mesh, P(*((ba,) + (None,) * (len(v.shape) - 1))))
            for k, v in batch_sds.items()
        }

        def loss_fn(p, bt):
            # The reference vmaps the molecules; the port evaluates the
            # batch as one disjoint graph (ROADMAP.md, "Divergences").
            e = nequip_energy_batch(p, bt, cfg)
            loss = torch.mean((e - bt["energy"]) ** 2)
            return loss, {"loss": loss}
    else:
        node_axes = all_axes if nn > 500_000 else None
        if node_axes is not None:
            nn = _pad_to(nn)          # sharded node dim must divide evenly
        batch_sds = {
            "positions": _meta((nn, 3), torch.float32),
            "species": _meta((nn,), torch.int32),
            "edge_index": _meta((2, ne), torch.int32),
            "edge_mask": _meta((ne,), torch.bool),
            "node_mask": _meta((nn,), torch.bool),
            "energy": _meta((), torch.float32),
        }
        batch_sh = {
            "positions": _sh(mesh, P(node_axes, None)),
            "species": _sh(mesh, P(node_axes)),
            "edge_index": _sh(mesh, P(None, all_axes)),
            "edge_mask": _sh(mesh, P(all_axes)),
            "node_mask": _sh(mesh, P(node_axes)),
            "energy": _scalar_sh(mesh),
        }

        def loss_fn(p, bt):
            e = nequip_energy(p, bt, cfg)
            loss = (e - bt["energy"]) ** 2
            return loss, {"loss": loss}

    step = make_train_step(loss_fn, opt)
    # ~paths * 9 * multiplicity flops per edge, x3 (fwd+bwd)
    mult = (1 + 3 + 9) * cfg.d_hidden * 10
    model_flops = 3.0 * 2.0 * ne * mult * cfg.n_layers * (s.get("batch") or 1)

    def make_args(device, seed):
        params = init_nequip(torch.Generator().manual_seed(seed), cfg, device=device)
        highs = {"edge_index": nn, "species": cfg.n_species}
        return init_train_state(params, opt), _draw(batch_sds, highs, device,
                                                    _gen(device, seed + 1))

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=step,
        args=(state_sds, batch_sds),
        in_shardings=(state_sh, batch_sh),
        out_shardings=(state_sh, _scalar_sh(mesh)),
        model_flops=model_flops,
        note=f"nodes={nn} edges={ne} batch={s.get('batch') or 1}",
        trace_local=(False, True),
        train=True,
        make_args=make_args,
    )


# ---------------------------------------------------------------------------
# MIND cells
# ---------------------------------------------------------------------------

def _mind_batch_sds(cfg, b: int, with_loss: bool):
    sds = {
        "hist_ids": _meta((b, cfg.hist_len), torch.int32),
        "hist_mask": _meta((b, cfg.hist_len), torch.bool),
        "profile_ids": _meta((b, cfg.profile_bag_len), torch.int32),
        "profile_mask": _meta((b, cfg.profile_bag_len), torch.bool),
        "routing_logits_init": _meta((b, cfg.n_interests, cfg.hist_len), torch.float32),
    }
    if with_loss:
        sds["target_id"] = _meta((b,), torch.int32)
        sds["neg_ids"] = _meta((b, cfg.n_negatives), torch.int32)
    return sds


def _mind_batch_sh(mesh, sds, ba):
    return {
        k: Sharding(mesh, P(*((ba,) + (None,) * (len(v.shape) - 1))))
        for k, v in sds.items()
    }


def _mind_highs(cfg) -> dict:
    return {"hist_ids": cfg.n_items, "profile_ids": cfg.n_profile_feats,
            "target_id": cfg.n_items, "neg_ids": cfg.n_items, "cand_ids": cfg.n_items}


def build_mind_train(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    ba = batch_axes_for(mesh)
    cfg = arch.make_config(batch_axes=ba)
    b = cell.settings["batch"]
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 100, 10_000))
    params_sds, param_specs = abstract_init(init_mind, cfg)
    with meta_factories():
        state_sds = init_train_state(params_sds, opt)
    state_sh = make_shardings(mesh, train_state_specs(param_specs, opt))
    batch_sds = _mind_batch_sds(cfg, b, True)
    batch_sh = _mind_batch_sh(mesh, batch_sds, ba)
    step = make_train_step(lambda p, bt: mind_loss(p, bt, cfg), opt)
    model_flops = 6.0 * b * (
        cfg.hist_len * cfg.embed_dim * (cfg.n_interests * cfg.capsule_iters + 2)
        + (cfg.n_negatives + 1) * cfg.embed_dim
    )

    def make_args(device, seed):
        params = init_mind(_gen(device, seed), cfg)[0]
        return init_train_state(params, opt), _draw(batch_sds, _mind_highs(cfg), device,
                                                    _gen(device, seed + 1))

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=step,
        args=(state_sds, batch_sds),
        in_shardings=(state_sh, batch_sh),
        out_shardings=(state_sh, _scalar_sh(mesh)),
        model_flops=model_flops,
        note=f"batch={b} table={cfg.n_items}x{cfg.embed_dim}",
        trace_local=(False, True),
        train=True,
        make_args=make_args,
    )


def build_mind_serve(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    ba = batch_axes_for(mesh)
    cfg = arch.make_config(batch_axes=ba)
    b = cell.settings["batch"]
    params_sds, param_specs = abstract_init(init_mind, cfg)
    params_sh = make_shardings(mesh, param_specs)
    batch_sds = _mind_batch_sds(cfg, b, False)
    batch_sh = _mind_batch_sh(mesh, batch_sds, ba)
    fn = lambda p, bt: serve_user(p, bt, cfg)
    model_flops = 2.0 * b * cfg.hist_len * cfg.embed_dim * (
        cfg.n_interests * cfg.capsule_iters + 2
    )

    def make_args(device, seed):
        return (init_mind(_gen(device, seed), cfg)[0],
                _draw(batch_sds, _mind_highs(cfg), device, _gen(device, seed + 1)))

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=fn,
        args=(params_sds, batch_sds),
        in_shardings=(params_sh, batch_sh),
        out_shardings=_sh(mesh, P(ba, None, None)),
        model_flops=model_flops,
        note=f"serve batch={b}",
        trace_local=(False, True),
        make_args=make_args,
    )


def build_mind_retrieval(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    all_axes = tuple(mesh.axis_names)
    cfg = arch.make_config(batch_axes=())     # B=1: no batch sharding
    nc = _pad_to(cell.settings["n_candidates"])
    params_sds, param_specs = abstract_init(init_mind, cfg)
    params_sh = make_shardings(mesh, param_specs)
    batch_sds = _mind_batch_sds(cfg, 1, False)
    batch_sds["cand_ids"] = _meta((nc,), torch.int32)
    batch_sh = {k: _sh(mesh, P(*((None,) * len(v.shape)))) for k, v in batch_sds.items()}
    batch_sh["cand_ids"] = _sh(mesh, P(all_axes))
    fn = lambda p, bt: retrieval_scores(p, bt, cfg, top_k=100)
    model_flops = 2.0 * nc * cfg.embed_dim * cfg.n_interests

    def make_args(device, seed):
        return (init_mind(_gen(device, seed), cfg)[0],
                _draw(batch_sds, _mind_highs(cfg), device, _gen(device, seed + 1)))

    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=fn,
        args=(params_sds, batch_sds),
        in_shardings=(params_sh, batch_sh),
        out_shardings=(_scalar_sh(mesh), _scalar_sh(mesh)),
        model_flops=model_flops,
        note=f"1 user x {nc} candidates",
        trace_local=(False, True),
        make_args=make_args,
    )


# ---------------------------------------------------------------------------
# APSP cells (the paper)
# ---------------------------------------------------------------------------

def build_apsp(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    from repro_torch.core.distributed import (
        dist_spec,
        fw_distributed,
        rkleene_distributed,
        squaring_distributed,
    )

    s = cell.settings
    n, method = s["n"], s["method"]
    multi_pod = "pod" in mesh.axis_names
    row_axes = ("pod", "data") if multi_pod else ("data",)
    col_axes = ("model",)
    spec = dist_spec(multi_pod)

    if method == "squaring":
        fn = lambda h: squaring_distributed(h, mesh=mesh, row_axes=row_axes,
                                            col_axes=col_axes)
        flops_per = 2.0 * n * n * n          # add+cmp per (i,k,j)
        model_flops = flops_per * max(1, math.ceil(math.log2(n)))
    elif method == "fw":
        fn = lambda h: fw_distributed(h, mesh=mesh, row_axes=row_axes,
                                      col_axes=col_axes,
                                      block_size=s.get("block_size", 512))
        model_flops = 2.0 * n * n * n
    elif method == "rkleene":
        fn = lambda h: rkleene_distributed(h, mesh=mesh, row_axes=row_axes,
                                           col_axes=col_axes,
                                           leaf=s.get("leaf", 8192),
                                           block_size=s.get("block_size", 512))
        model_flops = 2.0 * n * n * n
    else:
        raise ValueError(method)

    def make_args(device, seed):
        from repro_torch.core.graphgen import generate_np

        h = generate_np(np.random.default_rng(seed), n, rho=2.0).h
        return (torch.from_numpy(np.asarray(h, dtype=np.float32)).to(device),)

    h_sds = _meta((n, n), torch.float32)
    return DryRunnable(
        name=f"{arch.arch_id}:{cell.shape_id}",
        fn=fn,
        args=(h_sds,),
        in_shardings=(_sh(mesh, spec),),
        out_shardings=_sh(mesh, spec),
        model_flops=model_flops,
        note=f"N={n} method={method} (min-plus ops on the CUDA cores, not the tensor cores)",
        trace_local=(True,),
        make_args=make_args,
    )


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_BUILDERS = {
    "lm_train": build_lm_train,
    "lm_prefill": build_lm_prefill,
    "lm_decode": build_lm_decode,
    "gnn_train": build_gnn_train,
    "mind_train": build_mind_train,
    "mind_serve": build_mind_serve,
    "mind_retrieval": build_mind_retrieval,
    "apsp": build_apsp,
}


def build_cell(arch: ArchDef, cell: ShapeCell, mesh: Mesh) -> DryRunnable:
    kind = cell.kind
    if arch.family == "nequip" and kind == "gnn_train":
        return build_nequip_train(arch, cell, mesh)
    return _BUILDERS[kind](arch, cell, mesh)
