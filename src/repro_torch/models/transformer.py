"""Decoder-only LM of the PyTorch port (dense / MoE / MLA variants over one
stacked layer tree), ported from ``repro.models.transformer``.

Design, as in the reference:
  * parameters are a tree with the reference's layout: ``{"embed":
    {"table"}, "layers": {...}, "final_norm": {"scale"}}``, plus
    ``"prefix"`` (a list of unstacked layers, DeepSeek's dense first
    layer) and ``"lm_head"`` (only when the embeddings are untied).  The
    scanned layers are ONE tree whose leaves carry a leading ``L_stack``
    dimension: Adafactor factors and clips each whole leaf, so per-layer
    leaves would give other updates, and train checkpoints have the
    reference's keys.  :class:`LM` holds the tree as an ``nn.Module``
    (``state_dict`` key = tree path joined with ``.``); ``LM.tree()`` and
    :func:`init_lm` hand out the same tensors in the JAX layout.
  * the layer loop runs over the stack's leading dimension, unbound once
    a forward (the reference's ``lax.scan``); in training each layer of
    the stack runs under ``torch.utils.checkpoint``
    (``use_reentrant=False``) unless ``remat == "none"``.  ``remat == "dots"`` (the reference's
    save-the-matmuls policy) does what ``"full"`` does: the numbers are
    the same, only the memory-for-recompute trade differs.
  * three entry points: :func:`forward` (train / prefill logits),
    :func:`decode_step` (one token against a KV cache), :func:`prefill`
    (forward + cache fill).

Divergences by design: the init draws from a ``torch.Generator`` on its
device (other numbers than ``jax.random``; tests carry the JAX parameters
across, ``core.convert.lm_params_from_jax``); :func:`decode_step` writes
the new token's K/V (or MLA latents) into ``cache``'s tensors in place and
returns a cache that shares them, where the reference returns new arrays;
sharding constraints are the identity (``layers.constrain``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import PartitionSpec as P
from repro_torch.tree import leaves, tree_map

from . import kvcache as kvc
from .layers import (
    apply_rope,
    attention,
    dense_init,
    embed,
    gqa_out,
    gqa_qkv,
    init_embed,
    init_gqa,
    init_rmsnorm,
    init_swiglu,
    module_tree,
    rmsnorm,
    swiglu,
    tree_module,
    unembed,
)
from .mla import _mla_ckv, init_mla, mla_decode, mla_train
from .moe import init_moe, moe_ffn

__all__ = ["LMConfig", "LM", "init_lm", "forward", "loss_fn", "decode_step", "prefill"]


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    # MoE
    moe: bool = False
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    residual_dense: bool = False       # arctic: dense MLP in parallel with MoE
    moe_group: int = 1024
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    # MLA
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    attn_chunk: int = 512
    remat: str = "full"                # none | full | dots
    fsdp_params: bool = False          # shard big-dim of weights over data too
    seq_shard: bool = False            # Megatron-SP: residual stream sharded
                                       # (batch, seq->model, d) between layers
    loss_chunk: int = 0                # 0 = whole-seq logits; else chunked
    batch_axes: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def with_batch_axes(self, axes) -> "LMConfig":
        return dataclasses.replace(self, batch_axes=tuple(axes))

    @property
    def act_spec(self) -> P:
        """Sharding of the (B, S, d) residual stream between layers."""
        ba = tuple(self.batch_axes)
        return P(ba, "model", None) if self.seq_shard else P(ba, None, None)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: LMConfig, *, dense_override: bool = False,
                stack=()) -> Tuple[dict, dict]:
    dev = gen.device
    ln1_p, ln1_s = init_rmsnorm(cfg.d_model, cfg.param_dtype, stack=stack, device=dev)
    ln2_p, ln2_s = init_rmsnorm(cfg.d_model, cfg.param_dtype, stack=stack, device=dev)
    attn_p, attn_s = (init_mla if cfg.mla else init_gqa)(gen, cfg, stack=stack)
    p = {"ln1": ln1_p, "attn": attn_p, "ln2": ln2_p}
    s = {"ln1": ln1_s, "attn": attn_s, "ln2": ln2_s}
    if cfg.moe and not dense_override:
        p["moe"], s["moe"] = init_moe(gen, cfg, stack=stack)
        if cfg.n_shared_experts > 0:
            p["shared"], s["shared"] = init_swiglu(
                gen, cfg.d_model, cfg.n_shared_experts * cfg.moe_d_ff, cfg.param_dtype,
                cfg.fsdp_params, stack=stack)
        if cfg.residual_dense:
            p["mlp"], s["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                                             cfg.fsdp_params, stack=stack)
    else:
        p["mlp"], s["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                                         cfg.fsdp_params, stack=stack)
    return p, s


def _init_tree(gen: torch.Generator, cfg: LMConfig) -> Tuple[dict, dict]:
    emb_p, emb_s = init_embed(gen, cfg.vocab, cfg.d_model, cfg.param_dtype)
    n_prefix = cfg.first_k_dense if cfg.moe else 0
    stacked_p, s = _init_layer(gen, cfg, stack=(cfg.n_layers - n_prefix,))
    fn_p, fn_s = init_rmsnorm(cfg.d_model, cfg.param_dtype, device=gen.device)
    params = {"embed": emb_p, "layers": stacked_p, "final_norm": fn_p}
    specs = {"embed": emb_s, "layers": tree_map(lambda x: P(None, *tuple(x)), s),
             "final_norm": fn_s}
    if n_prefix > 0:
        pre = [_init_layer(gen, cfg, dense_override=True) for _ in range(n_prefix)]
        params["prefix"] = [p for p, _ in pre]
        specs["prefix"] = [s for _, s in pre]
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.param_dtype)
        specs["lm_head"] = P(None, "model")
    return params, specs


class LM(nn.Module):
    """The reference's LM parameters as a module, drawn by ``generator``
    (a seed-0 generator on ``device`` if None) on the generator's device;
    ``specs`` is the spec tree."""

    def __init__(self, cfg: LMConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        gen = generator if generator is not None else \
            torch.Generator(device=device).manual_seed(0)
        params, self.specs = _init_tree(gen, cfg)
        root = tree_module(params)
        for name, p in root.named_parameters(recurse=False):
            self.register_parameter(name, p)
        for name, child in root.named_children():
            self.add_module(name, child)

    def tree(self) -> dict:
        """The parameters (these tensors, not copies) in the JAX layout."""
        return module_tree(self)

    def forward(self, tokens: torch.Tensor):
        return forward(self.tree(), tokens, self.cfg)


def init_lm(generator: torch.Generator, cfg: LMConfig) -> Tuple[dict, dict]:
    """(params, specs) of a new :class:`LM`, drawn on ``generator``'s device."""
    m = LM(cfg, generator, generator.device)
    return m.tree(), m.specs


# ---------------------------------------------------------------------------
# layer body (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------

def _unstack(stack: dict) -> list:
    """The stacked layer tree as a list of per-layer trees of views, by one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing each layer would add a full-size gradient a layer."""
    n = leaves(stack)[0].shape[0]

    def split(node):
        if isinstance(node, dict):
            kids = {k: split(v) for k, v in node.items()}
            return [{k: kids[k][i] for k in kids} for i in range(n)]
        return node.unbind(0)

    return split(stack)


def _attn_block_train(lp, x, cfg: LMConfig, positions):
    """-> (attn_out, (k, v) or (ckv, kpe) latents for the cache)."""
    xn = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.mla:
        out, ckv, kpe = mla_train(lp["attn"], xn, cfg, positions)
        return out, (ckv, kpe)
    q, k, v = gqa_qkv(lp["attn"], xn, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    return gqa_out(lp["attn"], o), (k, v)


def _ffn_block(lp, x, cfg: LMConfig, *, is_moe: bool):
    xn = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if is_moe:
        out, aux = moe_ffn(lp["moe"], xn, cfg)
        if cfg.n_shared_experts > 0:
            out = out + swiglu(lp["shared"], xn)
        if cfg.residual_dense:
            out = out + swiglu(lp["mlp"], xn)
    else:
        out = swiglu(lp["mlp"], xn)
    return out, aux


def _layer_train(lp, x, cfg: LMConfig, positions, *, is_moe: bool):
    a, _ = _attn_block_train(lp, x, cfg, positions)
    x = x + a
    f, aux = _ffn_block(lp, x, cfg, is_moe=is_moe)
    return x + f, aux


def _remat(fn, cfg: LMConfig):
    """``fn`` under ``torch.utils.checkpoint`` when autograd records and
    ``cfg.remat`` asks for it ("dots" as "full", see the module docstring)."""
    if cfg.remat == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def _logits(params, x, cfg: LMConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return x.float() @ params["lm_head"].float()


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def forward(params, tokens: torch.Tensor, cfg: LMConfig,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, aux_loss scalar); with
    ``return_hidden`` the final-norm hidden states instead of the logits."""
    b, s = tokens.shape
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    positions = _positions(b, s, x.device)
    for lp in params.get("prefix", []):            # dense prefix (aux = 0)
        x, _ = _layer_train(lp, x, cfg, positions, is_moe=False)

    body = _remat(lambda x, lp: _layer_train(lp, x, cfg, positions, is_moe=cfg.moe), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unstack(params["layers"]):
        x, a = body(x, lp)
        aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return _logits(params, x, cfg), aux


def loss_fn(params, batch: dict, cfg: LMConfig) -> Tuple[torch.Tensor, dict]:
    """Next-token cross entropy (mean over tokens) + MoE aux loss.

    With ``cfg.loss_chunk`` the unembed and softmax run in sequence chunks,
    each under ``torch.utils.checkpoint``, so the (B, S, V) float32 logits
    never exist at once; labels are padded with -1 to a whole chunk."""
    labels = batch["labels"].long()
    if not cfg.loss_chunk:
        logits, aux = forward(params, batch["tokens"], cfg)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        loss = torch.mean(nll)
        total = loss + cfg.moe_aux_coef * aux
        return total, {"loss": loss, "aux": aux, "total": total}

    x, aux = forward(params, batch["tokens"], cfg, return_hidden=True)
    head = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]
    c = cfg.loss_chunk
    b, sl = labels.shape
    nchunk = (sl + c - 1) // c
    pad = nchunk * c - sl
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)

    def chunk_nll(xc, lc):
        logits = xc.float() @ head.float()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, torch.clamp(lc, min=0)[..., None])[..., 0]
        return torch.sum(torch.where(lc >= 0, nll, 0.0))

    remat = torch.is_grad_enabled()
    total_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(nchunk):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        total_nll = total_nll + (checkpoint(chunk_nll, xc, lc, use_reentrant=False) if remat
                                 else chunk_nll(xc, lc))
    loss = total_nll / (b * sl)
    total = loss + cfg.moe_aux_coef * aux
    return total, {"loss": loss, "aux": aux, "total": total}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _layers_with_cache_index(params, cfg: LMConfig):
    """(layer params, its index in the cache, is_moe): the prefix first,
    then the stack."""
    prefix = params.get("prefix", [])
    out = [(lp, i, False) for i, lp in enumerate(prefix)]
    out += [(lp, len(prefix) + j, cfg.moe) for j, lp in enumerate(_unstack(params["layers"]))]
    return out


def decode_step(params, cache, tokens: torch.Tensor, cfg: LMConfig):
    """One decode step: tokens (B, 1) -> (logits (B, V), updated cache).
    The new token's entries are written into ``cache``'s tensors in place
    (a sequence whose length is the cache's T writes nothing)."""
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    lengths = cache.length                                  # (B,) filled so far
    positions = lengths[:, None]
    for lp, li, is_moe in _layers_with_cache_index(params, cfg):
        xn = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cfg.mla:
            ckv_new, kpe_new = _mla_ckv(lp["attn"], xn, cfg, positions)
            kvc.cache_write_(cache.ckv[li], ckv_new, lengths, seq_dim=1)
            kvc.cache_write_(cache.kpe[li], kpe_new, lengths, seq_dim=1)
            a = mla_decode(lp["attn"], xn, cfg, cache.ckv[li], cache.kpe[li], lengths + 1)
        else:
            q, k, v = gqa_qkv(lp["attn"], xn, cfg)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            kvc.cache_write_(cache.k[li], k, lengths, seq_dim=1)
            kvc.cache_write_(cache.v[li], v, lengths, seq_dim=1)
            a = gqa_out(lp["attn"], attention(q, cache.k[li], cache.v[li], causal=False,
                                              kv_len=lengths + 1,
                                              softmax_scale=cfg.head_dim ** -0.5))
        x = x + a
        f, _ = _ffn_block(lp, x, cfg, is_moe=is_moe)
        x = x + f
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], dataclasses.replace(cache, length=lengths + 1)


def prefill(params, tokens: torch.Tensor, cfg: LMConfig, max_len: int):
    """Run the prompt through the model -> (last position's logits (B, V),
    the cache filled with each layer's K/V (or MLA latents), zeros past the
    prompt up to ``max_len``)."""
    b, s = tokens.shape
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    positions = _positions(b, s, x.device)
    layers = _layers_with_cache_index(params, cfg)
    bufs = None
    for lp, li, is_moe in layers:
        a, kv = _attn_block_train(lp, x, cfg, positions)
        if bufs is None:
            bufs = [torch.zeros((len(layers), b, max_len) + tuple(t.shape[2:]), dtype=t.dtype,
                                device=t.device) for t in kv]
        for buf, t in zip(bufs, kv):
            buf[li, :, :s] = t
        x = x + a
        f, _ = _ffn_block(lp, x, cfg, is_moe=is_moe)
        x = x + f
    length = torch.full((b,), s, dtype=torch.int32, device=x.device)
    cache = (kvc.MLACache(ckv=bufs[0], kpe=bufs[1], length=length) if cfg.mla
             else kvc.GQACache(k=bufs[0], v=bufs[1], length=length))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x[:, -1:], cfg)[:, 0], cache
