"""Shared layers of the PyTorch port, ported from ``repro.models.layers``:
the initializers, the transformer layers (norms, rotary embedding, chunked
GQA attention, the GQA projections, SwiGLU, embedding / unembedding) and
the walk that hands a module's parameters out in the JAX layout.

Every ``init_*`` returns ``(params, specs)``: ``specs`` mirrors the params
tree with the port's ``sharding.PartitionSpec`` leaves (Megatron-style TP
over ``model``, optional FSDP over ``data``), as the reference's do.  An
init takes a ``torch.Generator`` and draws on the generator's device (a
full-width model is drawn on the card, never on the host), and takes a
``stack`` of leading dimensions, so that a scanned layer stack is drawn
as one ``(L, ...)`` leaf a weight (the reference ``vmap``s its init).

Compute follows the reference's mixed precision: parameters stay in
``param_dtype`` and each weight is cast to the activations' dtype where it
is used; norms, softmax and logits run in float32.

Divergences by design: the generators give other numbers than
``jax.random`` for the same seed (parity tests carry the JAX parameters
across, ``core.convert``); :func:`embed` gathers the rows and then casts
them, where the reference casts the table and gathers (the same values;
the port does not convert a whole vocabulary a token); :func:`constrain`
is the identity (see its docstring).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import PartitionSpec as P

__all__ = [
    "constrain", "dense_init", "embed_init", "module_tree", "tree_module",
    "init_rmsnorm", "rmsnorm", "init_layernorm", "layernorm", "rope_freqs", "apply_rope",
    "attention", "init_gqa", "gqa_qkv", "gqa_out", "init_swiglu", "swiglu", "init_embed",
    "embed", "unembed",
]

NEG = -1e30                      # the masked scores' fill, as the reference's


def constrain(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The identity.  In the reference a sharding hint for GSPMD, with no
    numeric effect; the port lays tensors over a mesh explicitly
    (``repro_torch.sharding``), so there is nothing to hint."""
    return x


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               scale: float = 1.0, *, stack: Sequence[int] = ()) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)) weights, fan_in = ``shape[0]`` (1 for
    a vector), drawn in float32 on the generator's device and cast to
    ``dtype``; ``stack`` leading dimensions draw that many independent
    weights at once."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale / (fan_in ** 0.5)
    return (torch.randn(tuple(stack) + tuple(shape), generator=generator,
                        device=generator.device) * std).to(dtype)


def embed_init(generator: torch.Generator, shape: Sequence[int], dtype: torch.dtype
               ) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=generator, device=generator.device)
            * 0.02).to(dtype)


def module_tree(module: nn.Module):
    """The module's parameters (these tensors, not copies) in the JAX
    layout: a ParameterDict is a dict, a ModuleList a list, any other
    module a dict of its own parameters and children."""
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    if isinstance(module, nn.ModuleList):
        return [module_tree(m) for m in module]
    out = dict(module.named_parameters(recurse=False))
    out.update({k: module_tree(m) for k, m in module.named_children()})
    return out


def tree_module(tree) -> nn.Module:
    """A module that holds a parameter tree of dicts and lists of tensors
    (the tensors become its parameters, not copies, wherever they are
    already ``nn.Parameter``s): the inverse of :func:`module_tree`, so that
    ``module_tree(tree_module(t))`` has ``t``'s layout and the module's
    ``state_dict`` key is the tree path joined with ``.``."""
    def param(t):
        return t if isinstance(t, nn.Parameter) else nn.Parameter(t)

    if isinstance(tree, list):
        return nn.ModuleList(tree_module(x) for x in tree)
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: param(v) for k, v in tree.items()})
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            m.register_parameter(k, param(v))
        else:
            m.add_module(k, tree_module(v))
    return m


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, *, stack: Sequence[int] = (), device=None) -> Tuple[dict, dict]:
    return ({"scale": torch.ones(tuple(stack) + (d,), dtype=dtype, device=device)},
            {"scale": P(None)})


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, *, stack: Sequence[int] = (), device=None
                   ) -> Tuple[dict, dict]:
    shape = tuple(stack) + (d,)
    return ({"scale": torch.ones(shape, dtype=dtype, device=device),
             "bias": torch.zeros(shape, dtype=dtype, device=device)},
            {"scale": P(None), "bias": P(None)})


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (split halves, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) integer absolute positions."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                         # (Dh/2,)
    ang = positions[..., None].float() * freqs                      # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]                             # (B, S, 1, Dh/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, chunked over queries so S x S never materializes)
# ---------------------------------------------------------------------------

def attention(
    q: torch.Tensor,                  # (B, Sq, H, Dh)
    k: torch.Tensor,                  # (B, Sk, Hkv, Dh)
    v: torch.Tensor,                  # (B, Sk, Hkv, Dhv)
    *,
    causal: bool = True,
    q_offset=0,                       # int or (B,): absolute pos of q[:, 0]
    kv_len: Optional[torch.Tensor] = None,   # (B,) valid kv prefix (decode/serve)
    chunk: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention with query chunking, the reference's formula:
    scores of one query chunk are (B, Hkv, G, Cq, Sk) in float32, masked
    entries filled with -1e30 (a fully masked row is the mean of ``v``, not
    NaN), softmax in float32.  Under autograd each chunk runs under
    ``torch.utils.checkpoint``, so the backward recomputes its scores
    rather than keeping every chunk's."""
    b, sq, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    qg = q.reshape(b, sq, hkv, g, dh)
    kf, vf = k.float(), v.float()
    kv_pos = torch.arange(sk, device=q.device)
    off = torch.broadcast_to(torch.as_tensor(q_offset, dtype=torch.int64, device=q.device), (b,))

    def block(qc: torch.Tensor, start: int) -> torch.Tensor:
        # qc: (B, Cq, Hkv, G, Dh); start: the chunk's first query
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kf) * scale
        rel = torch.arange(start, start + qc.shape[1], device=q.device)
        q_pos = off[:, None] + rel[None, :]                        # (B, Cq)
        mask = None
        if causal:
            mask = kv_pos[None, None, :] <= q_pos[:, :, None]
        if kv_len is not None:
            valid = (kv_pos[None, :] < kv_len[:, None])[:, None, :]
            mask = valid if mask is None else mask & valid
        if mask is not None:
            s = torch.where(mask[:, None, None, :, :], s, NEG)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
        return o.to(q.dtype)

    if chunk is None or chunk >= sq:
        return block(qg, 0).reshape(b, sq, h, v.shape[-1])

    remat = torch.is_grad_enabled()
    outs = []
    for start in range(0, sq, chunk):          # a ragged tail is a shorter chunk
        qc = qg[:, start:start + chunk]
        outs.append(checkpoint(block, qc, start, use_reentrant=False) if remat
                    else block(qc, start))
    return torch.cat(outs, dim=1).reshape(b, sq, h, v.shape[-1])


# ---------------------------------------------------------------------------
# GQA projection block
# ---------------------------------------------------------------------------

def init_gqa(generator: torch.Generator, cfg, *, stack: Sequence[int] = ()
             ) -> Tuple[dict, dict]:
    dh = cfg.head_dim
    dt = cfg.param_dtype
    p = {
        "wq": dense_init(generator, (cfg.d_model, cfg.n_heads * dh), dt, stack=stack),
        "wk": dense_init(generator, (cfg.d_model, cfg.n_kv_heads * dh), dt, stack=stack),
        "wv": dense_init(generator, (cfg.d_model, cfg.n_kv_heads * dh), dt, stack=stack),
        "wo": dense_init(generator, (cfg.n_heads * dh, cfg.d_model), dt, stack=stack),
    }
    fsdp = "data" if getattr(cfg, "fsdp_params", False) else None
    s = {"wq": P(fsdp, "model"), "wk": P(fsdp, "model"), "wv": P(fsdp, "model"),
         "wo": P("model", fsdp)}
    if cfg.qkv_bias:
        dev = generator.device
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(tuple(stack) + (width * dh,), dtype=dt, device=dev)
            s[name] = P("model")
    return p, s


def gqa_qkv(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, cfg.n_heads, dh), k.reshape(b, s, cfg.n_kv_heads, dh),
            v.reshape(b, s, cfg.n_kv_heads, dh))


def gqa_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ p["wo"].to(o.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int, dtype, fsdp: bool = False,
                *, stack: Sequence[int] = ()) -> Tuple[dict, dict]:
    p = {"wg": dense_init(generator, (d_model, d_ff), dtype, stack=stack),
         "wu": dense_init(generator, (d_model, d_ff), dtype, stack=stack),
         "wd": dense_init(generator, (d_ff, d_model), dtype, stack=stack)}
    f = "data" if fsdp else None
    return p, {"wg": P(f, "model"), "wu": P(f, "model"), "wd": P("model", f)}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p["wg"].to(x.dtype))
    u = x @ p["wu"].to(x.dtype)
    return (g * u) @ p["wd"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(generator: torch.Generator, vocab: int, d_model: int, dtype
               ) -> Tuple[dict, dict]:
    return ({"table": embed_init(generator, (vocab, d_model), dtype)},
            {"table": P("model", None)})


def embed(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p["table"][tokens.long()].to(compute_dtype)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (loss stability)."""
    return x.float() @ p["table"].float().T
