"""DeepSeek-V2 Multi-head Latent Attention (MLA) of the PyTorch port,
ported from ``repro.models.mla``.

Queries go through a LoRA-style bottleneck (``q_lora_rank``); keys and
values come from a shared compressed latent c_kv (``kv_lora_rank``) plus
one decoupled-RoPE key channel (``qk_rope_head_dim``) shared by the heads.

Two paths, as in the reference:

* train / prefill (:func:`mla_train`): k_nope and v expanded from c_kv per
  head, then the ordinary chunked attention;
* decode (:func:`mla_decode`): the absorbed form.  W_uk is folded into the
  query (q_abs = q_nope @ W_uk, (B, 1, H, R)) and the scores are taken
  against the compressed cache itself; W_uv is folded into the output the
  same way.  The cache is never decompressed: it holds R + dr values a
  token a layer (576 at DeepSeek-V2's widths).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.sharding import PartitionSpec as P

from .layers import NEG, apply_rope, attention, dense_init, init_rmsnorm, rmsnorm

__all__ = ["init_mla", "mla_train", "mla_decode"]


def init_mla(generator: torch.Generator, cfg, *, stack: Sequence[int] = ()
             ) -> Tuple[dict, dict]:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = cfg.param_dtype
    dev = generator.device
    qn_p, qn_s = init_rmsnorm(qr, dt, stack=stack, device=dev)
    kvn_p, kvn_s = init_rmsnorm(kvr, dt, stack=stack, device=dev)
    p = {
        "wdq": dense_init(generator, (d, qr), dt, stack=stack),
        "q_norm": qn_p,
        "wuq": dense_init(generator, (qr, h * (dn + dr)), dt, stack=stack),
        "wdkv": dense_init(generator, (d, kvr), dt, stack=stack),
        "kv_norm": kvn_p,
        "wuk": dense_init(generator, (kvr, h, dn), dt, stack=stack),
        "wuv": dense_init(generator, (kvr, h, dv), dt, stack=stack),
        "wkr": dense_init(generator, (d, dr), dt, stack=stack),
        "wo": dense_init(generator, (h * dv, d), dt, stack=stack),
    }
    fs = "data" if getattr(cfg, "fsdp_params", False) else None
    s = {"wdq": P(fs, None), "q_norm": qn_s, "wuq": P(fs, "model"), "wdkv": P(fs, None),
         "kv_norm": kvn_s, "wuk": P(None, "model", None), "wuv": P(None, "model", None),
         "wkr": P(fs, None), "wo": P("model", fs)}
    return p, s


def _mla_q(p, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(p["q_norm"], x @ p["wdq"].to(x.dtype), cfg.norm_eps)
    q = (cq @ p["wuq"].to(x.dtype)).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p, x, cfg, positions):
    """Compressed latents of new tokens: (c_kv (B, S, R), k_pe (B, S, dr))."""
    ckv = rmsnorm(p["kv_norm"], x @ p["wdkv"].to(x.dtype), cfg.norm_eps)
    kpe = (x @ p["wkr"].to(x.dtype))[:, :, None, :]                  # (B, S, 1, dr)
    kpe = apply_rope(kpe, positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, kpe


def mla_train(p, x, cfg, positions) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence MLA -> (attn_out, c_kv, k_pe); the latents fill a
    prefill's compressed cache."""
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, kpe = _mla_ckv(p, x, cfg, positions)
    cd = x.dtype
    k_nope = torch.einsum("bsr,rhd->bshd", ckv, p["wuk"].to(cd))
    v = torch.einsum("bsr,rhd->bshd", ckv, p["wuv"].to(cd))
    # the decoupled rope channel: one k_pe for every head
    k_pe_h = kpe[:, :, None, :].expand(b, s, h, dr)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_pe_h], dim=-1)
    o = attention(q, k, v, causal=True, chunk=cfg.attn_chunk, softmax_scale=(dn + dr) ** -0.5)
    return o.reshape(b, s, h * dv) @ p["wo"].to(cd), ckv, kpe


def mla_decode(
    p,
    x: torch.Tensor,              # (B, 1, d) new-token activations
    cfg,
    ckv_cache: torch.Tensor,      # (B, T, R) compressed latents (incl. the new slot)
    kpe_cache: torch.Tensor,      # (B, T, dr)
    kv_len: torch.Tensor,         # (B,) valid lengths AFTER the new token
) -> torch.Tensor:
    """Absorbed-matrix decode against the compressed cache."""
    b = x.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    t = ckv_cache.shape[1]
    positions = (kv_len - 1)[:, None]                                 # (B, 1)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)                     # (B, 1, H, *)
    cd = x.dtype
    # absorb W_uk into q: (B, 1, H, R)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, p["wuk"].to(cd))
    ckv_f = ckv_cache.float()
    s_nope = torch.einsum("bqhr,btr->bhqt", q_abs.float(), ckv_f)
    s_rope = torch.einsum("bqhd,btd->bhqt", q_rope.float(), kpe_cache.float())
    scores = (s_nope + s_rope) * (dn + dr) ** -0.5                    # (B, H, 1, T)
    mask = torch.arange(t, device=x.device)[None, :] < kv_len[:, None]  # (B, T)
    scores = torch.where(mask[:, None, None, :], scores, NEG)
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqt,btr->bqhr", attn, ckv_f).to(cd)
    o = torch.einsum("bqhr,rhd->bqhd", ctx, p["wuv"].to(cd))          # (B, 1, H, dv)
    return o.reshape(b, 1, h * dv) @ p["wo"].to(cd)
