"""Analytical lower bounds ("floors") per cell — the denominator of the
roofline fraction.  The port's copy of ``repro.roofline.floors``, line for
line on the port's ``configs``, with the H100's rates (``analysis.HW``)
in place of the TPU's: ``model_flops`` and ``min_bytes`` are the
reference's, ``peak_flops`` is the card's (bf16 on the tensor cores; the
(min, +) rate for APSP).

For each (arch, shape) we compute, from the published config alone:

  * model_flops  — useful math the workload fundamentally requires
                   (6·N_active·D for LM training, 2·N_active·D inference,
                   2n^3 tropical ops for APSP, gather+GEMM for GNN, ...)
  * min_bytes    — unavoidable HBM traffic of an ideal implementation
                   (params read; optimizer state read+write; KV cache read;
                   edge/node streams; the APSP matrix per pivot pass)

The roofline fraction is

    t_floor / t_measured,   t_floor    = max(compute_floor, memory_floor)
                            t_measured = max(measured compute/memory/coll terms)

i.e. "what fraction of the best-achievable step time the compiled program
reaches, charging the dominant resource".  This makes decode cells (which
are *supposed* to be memory-bound) score on cache-streaming efficiency
rather than a meaningless FLOP fraction.
"""

from __future__ import annotations

import math
from typing import Tuple

from repro_torch.configs import get_arch

from .analysis import HW

__all__ = ["cell_floors", "floor_time"]


def _lm_params(cfg) -> Tuple[float, float]:
    """(total params, active-per-token params)."""
    d, L = cfg.d_model, cfg.n_layers
    if cfg.mla:
        attn = (d * cfg.q_lora_rank
                + cfg.q_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                + d * cfg.kv_lora_rank + d * cfg.qk_rope_head_dim
                + cfg.kv_lora_rank * cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
    else:
        hd = cfg.head_dim
        attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    dense_mlp = 3 * d * cfg.d_ff
    total = active = 0.0
    for i in range(L):
        total += attn
        active += attn
        is_moe = cfg.moe and i >= cfg.first_k_dense
        if is_moe:
            expert = 3 * d * cfg.moe_d_ff
            total += cfg.n_experts * expert + d * cfg.n_experts
            active += cfg.moe_top_k * expert
            if cfg.n_shared_experts:
                total += cfg.n_shared_experts * expert
                active += cfg.n_shared_experts * expert
            if cfg.residual_dense:
                total += dense_mlp
                active += dense_mlp
        else:
            total += dense_mlp
            active += dense_mlp
    emb = cfg.vocab * d
    total += emb if cfg.tie_embeddings else 2 * emb
    active += emb if cfg.tie_embeddings else 2 * emb
    return total, active


def _cache_bytes(cfg, batch: int, seq_len: int) -> float:
    """Minimal KV-cache bytes (bf16): MLA compressed latents or GQA K/V."""
    if cfg.mla:
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim
    return float(cfg.n_layers) * batch * seq_len * per_tok * 2.0


def _attn_flops(cfg, tokens: float, kv_len: float, fwd_mult: float) -> float:
    """4·T·kv·(H·Dh) per qk+pv pair, causal halves it for self-attention."""
    hd = cfg.v_head_dim if cfg.mla else cfg.head_dim
    return fwd_mult * 2.0 * tokens * kv_len * cfg.n_heads * hd  # qk+pv, /2 causal


def cell_floors(arch_id: str, shape_id: str) -> dict:
    arch = get_arch(arch_id)
    cell = arch.cells[shape_id]
    s = cell.settings

    if arch.family == "lm":
        cfg = arch.make_config()
        total, active = _lm_params(cfg)
        # The reference's width, kept so that both packages state the same
        # floor: its test (the dtype's str ends with "bfloat16") never holds
        # for a jnp dtype ("<class 'jax.numpy.bfloat16'>"), so it charges 4
        # bytes a parameter for every LM (ROADMAP.md, "Reference-side").
        pb = 4
        if cell.kind == "lm_train":
            tokens = s["batch"] * s["seq_len"]
            remat_mult = 8 if cfg.remat != "none" else 6
            flops = remat_mult * active * tokens + _attn_flops(cfg, tokens, s["seq_len"] / 2, 4.5)
            # params fwd + bwd + re-fwd, grads, opt state r/w (f32 moments)
            mb = arch.microbatches or 1
            min_bytes = total * (3 * pb * mb + 2 * pb + 2 * 8)
        elif cell.kind == "lm_prefill":
            tokens = s["batch"] * s["seq_len"]
            flops = 2 * active * tokens + _attn_flops(cfg, tokens, s["seq_len"] / 2, 1.0)
            cache = _cache_bytes(cfg, s["batch"], s["seq_len"])
            min_bytes = total * pb + cache
        else:  # decode
            b, sl = s["batch"], s["seq_len"]
            flops = 2 * active * b + _attn_flops(cfg, b, sl, 1.0)
            cache = _cache_bytes(cfg, b, sl)
            min_bytes = total * pb + cache        # read params + read cache once
        return {"model_flops": flops, "min_bytes": min_bytes,
                "peak_flops": HW.PEAK_FLOPS_BF16}

    if arch.family in ("gnn", "nequip"):
        batch = s.get("batch", 1)
        if s.get("sampled"):
            n = s["batch_nodes"]
            nn, ne = n, 0
            for f in s["fanouts"]:
                e = n * f
                ne += e
                nn += e
                n = e
        else:
            nn, ne = s["n_nodes"], s["n_edges"]
        if arch.family == "nequip":
            cfg = arch.make_config()
            m = cfg.d_hidden
            per_edge = 2 * (cfg.n_rbf * cfg.radial_hidden + cfg.radial_hidden * 10 * m) \
                + 10 * m * (1 + 3 + 9) * 2
            per_node = 2 * 5 * m * m * (1 + 3 + 9)
            flops = 3.0 * batch * cfg.n_layers * (ne * per_edge + nn * per_node)
            feat_bytes = m * (1 + 3 + 9) * 4
        else:
            cfg = arch.make_config(d_feat=s["d_feat"])
            dh = cfg.d_hidden
            mult = {"gcn": 1, "gin": 2, "pna": 14}[cfg.kind]
            flops = 3.0 * batch * cfg.n_layers * (
                2 * ne * dh + 2 * nn * max(cfg.d_feat, dh) * dh * mult)
            feat_bytes = max(cfg.d_feat, dh) * 4
        # edges streamed (8B idx) + node features read+written per layer x3 passes
        min_bytes = 3.0 * batch * cfg.n_layers * (ne * 8 + 2 * nn * feat_bytes)
        return {"model_flops": flops, "min_bytes": min_bytes,
                "peak_flops": HW.PEAK_FLOPS_BF16}

    if arch.family == "recsys":
        cfg = arch.make_config()
        d = cfg.embed_dim
        if cell.kind == "mind_train":
            b = s["batch"]
            rows = b * (cfg.hist_len + cfg.profile_bag_len + 1 + cfg.n_negatives)
            flops = 6.0 * b * (cfg.hist_len * d * (cfg.n_interests * cfg.capsule_iters + 2)
                               + (cfg.n_negatives + 1) * d)
            min_bytes = rows * d * 4 * 3          # gather + grad-scatter + opt
        elif cell.kind == "mind_serve":
            b = s["batch"]
            rows = b * (cfg.hist_len + cfg.profile_bag_len)
            flops = 2.0 * b * cfg.hist_len * d * (cfg.n_interests * cfg.capsule_iters + 2)
            min_bytes = rows * d * 4
        else:
            nc = s["n_candidates"]
            flops = 2.0 * nc * d * cfg.n_interests
            min_bytes = nc * (d * 4 + 4)
        return {"model_flops": flops, "min_bytes": min_bytes,
                "peak_flops": HW.PEAK_FLOPS_BF16}

    # APSP (min-plus on the CUDA cores)
    n, method = s["n"], s["method"]
    if method == "squaring":
        passes = max(1, math.ceil(math.log2(n)))
        flops = 2.0 * n ** 3 * passes
        min_bytes = passes * 3 * n * n * 4        # read D twice + write once / pass
    else:
        flops = 2.0 * n ** 3
        bs = s.get("block_size", 512)
        nblk = n // bs
        min_bytes = nblk * 2 * n * n * 4          # whole matrix r+w per pivot
    return {"model_flops": flops, "min_bytes": min_bytes,
            "peak_flops": HW.PEAK_FLOPS_MINPLUS}


def floor_time(floors: dict, n_chips: int) -> float:
    t_c = floors["model_flops"] / n_chips / floors["peak_flops"]
    t_m = floors["min_bytes"] / n_chips / HW.HBM_BW
    return max(t_c, t_m)
