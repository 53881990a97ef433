"""The five assigned LM architectures, exact published configurations: the
PyTorch port's copy of ``repro.configs.lm_archs`` letter for letter, on the
port's ``LMConfig`` (dtype fields are torch dtypes).

All five are pure full attention (GQA or MLA) -> ``long_500k`` is skipped
per the instruction sheet (no sub-quadratic path in these archs); recorded
in DESIGN.md §7 and in each cell's skip_reason.

Precision/optimizer policy (recorded per-arch):
  * <=10B:  f32 params, AdamW.
  * >100B:  bf16 params + Adafactor + fsdp_params (2D weight sharding) —
    the combination that fits 16 GB/chip at 256 chips (see DESIGN §5).
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import LMConfig

from .base import ArchDef, LM_SHAPES

__all__ = ["YI_9B", "QWEN2_1_5B", "LLAMA3_405B", "DEEPSEEK_V2_236B", "ARCTIC_480B"]


def _mk(cfg_kw):
    def make_config(**over):
        return LMConfig(**{**cfg_kw, **over})

    return make_config


# --- yi-9b: llama-arch GQA [arXiv:2403.04652; hf] --------------------------
_YI = dict(
    name="yi-9b", n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, rope_theta=1e4,
    param_dtype=torch.float32, compute_dtype=torch.bfloat16,
    fsdp_params=True, seq_shard=True, loss_chunk=512,
)
YI_9B = ArchDef(
    arch_id="yi-9b", family="lm", source="[arXiv:2403.04652; hf]",
    make_config=_mk(_YI),
    smoke_config=lambda: LMConfig(
        name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab=128, param_dtype=torch.float32, compute_dtype=torch.float32,
        attn_chunk=16,
    ),
    cells=LM_SHAPES(skip_long=True),
    optimizer="adamw", learning_rate=3e-4, microbatches=4,
    notes="microbatch=4 keeps the per-layer residual stack + logits region "
          "inside 16 GB/chip at global batch 256 x 4k.",
)

# --- qwen2-1.5b: GQA + QKV bias, tied embeddings [arXiv:2407.10671; hf] ----
_QWEN = dict(
    name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, param_dtype=torch.float32, compute_dtype=torch.bfloat16,
)
QWEN2_1_5B = ArchDef(
    arch_id="qwen2-1.5b", family="lm", source="[arXiv:2407.10671; hf]",
    make_config=_mk(_QWEN),
    smoke_config=lambda: LMConfig(
        name="qwen2-smoke", n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_ff=128, vocab=96, qkv_bias=True, tie_embeddings=True,
        param_dtype=torch.float32, compute_dtype=torch.float32, attn_chunk=16,
    ),
    cells=LM_SHAPES(skip_long=True),
    optimizer="adamw", learning_rate=3e-4, microbatches=4,
    notes="microbatch=4: residual stack (28,B_mb,4096,1536) + f32 logits "
          "block stay under 16 GB/chip.",
)

# --- llama3-405b [arXiv:2407.21783; unverified] ------------------------------
_LLAMA = dict(
    name="llama3-405b", n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, rope_theta=5e5,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, fsdp_params=True,
    remat="full", seq_shard=True, loss_chunk=512,
)
LLAMA3_405B = ArchDef(
    arch_id="llama3-405b", family="lm", source="[arXiv:2407.21783; unverified]",
    make_config=_mk(_LLAMA),
    smoke_config=lambda: LMConfig(
        name="llama3-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=224, vocab=160, rope_theta=5e5,
        param_dtype=torch.float32, compute_dtype=torch.float32, attn_chunk=16,
    ),
    cells=LM_SHAPES(skip_long=True),
    optimizer="adafactor", learning_rate=1e-4, microbatches=8,
    notes="bf16 params + adafactor + 2D (data,model) weight sharding + "
          "sequence-parallel residual stream + microbatch=8: the combination "
          "that fits 405B train_4k in 16 GB/chip at 256 chips.",
)

# --- deepseek-v2-236b: MLA + 2 shared + 160 routed top-6 [arXiv:2405.04434; hf]
_DSV2 = dict(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_ff=12288, vocab=102400, rope_theta=1e4,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    moe=True, n_experts=160, moe_top_k=6, moe_d_ff=1536,
    n_shared_experts=2, first_k_dense=1,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, fsdp_params=True,
    remat="full", moe_group=1024, seq_shard=True, loss_chunk=512,
)
DEEPSEEK_V2_236B = ArchDef(
    arch_id="deepseek-v2-236b", family="lm", source="[arXiv:2405.04434; hf]",
    make_config=_mk(_DSV2),
    smoke_config=lambda: LMConfig(
        name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=128, mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        moe=True, n_experts=8, moe_top_k=2, moe_d_ff=48, n_shared_experts=2,
        first_k_dense=1, moe_group=32,
        param_dtype=torch.float32, compute_dtype=torch.float32, attn_chunk=16,
    ),
    cells=LM_SHAPES(skip_long=True),
    optimizer="adafactor", learning_rate=2e-4, microbatches=8,
    notes="MLA: d_ff=12288 is the dense first layer; experts are 1536-wide "
          "(2 shared + 160 routed top-6). Decode uses the absorbed-matrix "
          "path against the 576/token compressed cache.",
)

# --- arctic-480b: 128 experts top-2 + dense residual [hf:Snowflake] ---------
_ARCTIC = dict(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, rope_theta=1e4,
    moe=True, n_experts=128, moe_top_k=2, moe_d_ff=4864, residual_dense=True,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, fsdp_params=True,
    remat="full", moe_group=1024, seq_shard=True, loss_chunk=512,
)
ARCTIC_480B = ArchDef(
    arch_id="arctic-480b", family="lm", source="[hf:Snowflake/snowflake-arctic-base; hf]",
    make_config=_mk(_ARCTIC),
    smoke_config=lambda: LMConfig(
        name="arctic-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=96, vocab=96, moe=True, n_experts=4, moe_top_k=2, moe_d_ff=96,
        residual_dense=True, moe_group=32,
        param_dtype=torch.float32, compute_dtype=torch.float32, attn_chunk=16,
    ),
    cells=LM_SHAPES(skip_long=True),
    optimizer="adafactor", learning_rate=2e-4, microbatches=8,
    notes="dense-MoE hybrid: 4864-wide residual dense MLP in parallel with "
          "128-expert top-2 MoE every layer.",
)
