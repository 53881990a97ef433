"""Decode KV caches of the PyTorch port, ported from ``repro.models.kvcache``:
the standard GQA cache and the MLA compressed cache, layer-stacked
(leading L dimension), in the model's compute dtype.

The reference writes a new token with a one-hot select
(``buf * (1 - onehot) + new * onehot``): a sequence whose ``length``
equals the cache's T writes nothing.  The port writes with a masked
scatter of the same result (an ``index_copy_`` would raise on such a
sequence): the slot is ``min(length, T - 1)`` and a full sequence writes
that slot's old value back.  :func:`cache_update_layer` and
:func:`cache_update_stack` return a new buffer, as the reference's do;
:func:`cache_write_` writes in place, which is what
``transformer.decode_step`` does to its cache (one token's slices a
layer, not a rewrite of the whole stack).

The specs are the reference's: the sequence dimension over ``model``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.sharding import PartitionSpec as P

__all__ = ["GQACache", "MLACache", "init_gqa_cache", "init_mla_cache",
           "cache_update_layer", "cache_update_stack", "cache_write_"]


@dataclass
class GQACache:
    k: torch.Tensor          # (L, B, T, Hkv, Dh)
    v: torch.Tensor          # (L, B, T, Hkv, Dh)
    length: torch.Tensor     # (B,) valid prefix per sequence, int32


@dataclass
class MLACache:
    ckv: torch.Tensor        # (L, B, T, R)
    kpe: torch.Tensor        # (L, B, T, dr)
    length: torch.Tensor     # (B,) int32


def init_gqa_cache(cfg, batch: int, max_len: int, *, device="cuda"
                   ) -> Tuple[GQACache, GQACache]:
    """(zeros cache, its spec tree)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    ba = tuple(getattr(cfg, "batch_axes", ("data",)))
    spec = P(None, ba, "model", None, None)
    cache = GQACache(k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                     v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                     length=torch.zeros((batch,), dtype=torch.int32, device=device))
    return cache, GQACache(k=spec, v=spec, length=P(ba))


def init_mla_cache(cfg, batch: int, max_len: int, *, device="cuda"
                   ) -> Tuple[MLACache, MLACache]:
    ba = tuple(getattr(cfg, "batch_axes", ("data",)))
    cd = cfg.compute_dtype
    cache = MLACache(
        ckv=torch.zeros((cfg.n_layers, batch, max_len, cfg.kv_lora_rank), dtype=cd, device=device),
        kpe=torch.zeros((cfg.n_layers, batch, max_len, cfg.qk_rope_head_dim), dtype=cd,
                        device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))
    specs = MLACache(ckv=P(None, ba, "model", None), kpe=P(None, ba, "model", None),
                     length=P(ba))
    return cache, specs


def cache_write_(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor,
                 seq_dim: int) -> torch.Tensor:
    """In place: slot ``lengths[b]`` of sequence b along ``seq_dim`` (the
    batch is the dimension before it) takes ``new``'s one timestep; a
    sequence whose length is T keeps its buffer.  Returns ``buf``."""
    t = buf.shape[seq_dim]
    b = buf.shape[seq_dim - 1]
    lead = (slice(None),) * (seq_dim - 1)
    rows = torch.arange(b, device=buf.device)
    slot = torch.clamp(lengths.long(), max=t - 1)
    new = new.select(seq_dim, 0).to(buf.dtype)
    old = buf[lead + (rows, slot)]
    keep = (lengths < t).view((1,) * (seq_dim - 1) + (b,) + (1,) * (new.ndim - seq_dim))
    buf[lead + (rows, slot)] = torch.where(keep, new, old)
    return buf


def cache_update_stack(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """One new timestep per sequence merged into all layers: buf (L, B, T,
    ...), new (L, B, 1, ...) -> a new buffer."""
    return cache_write_(buf.clone(), new, lengths, seq_dim=2)


def cache_update_layer(buf: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """One new timestep per sequence written into a (B, T, ...) layer
    buffer: ``new`` (B, 1, ...), slot i at position lengths[i] -> a new
    buffer."""
    return cache_write_(buf.clone(), new, lengths, seq_dim=1)
