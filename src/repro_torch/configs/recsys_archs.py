"""MIND recsys arch [arXiv:1904.08030; unverified], the PyTorch port's copy of
``repro.configs.recsys_archs`` letter for letter, on the port's ``MINDConfig``."""

from __future__ import annotations

from repro_torch.models.mind import MINDConfig

from .base import ArchDef, RECSYS_SHAPES

__all__ = ["MIND"]


MIND = ArchDef(
    arch_id="mind", family="recsys", source="[arXiv:1904.08030; unverified]",
    make_config=lambda **over: MINDConfig(
        **{**dict(name="mind", n_items=1_000_000, embed_dim=64, n_interests=4,
                  capsule_iters=3, hist_len=50, n_profile_feats=100_000,
                  profile_bag_len=16, n_negatives=1279), **over}
    ),
    smoke_config=lambda: MINDConfig(
        name="mind-smoke", n_items=512, embed_dim=16, n_interests=4,
        capsule_iters=3, hist_len=8, n_profile_feats=64, profile_bag_len=4,
        n_negatives=15,
    ),
    cells=RECSYS_SHAPES(),
    optimizer="adamw", learning_rate=1e-3,
    notes="embed_dim=64, 4 interest capsules, 3 routing iterations; "
          "1M-item table (sharded P('model', None)); EmbeddingBag profile "
          "pooling; sampled-softmax training; max-dot retrieval scoring.",
)
