"""MIND, Multi-Interest Network with Dynamic routing (Li et al., 2019), of
the PyTorch port, ported from ``repro.models.mind``.

User behaviour history -> behaviour capsules (item embeddings) -> K
interest capsules by B2I dynamic routing (``capsule_iters`` rounds, the
squash nonlinearity) -> label-aware attention at train time, max-dot
scoring at serve time.

* :func:`embedding_bag` pools ragged id bags given as padded (B, L) id
  matrices and masks (sum or mean), the reference's take + segment-sum;
* :func:`mind_loss` is the sampled softmax over uniform negatives;
* :func:`retrieval_scores` scores one user's K interests against a
  candidate set in one matmul, max over the interests, then ``topk``.

The routing keeps the reference's masks: the softmax runs over K, masked
history positions at -1e30, and ``squash`` divides by ``sqrt(max(n², 1e-9))``.

Divergences by design: :func:`init_mind` draws from a ``torch.Generator``
on its device (tests carry the JAX parameters across,
``core.convert.mind_params_from_jax``); tables are gathered and then cast
to ``compute_dtype`` (the reference casts the table first: the same
values); ``torch.topk`` and ``jax.lax.top_k`` may order tied scores
differently.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.sharding import PartitionSpec as P

from .layers import dense_init, embed_init

__all__ = ["MINDConfig", "init_mind", "embedding_bag", "squash", "user_interests",
           "mind_loss", "serve_user", "retrieval_scores"]


@dataclass(frozen=True)
class MINDConfig:
    name: str
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    n_profile_feats: int = 100_000   # user profile id vocabulary (bags)
    profile_bag_len: int = 16
    n_negatives: int = 1279
    pow_p: float = 2.0               # label-aware attention sharpness
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    batch_axes: Tuple[str, ...] = ("data",)

    def with_batch_axes(self, axes) -> "MINDConfig":
        return dataclasses.replace(self, batch_axes=tuple(axes))


def init_mind(generator: torch.Generator, cfg: MINDConfig) -> Tuple[dict, dict]:
    """(params, specs), drawn on the generator's device; the parameters
    are leaves that autograd tracks."""
    d = cfg.embed_dim
    p = {
        "item_table": embed_init(generator, (cfg.n_items, d), cfg.param_dtype),
        "profile_table": embed_init(generator, (cfg.n_profile_feats, d), cfg.param_dtype),
        # shared bilinear map S for B2I routing (behaviour -> interest space)
        "s_matrix": dense_init(generator, (d, d), cfg.param_dtype),
        "mlp_w": dense_init(generator, (2 * d, d), cfg.param_dtype),
        "mlp_b": torch.zeros((d,), dtype=cfg.param_dtype, device=generator.device),
    }
    s = {"item_table": P("model", None), "profile_table": P("model", None),
         "s_matrix": P(None, None), "mlp_w": P(None, None), "mlp_b": P(None)}
    return {k: v.requires_grad_() for k, v in p.items()}, s


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, *,
                  mode: str = "mean", dtype=None) -> torch.Tensor:
    """Pooled ragged lookup: table (V, d), ids (B, L), mask (B, L) bool ->
    (B, d), the masked rows (cast to ``dtype`` if given) summed
    (``mode="sum"``) or averaged over the bag's valid rows (``"mean"``, an
    empty bag 0)."""
    rows = table[ids.long()]
    if dtype is not None:
        rows = rows.to(dtype)
    rows = torch.where(mask[..., None], rows, 0.0)                    # (B, L, d)
    pooled = rows.sum(dim=1)
    if mode == "mean":
        cnt = mask.sum(dim=1, keepdim=True).to(pooled.dtype)
        pooled = pooled / torch.clamp(cnt, min=1.0)
    return pooled


def squash(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    n2 = torch.sum(x * x, dim=axis, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=1e-9))
    return (n2 / (1.0 + n2)) * (x / n)


def user_interests(params, batch: dict, cfg: MINDConfig) -> torch.Tensor:
    """-> (B, K, d) interest capsules.

    batch: hist_ids (B, L), hist_mask (B, L), profile_ids (B, Lp),
    profile_mask (B, Lp), routing_logits_init (B, K, L) (fixed random: the
    paper draws b_ij from N(0, 1) and does not learn them)."""
    cd = cfg.compute_dtype
    hist = params["item_table"][batch["hist_ids"].long()].to(cd)      # (B, L, d)
    hist = torch.where(batch["hist_mask"][..., None], hist, 0.0)
    u = hist @ params["s_matrix"].to(cd)                              # (B, L, d)

    blogit = batch["routing_logits_init"].float()                     # (B, K, L)
    bmask = batch["hist_mask"][:, None, :]                            # (B, 1, L)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(torch.where(bmask, blogit, -1e30), dim=1)  # over K
        caps = squash(torch.einsum("bkl,bld->bkd", w.to(cd), u))      # (B, K, d)
        blogit = blogit + torch.einsum("bkd,bld->bkl", caps, u).float()

    # fuse the user profile (EmbeddingBag) into each interest by a small MLP
    prof = embedding_bag(params["profile_table"], batch["profile_ids"],
                         batch["profile_mask"], dtype=cd)             # (B, d)
    fused = torch.cat([caps, prof[:, None].expand(caps.shape)], dim=-1)
    return torch.relu(fused @ params["mlp_w"].to(cd) + params["mlp_b"].to(cd))


def mind_loss(params, batch: dict, cfg: MINDConfig):
    """batch additionally: target_id (B,), neg_ids (B, n_neg) -> (loss,
    {"loss", "acc"})."""
    cd = cfg.compute_dtype
    caps = user_interests(params, batch, cfg)                         # (B, K, d)
    table = params["item_table"]
    tgt = table[batch["target_id"].long()].to(cd)                     # (B, d)

    # label-aware attention: the target attends over the interests
    att = torch.einsum("bkd,bd->bk", caps, tgt)
    att = torch.softmax(cfg.pow_p * att.float(), dim=-1).to(cd)
    v_user = torch.einsum("bk,bkd->bd", att, caps)                    # (B, d)

    negs = table[batch["neg_ids"].long()].to(cd)                      # (B, Nn, d)
    pos_logit = torch.sum(v_user * tgt, dim=-1, keepdim=True)         # (B, 1)
    neg_logit = torch.einsum("bd,bnd->bn", v_user, negs)              # (B, Nn)
    logits = torch.cat([pos_logit, neg_logit], dim=1).float()
    loss = -torch.mean(torch.log_softmax(logits, dim=-1)[:, 0])
    acc = torch.mean((torch.argmax(logits, -1) == 0).float())
    return loss, {"loss": loss, "acc": acc}


def serve_user(params, batch: dict, cfg: MINDConfig) -> torch.Tensor:
    """Online inference: user features -> (B, K, d) interests (the ANN keys)."""
    return user_interests(params, batch, cfg)


def retrieval_scores(params, batch: dict, cfg: MINDConfig, *, top_k: int = 100
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One user against a candidate set, max-over-interests dot scoring.

    batch: user fields with B = 1 and cand_ids (Nc,) -> (scores, ids) of the
    ``top_k`` best candidates; the (K, d) x (d, Nc) product is one matmul."""
    cd = cfg.compute_dtype
    caps = user_interests(params, batch, cfg)[0]                      # (K, d)
    cands = params["item_table"][batch["cand_ids"].long()].to(cd)     # (Nc, d)
    scores = torch.max(caps @ cands.T, dim=0).values                  # (Nc,)
    vals, idx = torch.topk(scores, top_k)
    return vals, batch["cand_ids"][idx]
