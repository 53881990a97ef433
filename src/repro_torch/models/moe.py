"""Mixture-of-Experts FFN of the PyTorch port, ported from
``repro.models.moe``: GShard-style grouped, capacity-based dispatch.

Tokens are split into groups of at most ``moe_group`` (the largest divisor
of the token count not above it); each group routes on its own with
capacity ``C = max(int(Tg * top_k * cf / E), 1)`` rounded up to a multiple
of 4.  The router runs in float32; each (token, slot) takes its rank in its
expert's buffer from the float32 cumsum of the one-hot choices, and a slot
ranked at or past C is dropped (its combine weight is 0; the residual
connection carries the token).  Dispatch and combine are the reference's
dense (G, Tg, E, C) tensors and einsums, so every expert multiplies its
whole buffer; the aux loss is Shazeer's, from the top-1 fraction.

Expert weights are stacked (E, d, ff) in the reference's layout.
:func:`record_routing` collects, for each call inside it, the slots kept
and the slots routed (tensors, no host sync): what a caller reads to know
how many tokens were dropped.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding import PartitionSpec as P

from .layers import dense_init

__all__ = ["init_moe", "moe_ffn", "moe_route", "moe_shape", "record_routing"]

_ROUTING: Optional[list] = None


@contextmanager
def record_routing():
    """``with record_routing() as log:`` each :func:`moe_ffn` call inside
    appends ``(kept, routed)``: 0-d tensors, the (token, slot) pairs that
    found room in their expert's buffer and all of them."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


def init_moe(generator: torch.Generator, cfg, *, stack: Sequence[int] = ()
             ) -> Tuple[dict, dict]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    dt = cfg.param_dtype
    p = {
        "router": dense_init(generator, (d, e), torch.float32, stack=stack),  # always f32
        "wg": dense_init(generator, (e, d, f), dt, stack=stack),
        "wu": dense_init(generator, (e, d, f), dt, stack=stack),
        "wd": dense_init(generator, (e, f, d), dt, stack=stack),
    }
    fs = "data" if getattr(cfg, "fsdp_params", False) else None
    s = {"router": P(None, None), "wg": P("model", None, fs), "wu": P("model", None, fs),
         "wd": P("model", fs, None)}
    return p, s


def moe_shape(t: int, cfg) -> Tuple[int, int, int]:
    """(groups, group size, capacity) for ``t`` tokens."""
    tg = min(getattr(cfg, "moe_group", 1024), t)
    while t % tg != 0:          # largest divisor of t not above moe_group
        tg -= 1
    cf = getattr(cfg, "moe_capacity_factor", 1.25)
    cap = max(int(tg * cfg.moe_top_k * cf / cfg.n_experts), 1)
    cap = (cap + 3) // 4 * 4    # a multiple of 4, as the reference's lanes
    return t // tg, tg, cap


def moe_route(router: torch.Tensor, xg: torch.Tensor, k: int, cap: int) -> dict:
    """The routing decisions of grouped tokens xg (G, Tg, d): float32
    ``probs`` (G, Tg, E), ``top_w`` (renormalised) and ``top_i`` (G, Tg, k),
    each slot's rank ``pos`` in its expert's buffer and ``keep`` = pos <
    cap, and the one-hot choices ``oh`` (G, Tg, k, E)."""
    g, tg, _ = xg.shape
    e = router.shape[-1]
    logits = xg.float() @ router.float()                              # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)                       # (G, Tg, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    oh = F.one_hot(top_i, e).float()                                  # (G, Tg, k, E)
    ohf = oh.reshape(g, tg * k, e)
    pos = torch.cumsum(ohf, dim=1) - ohf                              # rank per expert
    pos = (pos * ohf).sum(-1).reshape(g, tg, k)
    return {"probs": probs, "top_w": top_w, "top_i": top_i, "oh": oh, "pos": pos,
            "keep": pos < cap}


def moe_ffn(p: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    g, tg, cap = moe_shape(b * s, cfg)
    xg = x.reshape(g, tg, d)
    r = moe_route(p["router"], xg, k, cap)
    oh, pos, keep, top_w = r["oh"], r["pos"], r["keep"], r["top_w"]
    if _ROUTING is not None:
        _ROUTING.append((keep.sum(), torch.tensor(keep.numel(), device=keep.device)))

    # dispatch / combine (G, Tg, E, C), built one top-k slot at a time
    slots = torch.arange(cap, device=x.device, dtype=pos.dtype)
    dispatch = x.new_zeros((g, tg, e, cap), dtype=torch.float32)
    combine = x.new_zeros((g, tg, e, cap), dtype=torch.float32)
    for j in range(k):
        poh = (pos[..., j, None] == slots).float()                    # (G, Tg, C)
        mj = keep[..., j].float()
        dj = torch.einsum("gte,gtc->gtec", oh[:, :, j] * mj[..., None], poh)
        dispatch = dispatch + dj
        combine = combine + dj * top_w[..., j][..., None, None]

    # aux load-balance loss (Shazeer): E * mean_g(sum_e frac_e * mean_prob_e)
    frac = torch.mean(oh[:, :, 0], dim=1)                             # top-1 frac (G, E)
    mean_prob = torch.mean(r["probs"], dim=1)                         # (G, E)
    aux = e * torch.mean(torch.sum(frac * mean_prob, dim=-1))

    cd = x.dtype
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch.to(cd), xg)  # (G, E, C, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["wg"].to(cd)))
    u = torch.einsum("gecd,edf->gecf", expert_in, p["wu"].to(cd))
    eo = torch.einsum("gecf,efd->gecd", h * u, p["wd"].to(cd))        # (G, E, C, d)
    out = torch.einsum("gecd,gtec->gtd", eo, combine.to(cd))
    return out.reshape(b, s, d), aux
