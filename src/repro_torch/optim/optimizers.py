"""Optimizers (AdamW, Adafactor, SGD) as (init, update) pairs over parameter
trees, ported from ``repro.optim.optimizers`` with the reference's
formulas, so that a train step of the port tracks the JAX package's.

``torch.optim.AdamW`` is not used: its decoupled decay and its schedule
round differently, and its state has another layout.  The reference's
details kept here: AdamW's ``b2`` is 0.95; weight decay is added to the
update of every leaf, biases and GIN's ``eps`` included; the learning rate
is read at ``step + 1``; clipping runs in float32 with
``max(gnorm, 1e-9)``.  States are trees in the reference's layout
(``{"mu": tree, "nu": tree}`` for AdamW, ``{"m": tree}`` for SGD, a
``{"vr", "vc"}`` or ``{"v"}`` dict in place of each leaf for Adafactor),
so that a train checkpoint has the reference's keys.

``update`` takes tensors (``step`` a 0-d integer tensor or an int) and
returns new trees; the train step adds the updates to the parameters in
place.  ``state_specs`` maps a tree of the port's ``PartitionSpec``s of
the parameters to the state's, leaf for leaf, as the reference's does
(each moment inherits its parameter's layout; Adafactor's row and column
statistics drop the last or second-to-last entry).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.sharding import PartitionSpec as P
from repro_torch.tree import leaves, tree_map

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "sgd",
    "clip_by_global_norm",
    "warmup_cosine",
    "make_optimizer",
]


@dataclass(frozen=True)
class Optimizer:
    init: Callable           # params -> opt_state
    update: Callable         # (grads, opt_state, params, step) -> (updates, opt_state)
    state_specs: Callable    # param_specs -> state_specs


def _f32(step, like=None) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(step, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = _f32(step, step)
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before scaling), in float32."""
    g2 = None
    for g in leaves(grads):
        s = torch.sum(torch.square(g.float()))
        g2 = s if g2 is None else g2 + s
    gnorm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(
    lr: Callable,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads, state, params, step):
        step = step + 1
        t = _f32(step, step)
        rate = lr(step)
        mu_t, nu_t = 1 - b1 ** t, 1 - b2 ** t

        def upd(g, mu, nu, p):
            g = g.float()
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            mhat = mu / mu_t
            nhat = nu / nu_t
            u = mhat / (torch.sqrt(nhat) + eps) + weight_decay * p.float()
            return (-rate * u).to(p.dtype), mu, nu

        out = tree_map(upd, grads, state["mu"], state["nu"], params)
        return _pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2)}

    def state_specs(param_specs):
        return {"mu": param_specs, "nu": param_specs}

    return Optimizer(init, update, state_specs)


def _pick(out, i: int):
    """Element i of every tuple leaf of ``out``, the structure kept."""
    if isinstance(out, tuple):
        return out[i]
    if isinstance(out, dict):
        return {k: _pick(v, i) for k, v in out.items()}
    return [_pick(v, i) for v in out]


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum): memory-lean
# ---------------------------------------------------------------------------

def adafactor(
    lr: Callable,
    *,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def mk(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": z(p.shape[:-1]),                       # row stats
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return tree_map(mk, params)

    def update(grads, state, params, step):
        step = step + 1
        t = _f32(step, step)
        beta = 1.0 - t ** (-decay)                     # increasing-decay schedule
        rate = lr(step)

        def upd(g, s, p):
            g = g.float()
            g2 = g * g + eps
            if _factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                u = g / (torch.sqrt(rfac)[..., None] * torch.sqrt(vc)[..., None, :] + 1e-12)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / torch.sqrt(v + 1e-12)
                ns = {"v": v}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = u + weight_decay * p.float()
            return (-rate * u).to(p.dtype), ns

        # grads is a structural prefix of state (tensors above the v/vr dicts)
        out = tree_map(upd, grads, state, params)
        return _pick(out, 0), _pick(out, 1)

    def state_specs(param_specs):
        def mk(spec):
            parts = tuple(spec)
            if len(parts) >= 2:
                return {"vr": P(*parts[:-1]), "vc": P(*(parts[:-2] + parts[-1:]))}
            return {"v": spec}

        return tree_map(mk, param_specs)

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------

def sgd(lr: Callable, *, momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)}

    def update(grads, state, params, step):
        rate = lr(step + 1)

        def upd(g, m, p):
            g = g.float()
            m = momentum * m + g
            u = g + momentum * m if nesterov else m
            return (-rate * u).to(p.dtype), m

        out = tree_map(upd, grads, state["m"], params)
        return _pick(out, 0), {"m": _pick(out, 1)}

    def state_specs(param_specs):
        return {"m": param_specs}

    return Optimizer(init, update, state_specs)


def make_optimizer(kind: str, lr_fn, **kw) -> Optimizer:
    if kind == "adamw":
        return adamw(lr_fn, **kw)
    if kind == "adafactor":
        return adafactor(lr_fn, **kw)
    if kind == "sgd":
        return sgd(lr_fn, **kw)
    raise ValueError(f"unknown optimizer {kind!r}")
