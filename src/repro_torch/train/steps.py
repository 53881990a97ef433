"""The train step of the PyTorch port, ported from ``repro.train.steps``:
grads -> clip -> optimizer, with optional microbatch accumulation.

``make_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, metrics)``.  ``loss_fn(params, batch) -> (loss, metrics)`` runs
eagerly and autograd takes the gradients of the parameter tree's leaves;
the updates are added to the parameters in place under
``torch.no_grad()`` (the reference builds new arrays), so the returned
state holds the same parameter tensors.  ``metrics`` are detached tensors
with ``grad_norm`` added; the step never syncs with the host.

``TrainState.step`` is a 0-d int32 tensor on the parameters' device, as
the reference's is an int32 array, so a train checkpoint of either
package has the same keys and dtypes (``params/...``, ``opt_state/...``,
``step``; ``err`` only when set).  The int8-compressed step
(``make_compressed_train_step``) and ``train_state_specs`` wait for the
LM substrate slice: the LM trainer is their only user (ROADMAP.md queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.optim import clip_by_global_norm
from repro_torch.tree import leaves, tree_map

__all__ = ["TrainState", "init_train_state", "make_train_step"]


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor
    err: Any = None          # the compressed step's residuals; None here


def init_train_state(params, optimizer) -> TrainState:
    """A state at step 0.  The reference's ``n_pods`` (the compressed
    step's error-feedback residuals in ``err``) waits for the LM
    substrate slice."""
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
    )


def _grads(loss_fn, params, batch):
    """(detached metrics, grads tree) of one batch; a leaf the loss does not
    reach gets zeros, as under ``jax.grad``."""
    loss, metrics = loss_fn(params, batch)
    gs = iter(torch.autograd.grad(loss, leaves(params), allow_unused=True))

    def grad(p):
        g = next(gs)
        return torch.zeros_like(p) if g is None else g

    return {k: v.detach() for k, v in metrics.items()}, tree_map(grad, params)


def _accumulate_grads(loss_fn, params, batch, microbatches: int):
    """The batch cut into ``microbatches`` slices along its leading axis (a
    0-d leaf goes to every slice), gradients summed in float32 over the
    slices and averaged; -> (metrics, grads), the metrics the mean over the
    slices (the reference's ``lax.scan``)."""

    def piece(x, i):
        if x.ndim == 0:
            return x
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(f"batch leading dim {b} is not a multiple of {microbatches}")
        step = b // microbatches
        return x[i * step:(i + 1) * step]

    gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)
    ms = []
    for i in range(microbatches):
        m, g = _grads(loss_fn, params, tree_map(lambda x: piece(x, i), batch))
        gacc = tree_map(lambda a, x: a + x.float(), gacc, g)
        ms.append(m)
    grads = tree_map(lambda g: g / microbatches, gacc)
    metrics = {k: torch.mean(torch.stack([m[k] for m in ms]).float(), dim=0) for k in ms[0]}
    return metrics, grads


def make_train_step(
    loss_fn: Callable,            # (params, batch) -> (loss, metrics)
    optimizer,
    *,
    microbatches: Optional[int] = None,
    clip_norm: float = 1.0,
) -> Callable:
    def train_step(state: TrainState, batch) -> tuple:
        if microbatches and microbatches > 1:
            metrics, grads = _accumulate_grads(loss_fn, state.params, batch, microbatches)
        else:
            metrics, grads = _grads(loss_fn, state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, state.opt_state, state.params,
                                                  state.step)
            for p, u in zip(leaves(state.params), leaves(updates)):
                p.add_(u.to(p.dtype))
        metrics["grad_norm"] = gnorm
        return (
            TrainState(params=state.params, opt_state=opt_state, step=state.step + 1,
                       err=state.err),
            metrics,
        )

    return train_step
