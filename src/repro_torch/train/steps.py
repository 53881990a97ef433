"""The train steps of the PyTorch port, ported from ``repro.train.steps``:
grads -> clip -> optimizer, with optional microbatch accumulation and
optional int8 cross-pod gradient compression.

``make_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, metrics)``.  ``loss_fn(params, batch) -> (loss, metrics)`` runs
eagerly and autograd takes the gradients of the parameter tree's leaves;
the updates are added to the parameters in place under
``torch.no_grad()`` (the reference builds new arrays), so the returned
state holds the same parameter tensors.  ``metrics`` are detached tensors
with ``grad_norm`` added; the step never syncs with the host.
``param_specs`` is taken as the reference takes it; its constraints are
the identity in the port (``models.layers.constrain``).

``make_compressed_train_step`` runs one rank of a process group laid out
by a ``launch.mesh.Mesh`` with a ``pod`` axis (the reference's
partial-manual ``shard_map``): each rank takes the gradient of its block
of the batch, averages it in float32 over the other axes of its pod
(exact: an ``all_reduce`` sum), and the pods reduce it with int8 error
feedback (``optim.compression.compressed_psum``); loss and metrics are
averaged over the pod's ranks and then over the pods.  Every rank then
makes the same update, so the parameters stay equal across ranks.

``TrainState.step`` is a 0-d int32 tensor on the parameters' device, as
the reference's is an int32 array, so a train checkpoint of either
package has the same keys and dtypes (``params/...``, ``opt_state/...``,
``step``; ``err/...`` only when set).  The error-feedback residuals
``err`` have the reference's global shape ``(n_pods, ...)`` a leaf
(``init_train_state(..., n_pods=)``, spec ``P("pod", ...)``); a rank of
the compressed step holds its pod's row, ``(1, ...)`` (:func:`pod_rows`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.optim import clip_by_global_norm
from repro_torch.optim.compression import compressed_psum
from repro_torch.sharding import PartitionSpec as P
from repro_torch.sharding import Sharding
from repro_torch.tree import leaves, tree_map

__all__ = ["TrainState", "init_train_state", "train_state_specs", "make_train_step",
           "make_compressed_train_step", "pod_rows"]


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor
    err: Any = None          # int8-EF residuals (n_pods, ...) or None


def init_train_state(params, optimizer, *, n_pods: Optional[int] = None) -> TrainState:
    """A state at step 0; with ``n_pods`` zero float32 residuals of shape
    ``(n_pods,) + p.shape`` for each parameter."""
    err = None
    if n_pods:
        err = tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape), dtype=torch.float32,
                                             device=p.device), params)
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
        err=err,
    )


def train_state_specs(param_specs, optimizer, *, compressed: bool = False) -> TrainState:
    """The state's spec tree: the params', the optimizer's ``state_specs``,
    ``P()`` for the step and, when ``compressed``, ``P("pod", ...)`` for
    each residual."""
    err_specs = None
    if compressed:
        err_specs = tree_map(lambda s: P("pod", *tuple(s)), param_specs)
    return TrainState(params=param_specs, opt_state=optimizer.state_specs(param_specs),
                      step=P(), err=err_specs)


def pod_rows(err, mesh):
    """This rank's rows of global ``(n_pods, ...)`` residuals (copies), the
    block its ``P("pod")`` spec names: what the compressed step holds."""
    sh = Sharding(mesh, P("pod"))
    return tree_map(lambda e: sh.local(e).clone(), err)


def _constrain_like(tree, specs):
    """The reference constrains a gradient tree to the params' specs (a
    GSPMD hint); ``constrain`` is the identity in the port."""
    if specs is None:
        return tree
    from repro_torch.models.layers import constrain

    return tree_map(lambda g, s: constrain(g, s), tree, specs)


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
        for a, x in zip(leaves(gacc), leaves(g)):
            a.add_(x.float())
        del g
        ms.append(m)
    grads = tree_map(lambda g: g / microbatches, gacc)
    metrics = {k: torch.mean(torch.stack([m[k] for m in ms]).float(), dim=0) for k in ms[0]}
    return metrics, grads


def _apply(state: TrainState, grads, metrics, optimizer, clip_norm: float, err) -> tuple:
    """Clip, update the parameters in place, the next state and metrics."""
    grads, gnorm = clip_by_global_norm(grads, clip_norm)
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params, state.step)
        for p, u in zip(leaves(state.params), leaves(updates)):
            p.add_(u.to(p.dtype))
    metrics["grad_norm"] = gnorm
    return (TrainState(params=state.params, opt_state=opt_state, step=state.step + 1, err=err),
            metrics)


def make_train_step(
    loss_fn: Callable,            # (params, batch) -> (loss, metrics)
    optimizer,
    *,
    microbatches: Optional[int] = None,
    clip_norm: float = 1.0,
    param_specs=None,             # grads constrained to these (the identity here)
) -> Callable:
    def train_step(state: TrainState, batch) -> tuple:
        if microbatches and microbatches > 1:
            metrics, grads = _accumulate_grads(loss_fn, state.params, batch, microbatches)
        else:
            metrics, grads = _grads(loss_fn, state.params, batch)
        grads = _constrain_like(grads, param_specs)
        return _apply(state, grads, metrics, optimizer, clip_norm, state.err)

    return train_step


def _mean_over(tensors, mesh, axes, n: int):
    """Each tensor's mean over the ranks along ``axes`` (``n`` of them), in
    float32, by one ``all_reduce`` sum of the tensors laid end to end;
    cast back to each one's dtype.  The dry run's counter takes the bytes
    it would send, with or without process groups."""
    if tensors and n > 1:
        from repro_torch.roofline import op_cost

        op_cost.report_collective("all-reduce", 4 * sum(t.numel() for t in tensors))
    if not tensors or n == 1 or mesh.groups is None:
        return list(tensors)
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group(axes))
    flat = flat / n
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def make_compressed_train_step(
    loss_fn: Callable,
    optimizer,
    mesh,
    batch_spec_fn: Callable,      # batch tree -> spec tree (pod-leading)
    *,
    clip_norm: float = 1.0,
) -> Callable:
    """int8 error-feedback cross-pod gradient reduction on ``mesh`` (a
    ``launch.mesh.Mesh`` with a ``pod`` axis), one rank's step.

    ``batch`` is the global batch (the same on every rank); each rank takes
    its pod's block (``batch_spec_fn``'s pod-leading spec) cut again along
    the pod's ``data`` axis, the split GSPMD makes inside the reference's
    ``shard_map``.  ``state.err`` holds the rank's pod row of each residual,
    ``(1, ...)`` (:func:`pod_rows`)."""
    if "pod" not in mesh.axis_names:
        raise ValueError("compressed step needs a pod axis")
    inner = tuple(a for a in mesh.axis_names if a != "pod")
    n_inner, n_pods = mesh.axis_size(inner), mesh.axis_size("pod")

    def rank_spec(spec: P) -> P:
        entries = list(spec)
        first = entries[0] if entries else None
        names = (first,) if isinstance(first, str) else tuple(first or ())
        if "pod" not in names:
            raise ValueError(f"batch spec {spec} does not lead with the pod axis")
        if "data" in inner and "data" not in names:
            names += ("data",)
        return P(names, *entries[1:])

    def train_step(state: TrainState, batch) -> tuple:
        local = tree_map(lambda x, s: Sharding(mesh, rank_spec(s)).local(x), batch,
                         batch_spec_fn(batch))
        metrics, grads = _grads(loss_fn, state.params, local)
        g_leaves = _mean_over(leaves(grads), mesh, inner, n_inner)
        e_leaves = leaves(state.err)
        if any(e.shape[0] != 1 for e in e_leaves):
            raise ValueError("state.err must hold this rank's pod rows (1, ...): pod_rows()")
        out = [compressed_psum(g, e[0], mesh, "pod") for g, e in zip(g_leaves, e_leaves)]
        it_g, it_e = iter([o[0] for o in out]), iter([o[1][None] for o in out])
        grads = tree_map(lambda _: next(it_g), grads)
        err = tree_map(lambda _: next(it_e), state.err)
        keys = sorted(metrics)
        vals = _mean_over([metrics[k].float().reshape(1) for k in keys], mesh, inner, n_inner)
        vals = _mean_over(vals, mesh, "pod", n_pods)
        metrics = {k: v[0] for k, v in zip(keys, vals)}
        return _apply(state, grads, metrics, optimizer, clip_norm, err)

    return train_step
