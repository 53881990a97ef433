"""Carry APSP state between the JAX package's numpy form and port tensors.

The JAX package hands state to the host as numpy arrays: cost matrices and
distances in float32 or bfloat16, predecessors in int32.  numpy has no
bfloat16 of its own, so bf16 travels as its uint16 bit view beside the
dtype name, as ``repro.checkpoint`` stores it; an ``ml_dtypes`` bfloat16
array (what ``np.asarray`` gives for a JAX bf16 array) is taken as well.
Every conversion keeps the bits.

The GNN's parameters cross as well: :func:`gnn_params_from_jax` turns the
JAX params tree (as numpy arrays) into a ``repro_torch.models.GNN``
``state_dict`` (its key is the tree path joined with ``.``) and
:func:`gnn_params_to_jax` turns one back into the JAX tree.  NequIP's
parameters cross by the same walk (:func:`nequip_params_from_jax`,
:func:`nequip_params_to_jax`): ``params["layers"][0]["radial"]["w1"]`` is
``"layers.0.radial.w1"`` of a ``repro_torch.models.nequip.NequIP``.

The LM's and MIND's parameter trees cross as trees, not ``state_dict``s:
:func:`lm_params_from_jax` turns the JAX tree (dicts and lists of host
arrays; the stacked layer leaves keep their leading L dimension) into the
port's tree of CPU tensors of the same layout, and :func:`lm_params_to_jax`
turns a port tree back into numpy arrays, a bf16 leaf as its uint16 bit
view (``to_numpy``).  :func:`mind_params_from_jax` /
:func:`mind_params_to_jax` are the same walk.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["to_torch", "to_numpy", "gnn_params_from_jax", "gnn_params_to_jax",
           "nequip_params_from_jax", "nequip_params_to_jax", "lm_params_from_jax",
           "lm_params_to_jax", "mind_params_from_jax", "mind_params_to_jax"]


def to_torch(a: np.ndarray, device="cpu", dtype: Optional[str] = None) -> torch.Tensor:
    """Host array -> a copy on ``device``, bit for bit.  ``dtype="bfloat16"``
    says that ``a`` is the uint16 bit view of a bf16 array."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        a, dtype = a.view(np.uint16), "bfloat16"
    if dtype == "bfloat16":
        if a.dtype != np.uint16:
            raise TypeError(f"a bf16 bit view is uint16, got {a.dtype}")
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Tensor -> (host array, dtype name).  bf16 leaves as its uint16 bit
    view, everything else in its own dtype."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def gnn_params_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """JAX GNN params tree (dicts and lists of host arrays) -> a CPU
    ``state_dict``: ``params["layers"][0]["mlp"][1]["w"]`` is
    ``"layers.0.mlp.1.w"``."""
    from repro_torch.tree import flatten_with_path

    return {".".join(path): to_torch(leaf) for path, leaf in flatten_with_path(params_np)}


def gnn_params_to_jax(state_dict: Dict[str, torch.Tensor]):
    """A GNN ``state_dict`` -> the JAX params tree of numpy arrays, lists
    where a key part is an index, dicts elsewhere."""
    root: dict = {}
    for key, t in state_dict.items():
        *parents, leaf = key.split(".")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = to_numpy(t)[0]

    def listify(node):
        if not isinstance(node, dict):
            return node
        kids = {k: listify(v) for k, v in node.items()}
        if kids and all(k.isdigit() for k in kids):
            return [kids[str(i)] for i in range(len(kids))]
        return kids

    return listify(root)


# NequIP's tree (dicts and a list of layers) walks as the GNN's does.
nequip_params_from_jax = gnn_params_from_jax
nequip_params_to_jax = gnn_params_to_jax


def lm_params_from_jax(params_np):
    """JAX LM params tree (dicts and lists of host arrays, bf16 as an
    ``ml_dtypes`` array) -> the port's tree of CPU tensors, bit for bit."""
    return tree_map(to_torch, params_np)


def lm_params_to_jax(params):
    """A port LM params tree -> the JAX tree of numpy arrays (bf16 as its
    uint16 bit view), bit for bit."""
    return tree_map(lambda t: to_numpy(t)[0], params)


# MIND's tree (a flat dict) walks as the LM's does.
mind_params_from_jax = lm_params_from_jax
mind_params_to_jax = lm_params_to_jax
