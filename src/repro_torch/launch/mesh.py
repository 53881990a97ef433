"""Device meshes of the PyTorch port, ported from ``repro.launch.mesh``.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model): the ``pod``
axis carries the cross-pod traffic only; ``model`` stays inside a pod.

A :class:`Mesh` lays the ranks of an initialised process group out
row-major over named axes (as ``jax.make_mesh`` lays out its devices) on
a ``torch.distributed.device_mesh.DeviceMesh``, whose per-dimension
groups carry the collectives along one axis; the multi-pod row axes
``("pod", "data")`` get one flattened group of their own, and so do a
pod's own ranks (every axis but ``pod``, the compressed train step's
in-pod average).  Every rank creates the groups in the same order, as
``new_group`` requires.  Each rank holds its local blocks on
``Mesh.device``.

The solvers' collectives are broadcasts from an owning rank
(:meth:`Mesh.broadcast`); the compressed train step all-reduces.  gloo
has both for CUDA tensors as NCCL does: several ranks on one card (NCCL
refuses two ranks on one GPU) run under gloo, which stages each
collective through the host.

On the ``meta`` device, :func:`make_production_mesh` gives the virtual
mesh the dry run lays cells over (``launch/dryrun.py``): the same ranks
and axes and no process groups, seen from rank 0.  A broadcast reports the
bytes it would send to the dry run's counter (``roofline.op_cost``)
whether or not the mesh has groups to send them.

Functions, not module constants: importing this module initialises no
process group.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_host_mesh"]

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes over the ranks ``devices`` (an array of global ranks of
    the mesh's shape).  ``groups`` maps each axis tuple the mesh carries
    collectives along to its process group; a mesh without groups is a
    single process's (``make_host_mesh``), whose broadcasts are no-ops."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], device,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} given axes {self.axis_names}")
        self.device = torch.device(device)
        self.groups = groups
        self.rank = dist.get_rank() if groups is not None else int(self.devices.flat[0])
        where = np.argwhere(self.devices == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.devices.tolist()}")
        self.coords = tuple(int(i) for i in where[0])

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def axis_index(self, axes: Axes, coords: Optional[Tuple[int, ...]] = None) -> int:
        """The linear index over ``axes`` (the first axis major) of the rank
        at ``coords`` (this rank's if None), as ``lax.axis_index`` of an
        axis tuple."""
        coords = self.coords if coords is None else coords
        idx = 0
        for a in _axes(axes):
            i = self.axis_names.index(a)
            idx = idx * self.devices.shape[i] + coords[i]
        return idx

    def rank_along(self, axes: Axes, index: int) -> int:
        """The global rank whose index over ``axes`` is ``index`` and whose
        other coordinates are this rank's."""
        coords = list(self.coords)
        for a in reversed(_axes(axes)):
            i = self.axis_names.index(a)
            index, coords[i] = divmod(index, self.devices.shape[i])
        return int(self.devices[tuple(coords)])

    def group(self, axes: Axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes``."""
        axes = _axes(axes)
        if set(axes) == set(self.axis_names):
            return dist.group.WORLD
        if axes not in self.groups:
            raise ValueError(f"the mesh carries no collectives along {axes}; it has "
                             f"{sorted(self.groups)}")
        return self.groups[axes]

    def broadcast(self, t: torch.Tensor, axes: Axes, src_index: int) -> torch.Tensor:
        """``t`` (contiguous, filled on the source, any values elsewhere)
        broadcast in place along ``axes`` from the rank whose index over
        them is ``src_index``: exact under every semiring (the reference's
        masked ``psum``).  The dry run's counter takes its bytes when more
        than one rank lies along ``axes``."""
        if self.axis_size(axes) > 1:
            from repro_torch.roofline import op_cost

            op_cost.report_collective("broadcast", t.numel() * t.element_size())
        if self.groups is not None:
            dist.broadcast(t, src=self.rank_along(axes, src_index), group=self.group(axes))
        return t

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda") -> Mesh:
    """A mesh over every rank of the initialised default process group
    (``prod(shape)`` must be its world size), ranks laid out row-major."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the "
                         f"process group has {world}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    devices = np.arange(world).reshape(shape)
    dm = DeviceMesh(device.type, torch.from_numpy(devices), mesh_dim_names=axes)
    groups = {(a,): dm.get_group(a) for a in axes}
    if "pod" in axes and "data" in axes:
        # The multi-pod row axes: one group a column of the (pod, data) plane.
        rows = np.moveaxis(devices, [axes.index("pod"), axes.index("data")], [0, 1])
        rows = rows.reshape(shape[axes.index("pod")] * shape[axes.index("data")], -1).T
        groups[("pod", "data")], _ = dist.new_subgroups_by_enumeration(rows.tolist())
    inner = tuple(a for a in axes if a != "pod")
    if "pod" in axes and len(inner) > 1:
        # A pod's own ranks (every axis but pod): one group a pod.
        pods = np.moveaxis(devices, axes.index("pod"), 0).reshape(shape[axes.index("pod")], -1)
        groups[inner], _ = dist.new_subgroups_by_enumeration(pods.tolist())
    return Mesh(devices, axes, device, groups)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The production mesh over the process group's ranks; on ``meta`` the
    virtual one (no process group, rank 0's view) that the dry run uses."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if torch.device(device).type == "meta":
        return Mesh(np.arange(math.prod(shape)).reshape(shape), axes, "meta")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(*, device="cuda") -> Mesh:
    """Degenerate 1x1 mesh of this process alone (same axis names), with no
    process group: its broadcasts do nothing."""
    return Mesh(np.zeros((1, 1), np.int64), ("data", "model"), device)
