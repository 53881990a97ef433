"""Sharding helpers of the PyTorch port, ported from ``repro.sharding``:
spec trees -> sharding trees, mesh-aware axes.

:class:`PartitionSpec` is the port's own (JAX's ``PartitionSpec``): one
entry a tensor dimension, ``None`` (replicated), an axis name or a tuple
of names (the dimension sharded over their product, the first axis
major).  A :class:`Sharding` is the ``(mesh, spec)`` pair of JAX's
``NamedSharding``; each rank holds the local block that
:meth:`Sharding.local_slices` names.  Neither is a tuple or a dataclass,
so the port's tree walks (``repro_torch.tree``) take them as leaves.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import tree_map

__all__ = ["PartitionSpec", "P", "Sharding", "batch_axes_for", "make_shardings",
           "filter_spec_for_mesh"]

Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec:
    """How each dimension of a tensor lies over a mesh's axes (immutable)."""

    __slots__ = ("_entries",)

    def __init__(self, *entries: Union[None, str, Sequence[str]]):
        out = []
        for e in entries:
            if e is None or isinstance(e, str):
                out.append(e)
            else:
                out.append(tuple(e))
        object.__setattr__(self, "_entries", tuple(out))

    def __setattr__(self, *_):
        raise AttributeError("PartitionSpec is immutable")

    def __reduce__(self):
        return PartitionSpec, self._entries

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i) -> Entry:
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


class Sharding:
    """A tensor laid out over ``mesh`` by ``spec`` (JAX's ``NamedSharding``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def local_slices(self, shape: Sequence[int], coords: Optional[Tuple[int, ...]] = None
                     ) -> Tuple[slice, ...]:
        """The block of a global ``shape`` that the rank at ``coords`` (this
        rank if None) holds; a sharded dimension must divide evenly."""
        out = []
        for dim, size in enumerate(shape):
            e = self.spec[dim] if dim < len(self.spec) else None
            if e is None:
                out.append(slice(None))
                continue
            parts = self.mesh.axis_size(e)
            if size % parts:
                raise ValueError(f"dimension {dim} of {tuple(shape)} does not split into "
                                 f"{parts} blocks over {e}")
            step = size // parts
            i = self.mesh.axis_index(e, coords)
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of the block a rank holds of a global ``shape`` (every
        rank's is the same: the dimensions divide evenly)."""
        return tuple(len(range(*s.indices(n))) for s, n in zip(self.local_slices(shape), shape))

    def local_nbytes(self, shape: Sequence[int], dtype: torch.dtype) -> int:
        """Bytes of a rank's block of a global ``shape`` of ``dtype``."""
        return math.prod(self.local_shape(shape)) * dtype.itemsize

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global ``t`` (a view)."""
        return t[self.local_slices(t.shape)]

    def __repr__(self) -> str:
        return f"Sharding({self.mesh!r}, {self.spec!r})"


def batch_axes_for(mesh: Mesh) -> Tuple[str, ...]:
    """Batch shards over the pod axis too when it exists (multi-pod)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def filter_spec_for_mesh(spec: PartitionSpec, mesh: Mesh) -> PartitionSpec:
    """Drop axis names the mesh does not have (lets one spec tree serve both
    the single-pod and multi-pod meshes)."""
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a in mesh.axis_names)
            out.append(kept if kept else None)
        else:
            out.append(e if e in mesh.axis_names else None)
    return PartitionSpec(*out)


def make_shardings(mesh: Mesh, spec_tree):
    """PartitionSpec tree -> Sharding tree (mesh-filtered)."""
    return tree_map(lambda s: Sharding(mesh, filter_spec_for_mesh(s, mesh)), spec_tree)
