"""Counted cost of a step run eagerly: the port's counterpart of
``repro.roofline.hlo_cost``.

The reference parses XLA's optimized HLO and multiplies loop bodies by
their trip counts.  In eager PyTorch every op is a kernel boundary and every
Python loop runs unrolled, so the port counts the ops themselves as they
dispatch: :class:`OpCounter` is a ``TorchDispatchMode`` that, for each op,

  * dot FLOPs     with ``torch.utils.flop_counter``'s registered formulas
                  (the ones ``FlopCounterMode`` uses), by result dtype;
  * elementwise   result elements of each pointwise op (copies and casts
                  excluded), input elements of each reduction and softmax,
                  source elements of each scatter-add;
  * HBM bytes     operand bytes plus result bytes of every op that is not a
                  view or an uninitialised allocation (an expanded operand
                  counts its storage at most);
  * live bytes    the storages each op creates, held until they die (a
                  weakref on each), and their peak: the step's temp memory.

The hand-written kernels' wrappers and the mesh's collectives report to
the active counter themselves (:func:`report_kernel`,
:func:`report_collective`): a kernel is one ctypes call that dispatches
nothing, and a mesh without process groups sends nothing.  On ``meta``
tensors nothing is allocated and no kernel runs: a dry run.
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .analysis import HW, collective_bytes, rate_of

__all__ = ["OpCost", "OpCounter", "KernelLog", "active", "report_kernel",
           "report_collective"]

aten = torch.ops.aten

# Pointwise-tagged ops that move data and compute nothing.
_COPIES = {aten.clone, aten.copy, aten.copy_, aten._to_copy, aten.lift_fresh_copy,
           aten.alias_copy, aten.detach_copy}
# Ops priced by their first input's elements (a pass over it).
_REDUCES = {aten._softmax, aten._log_softmax, aten._softmax_backward_data,
            aten._log_softmax_backward_data, aten.cumsum, aten.topk, aten.sort,
            aten.argmax, aten.argmin, aten.max, aten.min, aten.var, aten.std,
            aten.var_mean, aten.std_mean}
# Scatter-accumulates, priced by their source's elements (one ⊕ each).
_SCATTERS = {aten.index_add: 3, aten.index_add_: 3, aten.scatter_add: 3,
             aten.scatter_add_: 3, aten.scatter_reduce: 3, aten.scatter_reduce_: 3,
             aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2}
# Allocations that write nothing, and ops that only relabel a storage.
_NO_TRAFFIC = {aten.empty, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
               aten.empty_like, aten._unsafe_view, aten.lift_fresh, aten.detach, aten.alias,
               aten.as_strided, aten.t, aten.sym_size, aten.sym_stride, aten.sym_numel,
               aten.sym_storage_offset, aten.is_same_size, aten._local_scalar_dense}

# The running counters of each thread, innermost last: a kernel launched
# from another thread (the serving pool's drains) reports to none of them.
_LOCAL = threading.local()


def _stack() -> List["OpCounter"]:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


def active() -> Optional["OpCounter"]:
    """This thread's innermost running :class:`OpCounter`, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def report_kernel(name: str, work, *, shape: str = "", plan: Any = None) -> None:
    """A hand-written kernel's launch (``roofline.kernels.Work``) for the
    active counter, if any; the wrappers call it on the ``meta`` route and
    on the card."""
    c = active()
    if c is not None:
        c.kernel(name, work, shape=shape, plan=plan)


class KernelLog:
    """Every kernel report made on this thread inside ``with KernelLog() as
    log:``, in order: ``log.launches`` holds ``(name, shape, plan, work)``
    a launch (or a ``meta`` call).  It takes the reports the innermost
    running counter would take, so an :class:`OpCounter` around it sees
    none of them; its ``cost`` collects the collectives."""

    def __init__(self):
        self.launches: List[Tuple[str, str, Any, Any]] = []
        self.cost = OpCost()

    def __enter__(self) -> "KernelLog":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().remove(self)

    def kernel(self, name: str, work, *, shape: str = "", plan: Any = None) -> None:
        self.launches.append((name, shape, plan, work))


def report_collective(kind: str, nbytes: int) -> None:
    """A collective's bytes (what it would send) for the active counter."""
    c = active()
    if c is not None:
        c.cost.collectives.append((kind, int(nbytes)))


@dataclass
class OpCost:
    dot_flops: float = 0.0
    dot_flops_by_dtype: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    elem_ops: float = 0.0
    kernel_ops: float = 0.0        # the hand-written kernels' instructions
    hbm_bytes: float = 0.0
    collectives: List[Tuple[str, int]] = field(default_factory=list)   # (kind, bytes)
    kernels: Dict[str, dict] = field(default_factory=dict)
    ops: int = 0
    peak_live_bytes: int = 0

    @property
    def flops(self) -> float:
        return self.dot_flops + self.elem_ops + self.kernel_ops

    @property
    def coll_bytes(self) -> Dict[str, int]:
        """Bytes per collective kind (``analysis.collective_bytes``)."""
        return collective_bytes(self.collectives)

    def compute_s(self) -> float:
        """Seconds of the counted work at one card's rates (``analysis``'s
        module docstring says which rate prices which work)."""
        t = sum(f / rate_of(dt) for dt, f in self.dot_flops_by_dtype.items())
        return t + (self.elem_ops + self.kernel_ops) / HW.LANE_RATE


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes, an expanded view's storage at most."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):   # a storage-less tensor
        return n


class OpCounter(TorchDispatchMode):
    """Count every op dispatched inside ``with OpCounter(track=args) as c:``
    into ``c.cost``.  Storages of ``track`` (the step's arguments) are not
    the step's own: they count neither as live nor at the peak."""

    def __init__(self, *, track=()):
        super().__init__()
        self.cost = OpCost()
        self._live = 0
        self._storages: Dict[int, Any] = {}
        self._args: set = set()
        self._kind: Dict[Any, str] = {}
        for t in _tensors(list(track), []):
            self._own(t, count=False)

    def __enter__(self):
        _stack().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _stack().remove(self)

    # -- live bytes ------------------------------------------------------

    def _own(self, t: torch.Tensor, count: bool = True) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._storages:
            return
        nbytes = st.nbytes() if count else 0

        def gone(_ref, key=key, nbytes=nbytes):
            self._live -= nbytes
            self._storages.pop(key, None)
            self._args.discard(key)

        self._storages[key] = weakref.ref(st, gone)
        if not count:
            self._args.add(key)
        elif nbytes:
            self._live += nbytes
            if self._live > self.cost.peak_live_bytes:
                self.cost.peak_live_bytes = self._live

    def is_arg(self, t: torch.Tensor) -> bool:
        """Whether ``t`` lies in the storage of one of the tracked arguments."""
        return id(t.untyped_storage()) in self._args

    @property
    def live_bytes(self) -> int:
        """Bytes of the storages created inside the counter still alive."""
        return self._live

    # -- reports ---------------------------------------------------------

    def kernel(self, name: str, work, *, shape: str = "", plan: Any = None) -> None:
        c = self.cost
        k = c.kernels.setdefault(name, {"launches": 0, "candidates": 0, "instructions": 0,
                                        "bytes": 0, "bound_ms": 0.0, "shapes": {},
                                        "plans": {}})
        k["launches"] += 1
        k["candidates"] += work.candidates
        k["instructions"] += work.instructions * work.candidates
        k["bytes"] += work.bytes
        k["bound_ms"] += work.bound()[0]
        if shape:
            k["shapes"][shape] = k["shapes"].get(shape, 0) + 1
        if plan is not None:
            k["plans"][repr(plan)] = k["plans"].get(repr(plan), 0) + 1
        c.kernel_ops += work.instructions * work.candidates
        c.hbm_bytes += work.bytes

    # -- ops -------------------------------------------------------------

    def _classify(self, func) -> str:
        kind = self._kind.get(func)
        if kind is None:
            packet = func._overloadpacket
            if packet in flop_registry:
                kind = "dot"
            elif packet in _SCATTERS:
                kind = "scatter"
            elif packet in _COPIES:
                kind = "copy"
            elif torch.Tag.pointwise in func.tags:
                kind = "pointwise"
            elif torch.Tag.reduction in func.tags or packet in _REDUCES:
                kind = "reduce"
            else:
                kind = "other"
            if func.is_view or packet in _NO_TRAFFIC:
                kind += ":free"
            self._kind[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        kind = self._classify(func)
        base = kind.split(":")[0]
        outs = _tensors(out, [])
        if base == "dot":
            f = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
            c.dot_flops += f
            c.dot_flops_by_dtype[str(outs[0].dtype).replace("torch.", "")] += f
        elif base == "pointwise":
            c.elem_ops += sum(t.numel() for t in outs)
        elif base == "reduce":
            ins = _tensors(args, [])
            c.elem_ops += ins[0].numel() if ins else 0
        elif base == "scatter":
            at = _SCATTERS[func._overloadpacket]
            adds = at == 3 or (args[3] if len(args) > 3 else kwargs.get("accumulate", False))
            if adds and len(args) > at:
                c.elem_ops += args[at].numel()
        if not kind.endswith(":free"):
            c.hbm_bytes += sum(_nbytes(t) for t in _tensors(args, _tensors(
                list(kwargs.values()), []))) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._own(t)
        return out
