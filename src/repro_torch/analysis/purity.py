"""``host-sync`` — no host round trip on the per-round and per-launch path.

The port's counterpart of ``repro.analysis.purity`` (``trace-impurity``).
Eager PyTorch traces nothing, so the hazard the JAX checker guards, host
work inside the jitted solver, shows up here as a host sync: a Python
``if`` on a CUDA tensor, a ``.item()`` or a ``bool(t.any())`` waits for the
card to drain its queue and then for the host to launch the next grid, and
a solve of n/B rounds pays that once a round.  A read the port makes on
purpose (a fixpoint test, an early exit, a row-id check) carries
``# repro: allow-host-sync  <why>``.

**Reachability** (static, conservative).  The seeds are an explicit list,
:data:`SEEDS`: the blocked solver's rounds, every function of
``kernels/ops.py``, every ``*_cuda`` wrapper, the dynamic engine's update
passes, ``core/paths.spd_features`` and ``core/floyd_warshall``'s loops.
``missing_seeds`` names any seed the tree no longer defines, so that a
rename cannot empty the check.  From the seeds the call graph is walked
as ``repro.analysis.purity`` walks it (same-module calls, ``from .mod
import fn`` names, module-alias attribute calls), plus ``self.method()``
within a class.  Calls the resolver cannot see are not followed.

**Taint** (what is a tensor).  Parameters annotated with a ``Tensor``
type, the results of ``torch.*`` calls (but not ``torch.device``,
``torch.cuda.*`` and other host objects), of methods called on a tensor
(but not ``size()``, ``stride()``, ``numel()``, ``dim()``,
``is_contiguous()``, ``data_ptr()`` and other metadata, nor the syncs
themselves, whose results are host values), of calls of the tree's
functions whose return annotation names a ``Tensor`` (a ``Tuple[...]``
annotation taints the unpacked names element by element), of other calls
that take a tensor, and names assigned from any of these.  Shape metadata
(``x.shape``, ``x.dtype``, ``x.device``, ``x.is_cuda``, ...), ``is None``
tests and ``bool`` / ``int`` / ``float`` results are host values.

Flagged inside reachable code:
  * ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
  * ``bool`` / ``int`` / ``float`` of a tensor, and an ``if`` / ``while``
    / ternary / ``assert`` on one (``if t.any():``);
  * ``np.asarray`` / ``np.array`` of a tensor;
  * ``torch.cuda.synchronize``;
  * clock reads (``time.time``, ``time.perf_counter``, ...).

Scope: ``src/repro_torch/core/*`` + ``src/repro_torch/kernels/*``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .astutil import ModuleInfo, dotted, walk_source_order
from .base import Checker, Finding, Project, register_checker

__all__ = ["HostSyncChecker", "SEEDS", "missing_seeds"]

# (path under src/repro_torch, qualified name); a name starting with "*"
# seeds every module-level function whose name ends in the rest ("*" alone:
# every function, "*_cuda": every wrapper that launches a kernel).
SEEDS: Tuple[Tuple[str, str], ...] = (
    ("core/blocked_fw.py", "blocked_fw"),
    ("core/blocked_fw.py", "blocked_fw_batch"),
    ("core/blocked_fw.py", "_split_round"),
    ("core/blocked_fw.py", "_split_round_pred"),
    ("core/blocked_fw.py", "closure_block"),
    ("kernels/ops.py", "*"),
    ("kernels/fw_round.py", "*_cuda"),
    ("kernels/minplus.py", "*_cuda"),
    ("kernels/fw_block.py", "*_cuda"),
    ("kernels/row_close.py", "*_cuda"),
    ("core/dynamic.py", "DynamicAPSP.update"),
    ("core/dynamic.py", "DynamicAPSP._apply_decreases"),
    ("core/dynamic.py", "DynamicAPSP._apply_worsening"),
    ("core/dynamic.py", "apply_updates_batched"),
    ("core/dynamic.py", "_rank_k_fixpoint"),
    ("core/dynamic.py", "_rank_k_fixpoint_batch"),
    ("core/dynamic.py", "_row_close"),
    ("core/dynamic.py", "_warm_resolve"),
    ("core/paths.py", "spd_features"),
    ("core/floyd_warshall.py", "fw_squaring"),
    ("core/floyd_warshall.py", "fw_squaring_batch"),
    ("core/floyd_warshall.py", "fw_squaring_early_exit"),
    ("core/floyd_warshall.py", "fw_classic"),
    ("core/floyd_warshall.py", "fw_classic_batch"),
)

_PREFIX = "src/repro_torch/"

# attribute reads that are host metadata of a tensor
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "is_meta", "layout",
    "requires_grad", "is_sparse", "itemsize", "names",
}
# tensor methods that return host metadata, not a tensor
_STATIC_METHODS = {
    "size", "stride", "numel", "dim", "is_contiguous", "data_ptr",
    "element_size", "storage_offset", "nbytes", "untyped_storage",
    "get_device", "is_floating_point", "is_complex", "nelement",
}
# torch.* calls that return host objects
_HOST_TORCH_PREFIXES = (
    "torch.device", "torch.cuda.", "torch.finfo", "torch.iinfo", "torch.Size",
    "torch.get_default_dtype", "torch.is_tensor", "torch.Generator",
    "torch.no_grad", "torch.inference_mode", "torch.dtype",
)
# builtins that read only metadata of a tensor argument
_HOST_BUILTINS = {"len", "isinstance", "type", "id", "getattr", "hasattr", "callable",
                  "float", "int", "bool", "str", "repr"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_NP = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_HOST_CLOCK = {
    "time.time", "time.perf_counter", "time.monotonic", "time.process_time",
    "time.perf_counter_ns", "time.time_ns", "datetime.datetime.now",
    "datetime.now", "datetime.datetime.utcnow", "datetime.date.today",
}


def _tensor_annotation(node: Optional[ast.AST]) -> bool:
    return node is not None and "Tensor" in ast.unparse(node)


def _seed_names(info: ModuleInfo, pattern: str) -> List[str]:
    if not pattern.startswith("*"):
        return [pattern] if pattern in info.functions else []
    return [q for q in info.functions if "." not in q and q.endswith(pattern[1:])]


def missing_seeds(project: Project) -> List[str]:
    """Seeds of :data:`SEEDS` that the tree no longer defines."""
    out = []
    for rel, pattern in SEEDS:
        full = _PREFIX + rel
        info = ModuleInfo.build(project, full) if project.has(full) else None
        if info is None or not _seed_names(info, pattern):
            out.append(f"{rel}::{pattern}")
    return out


class HostSyncChecker(Checker):
    name = "host-sync"
    description = (
        "no host sync (.item/.cpu/.tolist/.numpy, bool/int/float or an if "
        "on a tensor, numpy of a tensor, torch.cuda.synchronize) and no "
        "clock read on the per-round and per-launch path (the blocked "
        "rounds, kernels.ops, the *_cuda wrappers, the engine's passes, "
        "spd_features, floyd_warshall's loops)"
    )

    def _in_scope(self, rel: str) -> bool:
        parts = rel.split("/")
        return (len(parts) >= 2 and parts[-2] in ("core", "kernels")
                and parts[-1] != "__init__.py")

    def run(self, project: Project) -> Iterator[Finding]:
        infos: Dict[str, ModuleInfo] = {}
        for rel in project.files():
            if self._in_scope(rel):
                info = ModuleInfo.build(project, rel)
                if info is not None:
                    infos[rel] = info

        reachable: Set[Tuple[str, str]] = set()
        work: List[Tuple[str, str]] = []
        for rel_tail, pattern in SEEDS:
            for rel, info in infos.items():
                if rel.endswith("/" + rel_tail) or rel == rel_tail:
                    for qual in _seed_names(info, pattern):
                        if (rel, qual) not in reachable:
                            reachable.add((rel, qual))
                            work.append((rel, qual))
        while work:
            rel, qual = work.pop()
            info = infos[rel]
            fn = info.functions.get(qual)
            if fn is None:
                continue
            for callee in self._callees(info, qual, fn, infos):
                if callee not in reachable:
                    reachable.add(callee)
                    work.append(callee)

        seen: Set[Tuple[str, int, str]] = set()
        for rel, qual in sorted(reachable):
            info = infos[rel]
            fn = info.functions.get(qual)
            if fn is None:
                continue
            for f in self._scan_function(project, info, qual, fn, infos):
                key = (f.path, f.line, f.message)
                if key not in seen:
                    seen.add(key)
                    yield f

    def _callees(self, info: ModuleInfo, qual: str, fn, infos) -> Iterator[Tuple[str, str]]:
        cls = qual.rsplit(".", 1)[0] if "." in qual else None
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                name = node.func.id
                if name in info.functions:
                    yield (info.rel, name)
                elif name in info.name_imports:
                    mod, orig = info.name_imports[name]
                    if mod in infos and orig in infos[mod].functions:
                        yield (mod, orig)
            elif isinstance(node.func, ast.Attribute) and isinstance(node.func.value, ast.Name):
                alias = node.func.value.id
                if alias == "self" and cls is not None:
                    meth = f"{cls}.{node.func.attr}"
                    if meth in info.functions:
                        yield (info.rel, meth)
                    continue
                mod = info.module_aliases.get(alias)
                if mod and mod in infos and node.func.attr in infos[mod].functions:
                    yield (mod, node.func.attr)

    @staticmethod
    def _callee(info: ModuleInfo, call: ast.AST, infos):
        """The tree's function a call reaches by name or module alias, or None."""
        if not isinstance(call, ast.Call):
            return None
        if isinstance(call.func, ast.Name):
            name = call.func.id
            if name in info.functions:
                return info.functions[name]
            if name in info.name_imports:
                mod, orig = info.name_imports[name]
                return infos[mod].functions.get(orig) if mod in infos else None
        elif isinstance(call.func, ast.Attribute) and isinstance(call.func.value, ast.Name):
            mod = info.module_aliases.get(call.func.value.id)
            if mod in infos:
                return infos[mod].functions.get(call.func.attr)
        return None

    def _returns(self, info: ModuleInfo, call: ast.Call, infos) -> Optional[bool]:
        """Whether a call of a function of the tree returns a tensor, read
        off its return annotation; None where the callee or its annotation
        is unknown."""
        target = self._callee(info, call, infos)
        if target is None or target.returns is None:
            return None
        return _tensor_annotation(target.returns)

    def _return_parts(self, info: ModuleInfo, call: ast.AST, infos) -> Optional[List[bool]]:
        """For a call of a function of the tree annotated ``-> Tuple[A, B,
        ...]``: whether each element is a tensor; else None."""
        ann = getattr(self._callee(info, call, infos), "returns", None)
        if not (isinstance(ann, ast.Subscript) and dotted(ann.value) in ("Tuple", "tuple",
                                                                         "typing.Tuple")):
            return None
        elts = ann.slice.elts if isinstance(ann.slice, ast.Tuple) else [ann.slice]
        return [_tensor_annotation(e) for e in elts]

    def _scan_function(self, project: Project, info: ModuleInfo, qual: str,
                       fn, infos) -> Iterator[Finding]:
        a = fn.args
        params = a.posonlyargs + a.args + a.kwonlyargs
        tainted: Set[str] = {p.arg for p in params if _tensor_annotation(p.annotation)}

        def taint(node: ast.AST) -> bool:
            if isinstance(node, ast.Name):
                return node.id in tainted
            if isinstance(node, ast.Attribute):
                if node.attr in _STATIC_ATTRS:
                    return False
                return taint(node.value)
            if isinstance(node, ast.Call):
                name = dotted(node.func) or ""
                if name.startswith(_HOST_TORCH_PREFIXES):
                    return False
                if name.startswith("torch."):
                    return True
                if isinstance(node.func, ast.Name) and node.func.id in _HOST_BUILTINS:
                    return False
                if isinstance(node.func, ast.Attribute):
                    if node.func.attr in _STATIC_METHODS or node.func.attr in _SYNC_METHODS:
                        return False
                    if taint(node.func.value):
                        return True
                returns = self._returns(info, node, infos)
                if returns is not None:
                    return returns
                return any(taint(x) for x in node.args) or any(
                    taint(kw.value) for kw in node.keywords)
            if isinstance(node, ast.Compare):
                if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                    return False
                return taint(node.left) or any(taint(c) for c in node.comparators)
            if isinstance(node, ast.BoolOp):
                return any(taint(v) for v in node.values)
            if isinstance(node, ast.UnaryOp):
                return taint(node.operand)
            if isinstance(node, ast.BinOp):
                return taint(node.left) or taint(node.right)
            if isinstance(node, ast.Subscript):
                return taint(node.value)
            if isinstance(node, (ast.Tuple, ast.List)):
                return any(taint(e) for e in node.elts)
            if isinstance(node, ast.IfExp):
                return taint(node.body) or taint(node.orelse)
            if isinstance(node, ast.Starred):
                return taint(node.value)
            return False

        def bind(target: ast.AST) -> None:
            for t in ast.walk(target):
                if isinstance(t, ast.Name):
                    tainted.add(t.id)

        where = f"in `{qual}` (on the per-round path)"
        for node in walk_source_order(fn):
            if isinstance(node, ast.Assign):
                tgt = node.targets[0] if len(node.targets) == 1 else None
                parts = None
                if isinstance(tgt, (ast.Tuple, ast.List)):
                    if isinstance(node.value, (ast.Tuple, ast.List)) and \
                            len(node.value.elts) == len(tgt.elts):
                        parts = [taint(e) for e in node.value.elts]
                    else:
                        parts = self._return_parts(info, node.value, infos)
                        if parts is not None and len(parts) != len(tgt.elts):
                            parts = None
                if parts is not None:
                    for t, p in zip(tgt.elts, parts):
                        if p:
                            bind(t)
                elif taint(node.value):
                    for t in node.targets:
                        bind(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None \
                    and taint(node.value):
                bind(node.target)
            elif isinstance(node, (ast.For, ast.comprehension)) and taint(node.iter):
                bind(node.target)
            if isinstance(node, (ast.If, ast.While)) and taint(node.test):
                kind = "if" if isinstance(node, ast.If) else "while"
                yield self.finding(
                    project, info.rel, node.lineno,
                    f"python `{kind}` on a tensor {where} — a host sync; keep the "
                    "decision on the device or read it once where it is needed")
            elif isinstance(node, ast.IfExp) and taint(node.test):
                yield self.finding(project, info.rel, node.lineno,
                                   f"ternary on a tensor {where} — a host sync")
            elif isinstance(node, ast.Assert) and taint(node.test):
                yield self.finding(project, info.rel, node.lineno,
                                   f"assert on a tensor {where} — a host sync")
            elif isinstance(node, ast.Call):
                name = dotted(node.func)
                if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS \
                        and (node.func.attr == "cpu" or not node.args):
                    yield self.finding(
                        project, info.rel, node.lineno,
                        f".{node.func.attr}() {where} — copies to the host and waits "
                        "for the card")
                elif name in _HOST_NP and any(taint(x) for x in node.args):
                    yield self.finding(project, info.rel, node.lineno,
                                       f"{name} of a tensor {where} — a host round trip")
                elif name == "torch.cuda.synchronize":
                    yield self.finding(project, info.rel, node.lineno,
                                       f"torch.cuda.synchronize {where} — waits for the card")
                elif name in _HOST_CLOCK:
                    yield self.finding(project, info.rel, node.lineno,
                                       f"{name} {where} — a clock read on the launch path")
                elif isinstance(node.func, ast.Name) and node.func.id in ("float", "int", "bool") \
                        and node.args and any(taint(x) for x in node.args):
                    yield self.finding(
                        project, info.rel, node.lineno,
                        f"{node.func.id}() of a tensor {where} — a host sync")


register_checker(HostSyncChecker())
