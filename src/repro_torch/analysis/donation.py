"""``donation`` — the port's buffer-donation contract, restated for PyTorch.

The port's counterpart of ``repro.analysis.donation``.  JAX donation is a
claim about the compiled program (an input/output alias) that the runtime
enforces by deleting the donated buffer.  Torch can neither alias at
compile time nor delete a buffer (ROADMAP "Divergences: Buffers"), so the
reference's three claims become these:

(a) **No read after donation** (tier A, AST).  Within a function of
    ``src/repro_torch``, a name passed as the first argument of a call
    with ``donate=True`` (or of a function whose ``donate`` parameter
    defaults to ``True``; a class's ``donate=`` configures the object's
    own state and donates no argument) is not read again before it is
    rebound.  A later read would see the solve's result, not the input.
(b) **Aliasing** (tier B, runtime).  Each :class:`DonationSpec` runs an
    entry point on small concrete inputs and compares the result's
    ``untyped_storage().data_ptr()`` with the donated input's:
    ``blocked_fw`` / ``blocked_fw_batch`` with ``donate=True`` return the
    caller's storage (fused and split, with and without preds);
    ``DynamicAPSP(donate=True)`` keeps its ``dist`` / ``pred`` storage
    across a rank-k update, a row re-close and a warm re-solve; ``rkleene``
    states that it never aliases (its ``donate=`` has no effect) and is
    held to that.
(c) **Consumption through the public wrappers** (tier B, runtime), the
    reference's ``_wrapper_consumption_findings``.  Where JAX deletes the
    donated buffer, the port's donating wrapper leaves its result in the
    donated storage: ``solve(donate=True)`` on a caller's float32 tensor
    already on the device and a multiple of the block returns ``dist`` in
    the caller's storage; so does ``solve_batch(donate=True)`` on a
    pre-stacked full-size float32 stack (``pad_batch`` passes it through
    as itself); and ``DynamicAPSP(donate=True).update`` commits an
    incremental (rank-k) update into the storage of the ``dist`` the
    engine held before it.  These run on the CPU, and with
    ``require_cuda`` (``--require-cuda``) on the card too.
(d) **Memory** (card only): ``chip_smoke.py``'s phase 13c reads
    ``torch.cuda.max_memory_allocated`` around a donating and a copying
    solve at full size.

Tier B imports and runs the solvers, so it only runs when the analyzed
tree holds their sources; a fixture tree is skipped with a notice on
stderr.  Tests pass their own specs to :func:`run_donation_checks`, which
then skips (c), as ``wrappers=False`` does.  The checker prints the number
of wrapper checks a device on stderr, as ``analyze: [donation] {json}``.
"""

from __future__ import annotations

import ast
import json
import sys
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .astutil import dotted
from .base import Checker, Finding, Project, register_checker

__all__ = [
    "DonationSpec",
    "default_specs",
    "run_donation_checks",
    "read_after_donation",
    "DonationChecker",
]

_CHECK = "donation"


# ---------------------------------------------------------------------------
# (a) no read after donation
# ---------------------------------------------------------------------------

def _donating_defaults(project: Project) -> Set[str]:
    """Names of module-level functions (and methods) of the tree whose
    ``donate`` parameter defaults to ``True``."""
    out: Set[str] = set()
    for rel in project.files():
        tree = project.tree(rel)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                continue
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or node.name == "__init__":
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            defaults = dict(zip([p.arg for p in pos][len(pos) - len(a.defaults):], a.defaults))
            defaults.update({p.arg: d for p, d in zip(a.kwonlyargs, a.kw_defaults)
                             if d is not None})
            d = defaults.get("donate")
            if isinstance(d, ast.Constant) and d.value is True:
                out.add(node.name)
    return out


def _classes(project: Project) -> Set[str]:
    out: Set[str] = set()
    for rel in project.files():
        tree = project.tree(rel)
        if tree is not None:
            out.update(n.name for n in ast.walk(tree) if isinstance(n, ast.ClassDef))
    return out


def _donated_name(call: ast.Call, defaults: Set[str], classes: Set[str] = frozenset()
                  ) -> Optional[str]:
    """The name this call donates, if it donates a plain name (a class's
    ``donate=`` configures the object and donates no argument)."""
    if (dotted(call.func) or "").split(".")[-1] in classes:
        return None
    kw = {k.arg: k.value for k in call.keywords if k.arg}
    given = kw.get("donate")
    if given is not None:
        if not (isinstance(given, ast.Constant) and given.value is True):
            return None
    else:
        name = dotted(call.func) or ""
        if name.split(".")[-1] not in defaults:
            return None
    if call.args and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    return None


_COMPOUND = (ast.If, ast.For, ast.AsyncFor, ast.While, ast.With, ast.AsyncWith, ast.Try,
             ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _statements(body) -> Iterator[ast.AST]:
    """Statements in source order; a compound statement yields its header
    expressions (as an ``ast.Expr`` stand-in) and then its bodies."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue                      # a nested scope is checked on its own
        if isinstance(stmt, _COMPOUND):
            for field in ("test", "iter", "items"):
                head = getattr(stmt, field, None)
                if head is None:
                    continue
                heads = head if isinstance(head, list) else [head]
                for h in heads:
                    expr = h.context_expr if isinstance(h, ast.withitem) else h
                    yield ast.copy_location(ast.Expr(value=expr), stmt)
                    if isinstance(h, ast.withitem) and h.optional_vars is not None:
                        yield ast.copy_location(
                            ast.Assign(targets=[h.optional_vars], value=ast.Constant(None)),
                            stmt)
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                yield ast.copy_location(ast.Assign(targets=[stmt.target],
                                                   value=ast.Constant(None)), stmt)
            for field in ("body", "orelse", "finalbody"):
                yield from _statements(getattr(stmt, field, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                yield from _statements(h.body)
        else:
            yield stmt


def read_after_donation(project: Project, rel: str, defaults: Set[str],
                        classes: Set[str] = frozenset()) -> Iterator[tuple]:
    """(line, name, donated at) for every read of a donated name."""
    tree = project.tree(rel)
    if tree is None:
        return
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        donated: Dict[str, int] = {}
        for stmt in _statements(fn.body):
            loads = [n for n in ast.walk(stmt)
                     if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]
            for n in loads:
                if n.id in donated:
                    yield (n.lineno, n.id, donated[n.id])
            for call in (c for c in ast.walk(stmt) if isinstance(c, ast.Call)):
                name = _donated_name(call, defaults, classes)
                if name is not None:
                    donated[name] = call.lineno
            for n in ast.walk(stmt):
                if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
                    donated.pop(n.id, None)


# ---------------------------------------------------------------------------
# (b) aliasing, on concrete inputs
# ---------------------------------------------------------------------------

@dataclass
class DonationSpec:
    """One donating entry point to check.

    ``run()`` builds fresh concrete inputs, calls the entry point and
    returns ``(donated, results)``: the ``untyped_storage().data_ptr()`` of
    each donated input, taken before the call, and for each the result
    tensors that must (``alias=True``) or must not (``alias=False``) lie in
    that storage."""

    name: str
    path: str                        # repo-relative source file for findings
    run: Callable[[], tuple]
    alias: bool = True


def storage_ptr(t) -> int:
    return t.untyped_storage().data_ptr()


def check_spec(spec: DonationSpec) -> List[Finding]:
    donated, results = spec.run()
    out: List[Finding] = []
    for i, (src, outs) in enumerate(zip(donated, results)):
        for j, res in enumerate(outs):
            shared = storage_ptr(res) == src
            if shared != spec.alias:
                out.append(Finding(
                    check=_CHECK, path=spec.path, line=0,
                    message=(f"{spec.name}: result {j} of donated input {i} does not lie in "
                             "the input's storage" if spec.alias else
                             f"{spec.name}: result {j} aliases donated input {i}'s storage, "
                             "against the module's stated claim that it never does")))
    return out


def _host_matrix(n: int, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.integers(1, 10, size=(n, n)).astype(np.float32)
    a = np.where(rng.uniform(size=(n, n)) < 0.3, np.inf, a).astype(np.float32)
    np.fill_diagonal(a, 0.0)
    return a


def default_specs(device: str = "cpu") -> List[DonationSpec]:
    """The port's donating entry points on ``device``, at N <= 32."""
    import importlib

    import numpy as np
    import torch

    bfw = importlib.import_module("repro_torch.core.blocked_fw")
    rkl = importlib.import_module("repro_torch.core.rkleene")
    dyn = importlib.import_module("repro_torch.core.dynamic")

    def tensor(a):
        return torch.from_numpy(a).to(device)

    def blocked(n: int, b: int, round_mode: str, with_pred: bool, batch: bool):
        def run():
            h = (torch.stack([tensor(_host_matrix(n, s)) for s in range(2)]) if batch
                 else tensor(_host_matrix(n)))
            ptr = storage_ptr(h)
            fn = bfw.blocked_fw_batch if batch else bfw.blocked_fw
            dist, _ = fn(h, block_size=b, round_mode=round_mode, with_pred=with_pred,
                         donate=True)
            return (ptr,), ((dist,),)
        return run

    def engine(path: str):
        def run():
            n = 24
            h = _host_matrix(n, seed=5)
            eng = dyn.DynamicAPSP(h, with_pred=True, donate=True, device=device, block_size=8,
                                  resolve_threshold=0.99,
                                  row_threshold=1.0 if path == "row" else 0.0)
            dist, pred = eng.dist, eng.pred
            if path == "rank-k":
                eng.update([1, 3], [2, 9], [0.5, 0.5])
            else:
                # worsen edges on best paths: the row re-close, or with a row
                # threshold of 0 the warm re-solve
                d = eng.dist.cpu().numpy()
                us, vs = [], []
                for u in range(n):
                    for v in range(n):
                        if u != v and np.isfinite(h[u, v]) and h[u, v] == d[u, v]:
                            us.append(u)
                            vs.append(v)
                us, vs = us[:2], vs[:2]
                eng.update(us, vs, [float(h[u, v]) + 50.0 for u, v in zip(us, vs)])
            stats = dict(eng.stats)
            want = {"rank-k": "rank_k", "row": "row_resolve", "warm": "warm_resolve"}[path]
            if not stats[want]:
                raise AssertionError(f"the {path} spec took another path: {stats}")
            return (storage_ptr(dist), storage_ptr(pred)), ((eng.dist,), (eng.pred,))
        return run

    def rkleene():
        def run():
            h = tensor(_host_matrix(32))
            ptr = storage_ptr(h)
            dist, _ = rkl.rkleene(h, base=8, donate=True)
            return (ptr,), ((dist,),)
        return run

    bf = "src/repro_torch/core/blocked_fw.py"
    dy = "src/repro_torch/core/dynamic.py"
    specs = []
    for mode in ("fused", "split"):
        for pred in (False, True):
            tag = mode + (",pred" if pred else "")
            specs.append(DonationSpec(f"blocked_fw[{tag}]", bf, blocked(32, 8, mode, pred, False)))
            specs.append(DonationSpec(f"blocked_fw_batch[{tag}]", bf,
                                      blocked(16, 8, mode, pred, True)))
    specs += [
        DonationSpec("DynamicAPSP[rank-k]", dy, engine("rank-k")),
        DonationSpec("DynamicAPSP[row re-close]", dy, engine("row")),
        DonationSpec("DynamicAPSP[warm re-solve]", dy, engine("warm")),
        DonationSpec("rkleene", "src/repro_torch/core/rkleene.py", rkleene(), alias=False),
    ]
    return specs


def _wrapper_checks(device: str = "cpu") -> List[Tuple[str, str, Callable[[], bool]]]:
    """``(path, message, consumed)`` for each public wrapper that donates:
    ``consumed()`` runs it on fresh inputs on ``device`` and says whether
    the donated storage holds its result (the module docstring's (c))."""
    import importlib

    import torch

    apsp = importlib.import_module("repro_torch.core.apsp")
    dyn = importlib.import_module("repro_torch.core.dynamic")

    def tensor(a):
        return torch.from_numpy(a).to(device)

    def solve():
        h = tensor(_host_matrix(32))
        ptr = storage_ptr(h)
        r = apsp.solve(h, method="blocked_fw", block_size=16, donate=True, device=device)
        return storage_ptr(r.dist) == ptr

    def solve_batch():
        # a pre-stacked full-size float32 stack on the device: pad_batch
        # passes it through as itself, so the caller's storage is donated
        # (a ragged list donates only the packed stack the call made)
        hs = torch.stack([tensor(_host_matrix(16, seed=7)), tensor(_host_matrix(16, seed=8))])
        ptr = storage_ptr(hs)
        r = apsp.solve_batch(hs, method="blocked_fw", block_size=8, donate=True, device=device)
        return storage_ptr(r.dist) == ptr

    def update():
        eng = dyn.DynamicAPSP(_host_matrix(16, seed=9), method="squaring", with_pred=True,
                              donate=True, device=device)
        ptr = storage_ptr(eng.dist)
        info = eng.update([1], [2], [0.25])
        if info["path"] != "rank_k":
            raise AssertionError(f"the DynamicAPSP.update check took another path: {info}")
        return storage_ptr(eng.dist) == ptr

    ap, dy = "src/repro_torch/core/apsp.py", "src/repro_torch/core/dynamic.py"
    return [
        (ap, "solve(donate=True) did not consume its input buffer: the result's dist "
             "does not lie in the caller's storage", solve),
        (ap, "solve_batch(donate=True) did not consume its pre-stacked input buffer: "
             "the result's dist does not lie in the caller's storage", solve_batch),
        (dy, "DynamicAPSP.update(donate=True) did not consume the previous dist buffer: "
             "the updated dist does not lie in its storage", update),
    ]


def _wrapper_consumption_findings(device: str = "cpu") -> List[Finding]:
    """End-to-end checks through the public wrappers on ``device``:
    donation must consume (in the port: leave the result in the donated
    storage)."""
    return [Finding(check=_CHECK, path=path, line=0, message=message)
            for path, message, consumed in _wrapper_checks(device) if not consumed()]


def run_donation_checks(specs: Optional[Sequence[DonationSpec]] = None, *,
                        wrappers: bool = True) -> List[Finding]:
    """Run the aliasing specs (default: the port's entry points on the CPU)
    and, given no ``specs`` and ``wrappers``, the public wrappers'
    consumption checks on the CPU."""
    findings: List[Finding] = []
    for spec in (default_specs() if specs is None else specs):
        findings.extend(check_spec(spec))
    if specs is None and wrappers:
        findings.extend(_wrapper_consumption_findings())
    return findings


class DonationChecker(Checker):
    name = _CHECK
    description = (
        "no read of a name after it was donated (donate=True) before it is "
        "rebound; donating solves return the caller's storage, the engine "
        "keeps its dist/pred storage, rkleene never aliases, and the public "
        "wrappers (solve, solve_batch, DynamicAPSP.update) leave their result "
        "in the donated storage (tier B runs the solvers at N <= 32)"
    )
    # --require-cuda: the wrapper checks run on the card too, and a
    # missing card is a finding
    require_cuda = False

    _SOLVER_SOURCES = (
        "src/repro_torch/core/blocked_fw.py",
        "src/repro_torch/core/dynamic.py",
        "src/repro_torch/core/rkleene.py",
    )

    def run(self, project: Project) -> Iterator[Finding]:
        defaults, classes = _donating_defaults(project), _classes(project)
        for rel in project.files():
            for line, name, at in read_after_donation(project, rel, defaults, classes):
                yield self.finding(
                    project, rel, line,
                    f"`{name}` is read after it was donated at line {at} — the call may "
                    "have overwritten it with its result; rebind it first")
        missing = [s for s in self._SOLVER_SOURCES if not project.has(s)]
        if missing:
            print(f"analyze: [donation] tier B skipped — {project.root} has no {missing[0]} "
                  "(not the port's tree)", file=sys.stderr)
            return
        yield from run_donation_checks()
        counts = {"cpu": len(_wrapper_checks("cpu"))}
        if self.require_cuda:
            import torch

            if not torch.cuda.is_available():
                yield Finding(check=_CHECK, path="src/repro_torch/core/apsp.py", line=0,
                              message="--require-cuda: no CUDA device, so the wrapper "
                                      "donation checks did not run on the card")
            else:
                yield from _wrapper_consumption_findings("cuda")
                counts["cuda"] = len(_wrapper_checks("cuda"))
        print(f"analyze: [donation] {json.dumps({'wrapper_checks': counts}, sort_keys=True)}",
              file=sys.stderr)


register_checker(DonationChecker())
