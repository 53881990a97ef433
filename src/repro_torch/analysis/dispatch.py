"""``unfused-dispatch`` — the solvers' products go through ``kernels.ops``.

The port's counterpart of ``repro.analysis.dispatch``, with the same rules
spelled for PyTorch:

* solver modules never call the unfused semiring product — bare
  ``minplus(...)`` / ``minplus_pred(...)`` (the ``kops.`` / ``ops.``
  attribute forms are the fused dispatch and pass; ``minplus_3d`` is a
  different name, deliberately unflagged);
* no importing those unfused primitives from ``core.semiring``;
* no separate elementwise ``torch.minimum`` / ``torch.maximum`` accumulate
  sweep after a product — accumulation is fused into the kernel;
* no full-matrix copies in solver bodies — ``.clone()``, ``torch.clone``,
  ``torch.tensor(...)``, numpy ``.copy()`` — state moves by ``donate=``
  (the caller's tensor is updated in place), not duplication.

Scope: ``src/repro_torch/core/*`` minus ``semiring.py`` (hosts the plain
primitives), ``graphgen.py`` (a generator, not a solver), ``convert.py``
(moves tensors between the packages) and ``__init__.py``.

Pragmas: the legacy spellings ``# lint: allow-unfused`` (elementwise uses
that are no accumulate) and ``# lint: allow-copy`` (copies outside the
round bodies), and the framework's ``# repro: allow-unfused-dispatch``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .astutil import dotted
from .base import Checker, Finding, Project, register_checker

__all__ = ["UnfusedDispatchChecker", "SOLVER_EXEMPT"]

SOLVER_EXEMPT = {"__init__.py", "semiring.py", "graphgen.py", "convert.py"}

_LEGACY_UNFUSED = "lint: allow-unfused"
_LEGACY_COPY = "lint: allow-copy"
_SWEEPS = ("torch.minimum", "torch.maximum")
_COPIES = ("torch.clone", "torch.tensor")


class UnfusedDispatchChecker(Checker):
    name = "unfused-dispatch"
    description = (
        "solver products must route through the fused kernels.ops dispatch; "
        "no unfused semiring.minplus, no separate torch.minimum/maximum "
        "accumulate sweeps, no full-matrix copies in solver bodies (donate= "
        "moves state)"
    )

    def _in_scope(self, rel: str) -> bool:
        parts = rel.split("/")
        return len(parts) >= 2 and parts[-2] == "core" and parts[-1] not in SOLVER_EXEMPT

    def run(self, project: Project) -> Iterator[Finding]:
        for rel in project.files():
            if not self._in_scope(rel):
                continue
            tree = project.tree(rel)
            if tree is None:
                yield self.finding(project, rel, 0, "file does not parse")
                continue
            yield from self._check_module(project, rel, tree)

    def _check_module(self, project: Project, rel: str, tree) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if (node.module or "").split(".")[-1] == "semiring":
                    bad = [a.name for a in node.names if a.name in ("minplus", "minplus_pred")]
                    if bad and not self._legacy(project, rel, node.lineno, _LEGACY_UNFUSED):
                        yield self.finding(
                            project, rel, node.lineno,
                            f"importing the unfused semiring product {bad} into a solver "
                            "(route through repro_torch.kernels.ops)")
                continue
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            line = node.lineno
            if name in _SWEEPS:
                if not self._legacy(project, rel, line, _LEGACY_UNFUSED):
                    yield self.finding(
                        project, rel, line,
                        f"separate elementwise {name} accumulate (use the fused "
                        "kernels.ops dispatch)")
            elif isinstance(node.func, ast.Name) and node.func.id in ("minplus", "minplus_pred"):
                if not self._legacy(project, rel, line, _LEGACY_UNFUSED):
                    yield self.finding(
                        project, rel, line,
                        f"unfused semiring.{node.func.id} (route through "
                        "repro_torch.kernels.ops)")
            elif name in _COPIES or (
                isinstance(node.func, ast.Attribute)
                and (node.func.attr == "clone"
                     or (node.func.attr == "copy" and not node.args and not node.keywords))
            ):
                if not self._legacy(project, rel, line, _LEGACY_COPY):
                    yield self.finding(
                        project, rel, line,
                        "full-matrix copy in a solver (move state with donate= instead; "
                        "see blocked_fw / rkleene)")

    @staticmethod
    def _legacy(project: Project, rel: str, line: int, pragma: str) -> bool:
        return pragma in project.line(rel, line)


register_checker(UnfusedDispatchChecker())
