"""``semiring-hardcode`` — semiring-generic modules must not bake in ⊕⊗.

The port's counterpart of ``repro.analysis.semiring_hardcode``.  Every
solver and kernel wrapper of the port takes the closed semiring as a
parameter (``sr.add`` / ``sr.mul`` / ``sr.reduce`` / ``sr.argreduce`` /
``sr.better``).  A literal ``torch.minimum`` (or ``torch.add`` as ⊗, or a
min/argmin reduction) in one of those modules re-hardcodes the tropical
instance: every other semiring (bottleneck, reliability, boolean, a
registered one) then computes garbage on that path.

Scope: ``src/repro_torch/core/*`` + ``src/repro_torch/kernels/*`` minus
``core/semiring.py``, the one module allowed to spell the instances out.

Flagged ops (call positions only): the elementwise ⊕⊗ candidates
``torch.minimum / maximum / add / mul / multiply``, the ⊕-reductions
``torch.min / max / amin / amax / sum`` and the witness reductions
``torch.argmin / argmax``.  Deliberate exceptions (index clamps,
tropical-only feature paths) carry ``# repro: allow-semiring-hardcode
<why>``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .astutil import dotted
from .base import Checker, Finding, Project, register_checker

__all__ = ["SemiringHardcodeChecker", "HARDCODED_OPS"]

HARDCODED_OPS = {
    "torch.minimum": "elementwise ⊕/⊗ candidate",
    "torch.maximum": "elementwise ⊕/⊗ candidate",
    "torch.add": "elementwise ⊗ candidate",
    "torch.mul": "elementwise ⊗ candidate",
    "torch.multiply": "elementwise ⊗ candidate",
    "torch.min": "⊕-reduction",
    "torch.max": "⊕-reduction",
    "torch.amin": "⊕-reduction",
    "torch.amax": "⊕-reduction",
    "torch.sum": "⊕-reduction (+-fold)",
    "torch.argmin": "witness reduction",
    "torch.argmax": "witness reduction",
}

_EXEMPT = {"core/semiring.py"}


class SemiringHardcodeChecker(Checker):
    name = "semiring-hardcode"
    description = (
        "no literal tropical ops (torch.minimum/add/min/argmin...) in "
        "semiring-parametrized modules — use the Semiring instance's "
        "add/mul/reduce/argreduce or the kernels.ops dispatch"
    )

    def _in_scope(self, rel: str) -> bool:
        parts = rel.split("/")
        if len(parts) < 2 or parts[-1] == "__init__.py":
            return False
        if "/".join(parts[-2:]) in _EXEMPT:
            return False
        return parts[-2] in ("core", "kernels")

    def run(self, project: Project) -> Iterator[Finding]:
        for rel in project.files():
            if not self._in_scope(rel):
                continue
            tree = project.tree(rel)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                if name in HARDCODED_OPS:
                    yield self.finding(
                        project, rel, node.lineno,
                        f"hardcoded {HARDCODED_OPS[name]} {name} in a semiring-parametrized "
                        "module (use semiring.add/mul/reduce/argreduce or kernels.ops; "
                        "tropical literals only belong in core/semiring.py)")


register_checker(SemiringHardcodeChecker())
