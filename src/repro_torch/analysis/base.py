"""Checker framework core: findings, the checker protocol, the registry.

The port's conventions (fused dispatch, semiring genericity, no host sync
on the per-round path, autotune-key completeness, donation integrity,
failure routing in the serving tier, the kernels' launch plans) are
machine-checked here, with the same protocol as ``repro.analysis``: a
checker is a named object with a ``run(project)`` method yielding
:class:`Finding`s, the registry maps check names to instances, and
``python -m repro_torch.analysis`` runs them.

Two tiers share the protocol:

* **Tier A (AST)** — checkers parse the source tree (``Project`` caches
  sources and ASTs) and flag convention violations at file:line.
* **Tier B (runtime)** — the donation check's aliasing half and the kernel
  grid verifier import the port and run it on small concrete inputs.  They
  only run when the analyzed tree holds the port's sources (a fixture tree
  is not importable and is skipped with a notice on stderr).

Suppression: a finding is dropped when its source line carries
``# repro: allow-<check>`` (per-line) or the file holds a standalone
comment line with the same pragma (per-file); see ``analysis.pragmas``.
``unfused-dispatch`` also honors the legacy ``# lint: allow-unfused`` /
``# lint: allow-copy`` itself.
"""

from __future__ import annotations

import ast
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from . import pragmas

__all__ = [
    "Finding",
    "Checker",
    "Project",
    "CHECKERS",
    "register_checker",
    "run_checks",
]


@dataclass(frozen=True)
class Finding:
    """One convention violation.  ``line == 0`` marks a module-level
    finding (one found by running code, not by parsing it)."""

    check: str
    path: str                 # project-relative posix path
    line: int                 # 1-based; 0 = whole-module finding
    message: str
    snippet: str = ""
    advisory: bool = False    # advisory findings report but never gate

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tag = f"{self.check}:advisory" if self.advisory else self.check
        out = f"{loc}: [{tag}] {self.message}"
        if self.snippet:
            out += f"\n    {self.snippet}"
        return out

    def to_json(self) -> dict:
        return asdict(self)


class Project:
    """A source tree under analysis: root + file list + parse caches.

    The default file set is every ``.py`` under ``src/repro_torch``; tests
    build Projects over small trees with the same relative layout.
    """

    def __init__(self, root, rel_files: Optional[Sequence[str]] = None):
        self.root = Path(root)
        self._rel_files = list(rel_files) if rel_files is not None else None
        self._source: Dict[str, str] = {}
        self._lines: Dict[str, List[str]] = {}
        self._tree: Dict[str, Optional[ast.AST]] = {}

    def files(self) -> List[str]:
        if self._rel_files is None:
            base = self.root / "src" / "repro_torch"
            self._rel_files = sorted(
                p.relative_to(self.root).as_posix() for p in base.rglob("*.py")
            )
        return self._rel_files

    def has(self, rel: str) -> bool:
        return (self.root / rel).is_file()

    def source(self, rel: str) -> str:
        if rel not in self._source:
            self._source[rel] = (self.root / rel).read_text()
        return self._source[rel]

    def lines(self, rel: str) -> List[str]:
        if rel not in self._lines:
            self._lines[rel] = self.source(rel).splitlines()
        return self._lines[rel]

    def line(self, rel: str, lineno: int) -> str:
        lines = self.lines(rel)
        return lines[lineno - 1] if 1 <= lineno <= len(lines) else ""

    def tree(self, rel: str) -> Optional[ast.AST]:
        """Parsed AST, or None on a syntax error."""
        if rel not in self._tree:
            try:
                self._tree[rel] = ast.parse(self.source(rel), filename=rel)
            except SyntaxError:
                self._tree[rel] = None
        return self._tree[rel]


class Checker:
    """Base class for a registered check.  Subclasses set ``name`` (the
    pragma suffix: ``# repro: allow-<name>``) and ``description`` and
    implement :meth:`run`.  ``advisory = True`` marks a check whose
    findings are reported but never fail the run (exit 0)."""

    name: str = ""
    description: str = ""
    advisory: bool = False

    def run(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, project: Project, rel: str, line: int, message: str) -> Finding:
        return Finding(
            check=self.name, path=rel, line=line, message=message,
            snippet=project.line(rel, line).strip() if line else "",
            advisory=self.advisory,
        )


CHECKERS: Dict[str, Checker] = {}


def register_checker(checker: Checker) -> Checker:
    """Add a checker instance to the registry (a name collision replaces)."""
    if not checker.name:
        raise ValueError("checker must have a name")
    CHECKERS[checker.name] = checker
    return checker


def _suppressed(project: Project, f: Finding) -> bool:
    if not f.path or not project.has(f.path):
        return False
    if pragmas.file_allows(project.lines(f.path), f.check):
        return True
    if f.line:
        return pragmas.line_allows_at(project.lines(f.path), f.line, f.check)
    return False


def run_checks(project: Project, names: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the named checks (default: all registered) over ``project`` and
    return the pragma-filtered findings sorted by location."""
    selected = list(names) if names is not None else sorted(CHECKERS)
    unknown = [n for n in selected if n not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown check(s) {unknown}; registered: {sorted(CHECKERS)}")
    findings: List[Finding] = []
    for name in selected:
        for f in CHECKERS[name].run(project):
            if not _suppressed(project, f):
                findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.check))
