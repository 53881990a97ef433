"""``autotune-key`` — dispatch-affecting parameters must reach the cache key.

The port's counterpart of ``repro.analysis.autotune_key``, over the port's
``kernels/autotune.py`` (the same three lookup / key pairs).  The
autotuner's contract is that a persisted winner is only reused for
dispatches that are *equivalent* under the cache key
(``kernels/autotune.py::key_for`` / ``key_for_fw_round``).  That contract
breaks in two silent ways, both of which this checker catches by signature
diffing instead of runtime sampling:

1. **Key-blind lookup parameter** — ``lookup`` grows a dispatch-affecting
   parameter (say ``accumulate``) that ``key_for`` never folds into the key
   string: two different dispatches now collide on one cache entry and the
   loser runs with the winner's tiles.  Rule: every parameter of
   ``lookup`` must appear in ``key_for``'s signature (same for the
   ``_fw_round`` pair).

2. **Defaulted call site** — a dispatch site calls ``lookup(...)`` leaving a
   key parameter to its default (``semiring="tropical"``, ``g=0``).  The
   moment that site starts varying the omitted axis, all its dispatches
   collapse onto the default's cache entry.  Rule: every ``lookup`` /
   ``lookup_fw_round`` call site in ``src/repro_torch`` binds *every* signature
   parameter explicitly (positionally or by keyword).

Call sites are resolved through the import tables (``autotune.lookup`` via
a module alias, or ``from ..kernels.autotune import lookup``), so the
checker follows renames and skips unrelated functions that happen to be
called ``lookup``.  Sites using ``*args``/``**kwargs`` forwarding are
unverifiable statically and are skipped, not flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional

from .astutil import ModuleInfo
from .base import Checker, Finding, Project, register_checker

__all__ = ["AutotuneKeyChecker"]

_PAIRS = (
    ("lookup", "key_for"),
    ("lookup_fw_round", "key_for_fw_round"),
    ("lookup_row_close", "key_for_row_close"),
)


def _autotune_rel(project: Project) -> Optional[str]:
    for rel in project.files():
        if rel.endswith("kernels/autotune.py"):
            return rel
    return None


class AutotuneKeyChecker(Checker):
    name = "autotune-key"
    description = (
        "every lookup() parameter must be a key_for() key field, and every "
        "dispatch call site must bind all key parameters explicitly "
        "(defaults silently collapse distinct dispatches onto one entry)"
    )

    def run(self, project: Project) -> Iterator[Finding]:
        at_rel = _autotune_rel(project)
        if at_rel is None:
            return
        at_info = ModuleInfo.build(project, at_rel)
        if at_info is None:
            return

        sigs: Dict[str, List[str]] = {}
        for lookup_name, key_name in _PAIRS:
            lk = at_info.functions.get(lookup_name)
            kf = at_info.functions.get(key_name)
            if lk is None or kf is None:
                continue
            lk_params = at_info.func_params(lk)
            kf_params = set(at_info.func_params(kf))
            sigs[lookup_name] = lk_params
            blind = [p for p in lk_params if p not in kf_params]
            if blind:
                yield self.finding(
                    project, at_rel, lk.lineno,
                    f"{lookup_name}() parameter(s) {blind} never reach "
                    f"{key_name}() — dispatches differing only there "
                    "collide on one cache entry; fold them into the key",
                )

        if not sigs:
            return
        for rel in project.files():
            if rel == at_rel:
                continue
            info = ModuleInfo.build(project, rel)
            if info is None:
                continue
            yield from self._check_sites(project, info, at_rel, sigs)

    def _check_sites(
        self, project: Project, info: ModuleInfo, at_rel: str,
        sigs: Dict[str, List[str]],
    ) -> Iterator[Finding]:
        for node in ast.walk(info.tree):
            if not isinstance(node, ast.Call):
                continue
            target = self._resolve(info, node, at_rel)
            if target is None or target not in sigs:
                continue
            params = sigs[target]
            if any(isinstance(a, ast.Starred) for a in node.args) or any(
                kw.arg is None for kw in node.keywords
            ):
                continue  # *args/**kwargs forwarding: not statically checkable
            bound = set(params[: len(node.args)])
            bound.update(kw.arg for kw in node.keywords)
            missing = [p for p in params if p not in bound]
            if missing:
                yield self.finding(
                    project, info.rel, node.lineno,
                    f"autotune.{target}() call leaves key parameter(s) "
                    f"{missing} at their defaults — pass every key axis "
                    "explicitly so distinct dispatches key separately",
                )

    @staticmethod
    def _resolve(
        info: ModuleInfo, node: ast.Call, at_rel: str
    ) -> Optional[str]:
        """Name of the autotune lookup this call targets, if any."""
        if isinstance(node.func, ast.Attribute) and isinstance(
            node.func.value, ast.Name
        ):
            mod = info.module_aliases.get(node.func.value.id)
            if mod == at_rel:
                return node.func.attr
        elif isinstance(node.func, ast.Name):
            imp = info.name_imports.get(node.func.id)
            if imp and imp[0] == at_rel:
                return imp[1]
        return None


register_checker(AutotuneKeyChecker())
