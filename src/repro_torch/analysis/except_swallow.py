"""``except-swallow`` — the serving tier must not eat failures silently.

The port's counterpart of ``repro.analysis.except_swallow``, with the same
rule and evidence.  The resilience contract of ``repro_torch.launch`` is
that every failure is *handled*, not hidden: an ``except`` in the serving
tier must either re-raise, transition slot state (degrade / quarantine /
recover / evict), or record the failure (stats counter, traceback capture,
checkpoint).  A bare ``except: pass`` in the pool turns an injected crash
into a silently wrong answer.

Scope: every ``except`` handler in ``src/repro_torch/launch/*`` plus the
dynamic engine's rollback and retry handlers (``core/dynamic.py``).
Accepted evidence inside the handler body (transitively, nested
statements included):

* a ``raise`` (re-raise or translation to a typed error);
* a call to a lifecycle/recovery method — ``_transition`` / ``transition``
  / ``recover`` / ``_recover`` / ``readmit`` / ``quarantine`` / ``degrade``
  / ``evict`` — or to a recording sink: any ``record*`` / ``_record*``
  name, ``format_exc`` (traceback capture), ``save`` (checkpoint before
  surrender);
* a store into a ``stats`` counter mapping (``self.stats["x"] += 1``) or
  a call to the locked counter sink (``self.stats.inc("x")`` /
  ``inj.counts.inc(kind)``);
* routing the failed work to a deferral queue — ``.append``/``.extend``
  on a receiver whose name contains ``defer`` or a ``return`` whose value
  carries the literal ``"defer"`` status.

This check is **advisory** (tier A, AST): it reports but never fails
the run — handler intent is heuristic, and a false
positive must not block a merge.  Deliberate swallows carry
``# repro: allow-except-swallow  <why>`` on the ``except`` line.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .base import Checker, Finding, Project, register_checker

__all__ = ["ExceptSwallowChecker", "RECOGNIZED_CALLS"]

#: handler calls that count as handling the failure (lifecycle transitions,
#: recovery entry points, recording sinks)
RECOGNIZED_CALLS = {
    "_transition", "transition", "recover", "_recover", "readmit",
    "quarantine", "degrade", "evict", "format_exc", "save",
}


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _is_stats_store(node: ast.AST) -> bool:
    """``self.stats["x"] += 1`` / ``slot.stats["x"] = ...`` — a counted
    failure is a handled failure."""
    if not isinstance(node, (ast.Assign, ast.AugAssign)):
        return False
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        if isinstance(t, ast.Subscript):
            v = t.value
            name = v.attr if isinstance(v, ast.Attribute) else (
                v.id if isinstance(v, ast.Name) else "")
            if name == "stats":
                return True
    return False


def _is_counter_inc(node: ast.Call) -> bool:
    """``self.stats.inc("x")`` / ``inj.counts.inc(kind)`` — the locked
    ``launch.stats.Counters`` sink.  A counted failure is a handled failure."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "inc"):
        return False
    v = f.value
    name = v.attr if isinstance(v, ast.Attribute) else (
        v.id if isinstance(v, ast.Name) else "")
    return name in ("stats", "counts")


def _is_defer_routing(node: ast.AST) -> bool:
    """``deferred.extend(...)`` / ``defer_queue.append(...)`` or a
    ``return`` carrying the literal ``"defer"`` status — the failed work
    re-enters the retry machinery instead of vanishing."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("append", "extend"):
            v = f.value
            name = v.attr if isinstance(v, ast.Attribute) else (
                v.id if isinstance(v, ast.Name) else "")
            if "defer" in name.lower():
                return True
    if isinstance(node, ast.Return) and node.value is not None:
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Constant) and sub.value == "defer":
                return True
    return False


def _handler_handles(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = _call_name(node)
            if name in RECOGNIZED_CALLS or name.startswith(("record", "_record")):
                return True
            if _is_counter_inc(node):
                return True
        if _is_stats_store(node):
            return True
        if _is_defer_routing(node):
            return True
    return False


class ExceptSwallowChecker(Checker):
    name = "except-swallow"
    description = (
        "advisory: every except handler in launch/ and core/dynamic.py "
        "must re-raise, transition slot state, route to a deferral queue, "
        "or record the failure (stats counter / traceback / checkpoint) — "
        "no silent swallows on the failure paths"
    )
    advisory = True

    def _in_scope(self, rel: str) -> bool:
        if rel.endswith("core/dynamic.py"):
            return True
        parts = rel.split("/")
        return len(parts) >= 2 and parts[-2] == "launch" \
            and parts[-1] != "__init__.py"

    def run(self, project: Project) -> Iterator[Finding]:
        for rel in project.files():
            if not self._in_scope(rel):
                continue
            tree = project.tree(rel)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if _handler_handles(node):
                    continue
                caught = ast.unparse(node.type) if node.type else "BaseException"
                yield self.finding(
                    project, rel, node.lineno,
                    f"except {caught}: handler neither re-raises, "
                    "transitions slot state, routes to a deferral queue, "
                    "nor records the failure — a swallowed fault on this "
                    "path becomes a silent wrong answer",
                )


register_checker(ExceptSwallowChecker())
