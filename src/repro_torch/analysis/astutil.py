"""Shared AST plumbing for the port's source checkers (a copy of
``repro.analysis.astutil``, which the port does not import).

Small, dependency-free helpers: dotted-name rendering of attribute chains,
per-module import tables (so ``kops.minplus`` resolves to
``kernels/ops.py::minplus``), a function-definition index, and literal
resolution for module-level constants.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "dotted",
    "walk_calls",
    "walk_source_order",
    "ModuleInfo",
    "module_rel_for",
    "literal_str_tuple",
]


def dotted(node: ast.AST) -> Optional[str]:
    """Render ``a.b.c`` attribute/name chains; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def walk_source_order(node: ast.AST) -> Iterator[ast.AST]:
    """Pre-order DFS over ``node``'s descendants, in source order.

    ``ast.walk`` is breadth-first: a statement nested inside an ``if``/loop
    body is visited *after* every later top-level sibling, which breaks any
    pass whose state must evolve in program order (e.g. taint propagation
    through assignments).  Child fields of every statement/expression node
    are declared in source order, so a depth-first pre-order walk yields
    nodes as they appear in the file.
    """
    for child in ast.iter_child_nodes(node):
        yield child
        yield from walk_source_order(child)


def module_rel_for(rel: str, module: str, level: int) -> Optional[str]:
    """Map an import statement in file ``rel`` to a project-relative path.

    ``module``/``level`` are straight off ``ast.ImportFrom`` (level = number
    of leading dots).  Returns ``src/<pkg path>.py`` (the importing file's
    tree decides the prefix) or None for out-of-project imports.  The
    resolved path is a *candidate* — callers check ``project.has`` (a
    package import resolves to ``<pkg>/__init__.py``).
    """
    parts = rel.split("/")
    if parts[-1].endswith(".py"):
        parts = parts[:-1]                     # containing package dir
    if level:
        if level > len(parts):
            return None
        parts = parts[: len(parts) - (level - 1)]
        base = parts
        mod_parts = module.split(".") if module else []
    else:
        # absolute: must target the analyzed package rooted at src/
        if not module:
            return None
        mod_parts = module.split(".")
        if "src" not in parts:
            return None
        base = parts[: parts.index("src") + 1]
    return "/".join(base + mod_parts) + ".py"


def literal_str_tuple(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """("a", "b") / ["a"] / "a" literals -> tuple of strings, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.append(elt.value)
            else:
                return None
        return tuple(out)
    return None


@dataclass
class ModuleInfo:
    """Parsed module + its import tables and function index.

    * ``module_aliases``  — local name -> project-relative module path
      (``import x.y as z`` / ``from pkg import mod [as z]`` /
      ``from . import mod``).
    * ``name_imports``    — local name -> (module path, original name)
      (``from .mod import fn [as z]``).
    * ``functions``       — function name -> (FunctionDef, enclosing chain);
      nested defs are indexed as ``outer.inner``.
    * ``constants``       — module-level Name -> string-tuple literal (for
      ``static_argnames=_STATIC`` resolution).
    """

    rel: str
    tree: ast.AST
    module_aliases: Dict[str, str] = field(default_factory=dict)
    name_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    functions: Dict[str, ast.AST] = field(default_factory=dict)
    constants: Dict[str, Tuple[str, ...]] = field(default_factory=dict)

    @classmethod
    def build(cls, project, rel: str) -> Optional["ModuleInfo"]:
        tree = project.tree(rel)
        if tree is None:
            return None
        info = cls(rel=rel, tree=tree)
        info._index(project)
        return info

    def _index(self, project) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    cand = module_rel_for(self.rel, alias.name, 0)
                    if cand and project.has(cand):
                        self.module_aliases[alias.asname or alias.name] = cand
            elif isinstance(node, ast.ImportFrom):
                base = module_rel_for(self.rel, node.module or "", node.level)
                if base is None:
                    continue
                for alias in node.names:
                    local = alias.asname or alias.name
                    # "from pkg import mod" — imported name may itself be a
                    # module of the project
                    as_mod = base[:-3] + "/" + alias.name + ".py"
                    if project.has(as_mod):
                        self.module_aliases[local] = as_mod
                    elif project.has(base):
                        self.name_imports[local] = (base, alias.name)

        def index_funcs(body, prefix=""):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = prefix + node.name
                    self.functions.setdefault(qual, node)
                    # nested defs (loop bodies etc.) index under a dotted name
                    index_funcs(node.body, qual + ".")
                elif isinstance(node, (ast.ClassDef,)):
                    index_funcs(node.body, prefix + node.name + ".")

        index_funcs(self.tree.body)

        for node in self.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    lit = literal_str_tuple(node.value)
                    if lit is not None:
                        self.constants[tgt.id] = lit

    def func_params(self, fn: ast.AST) -> List[str]:
        a = fn.args
        return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
