"""Suppression pragmas of the port's checkers, spelled and scoped as in
``repro.analysis.pragmas``, so that one syntax serves both packages.

Two scopes, one syntax:

* **Per-line** — append ``# repro: allow-<check>  <one-line justification>``
  to the flagged line.  Multiple checks on one line are fine (separate
  ``repro:`` comments or comma-joined: ``# repro: allow-a,allow-b reason``).
* **Per-file** — a *standalone* comment line anywhere in the file reading
  ``# repro: allow-<check>  <justification>`` suppresses that check for the
  whole file (used for modules that are deliberately outside a convention,
  e.g. a documented tropical-only feature path).  The line must *begin*
  with the pragma — a commented-out line of code that happened to carry a
  per-line pragma, or a comment merely mentioning the syntax, is not a
  file-scope suppression.

Robustness: lines are cleaned of a UTF-8 BOM (``\\ufeff`` — editors that
re-save with a BOM would otherwise silently disarm a first-line file-scope
pragma) and of a trailing ``\\r`` (CRLF checkouts / callers that split on
``"\\n"``) before matching.

Decorator attribution (:func:`line_allows_at`): checkers anchor a finding
sometimes to the ``def``/``class`` line and sometimes to a decorator line
of the same object (e.g. a flagged ``@jit`` configuration).  A pragma
anywhere on the contiguous decorator stack covers a finding on its
``def``/``class`` line, and a pragma on the ``def``/``class`` line covers
a finding anchored to one of its decorators — the pragma suppresses the
*object*, not a specific physical line of its header.

The ``unfused-dispatch`` checker also takes the legacy spelling
(``# lint: allow-unfused`` / ``# lint: allow-copy``); those pragmas are
per-line only and are honored by that checker itself, not here.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence, Set

__all__ = ["line_allows", "line_allows_at", "file_allows", "pragmas_on_line"]

# "# repro: allow-foo,allow-bar some justification text"
_PRAGMA_RE = re.compile(r"#\s*repro:\s*([^#]*)")
_ALLOW_RE = re.compile(r"allow-([A-Za-z0-9_-]+)")
# file scope demands the whole line BE the pragma, not merely contain one
_FILE_PRAGMA_RE = re.compile(r"^#\s*repro:\s*allow-")


def _clean(line: str) -> str:
    """Strip a UTF-8 BOM and a trailing CR so pragma matching sees the
    logical line regardless of encoding signature or line-ending style."""
    return line.lstrip("\ufeff").rstrip("\r")


def pragmas_on_line(line: str) -> Set[str]:
    """Check names allowed by ``repro:`` pragmas on this source line."""
    out: Set[str] = set()
    for m in _PRAGMA_RE.finditer(_clean(line)):
        out.update(_ALLOW_RE.findall(m.group(1)))
    return out


def line_allows(line: str, check: str) -> bool:
    return check in pragmas_on_line(line)


def _is_decorator(line: str) -> bool:
    return _clean(line).lstrip().startswith("@")


def _is_def(line: str) -> bool:
    return _clean(line).lstrip().startswith(("def ", "class ", "async def "))


def line_allows_at(lines: Sequence[str], lineno: int, check: str) -> bool:
    """Per-line suppression at 1-based ``lineno``, decorator-aware.

    True when the flagged line itself carries the pragma, or — for a
    finding on a ``def``/``class`` line — when any line of the contiguous
    decorator stack directly above does, or — for a finding on a decorator
    line — when a later decorator of the same stack or the decorated
    ``def``/``class`` line does.
    """
    if not 1 <= lineno <= len(lines):
        return False
    i = lineno - 1
    cur = lines[i]
    if line_allows(cur, check):
        return True
    if _is_def(cur):
        j = i - 1
        while j >= 0 and _is_decorator(lines[j]):
            if line_allows(lines[j], check):
                return True
            j -= 1
    elif _is_decorator(cur):
        j = i + 1
        while j < len(lines) and _is_decorator(lines[j]):
            if line_allows(lines[j], check):
                return True
            j += 1
        if j < len(lines) and _is_def(lines[j]) and line_allows(lines[j], check):
            return True
    return False


def file_allows(lines: Iterable[str], check: str) -> bool:
    """True when a standalone comment line *starting with* the pragma names
    ``check`` (file scope).  Commented-out code that carried a per-line
    pragma, or prose mentioning the syntax, does not count."""
    for line in lines:
        stripped = _clean(line).strip()
        if _FILE_PRAGMA_RE.match(stripped) and check in pragmas_on_line(stripped):
            return True
    return False
