"""Run the port's invariant checkers (``repro_torch.analysis``) over its tree.

Usage (from the repo root):

    PYTHONPATH=src python -m repro_torch.analysis              # all checks
    PYTHONPATH=src python -m repro_torch.analysis --json       # machine-readable
    PYTHONPATH=src python -m repro_torch.analysis --checks unfused-dispatch,donation
    PYTHONPATH=src python -m repro_torch.analysis --only kernel-grid
    PYTHONPATH=src python -m repro_torch.analysis --list       # registered checks
    PYTHONPATH=src python -m repro_torch.analysis --root <tree>
    PYTHONPATH=src python -m repro_torch.analysis --only kernel-grid --require-cuda

The flags, output and exit codes are ``tools/analyze.py``'s: ``--only``
(repeatable) unions with ``--checks``; ``--only unfused-dispatch`` is the
port's ``tools/lint_dispatch.py``.  ``--require-cuda`` makes a missing CUDA
device a finding of ``kernel-grid`` (whose card half is otherwise skipped).

Exit status: 0 = clean (advisory-only findings included), 1 = gating
findings, 2 = usage error.  ``--json`` emits ``{"schema": 1, "checks":
[...], "findings": [...]}``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import CHECKERS, Project, run_checks

REPO = Path(__file__).resolve().parents[3]
SCHEMA = 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--checks", default=None,
                    help="comma-separated check names (default: all registered)")
    ap.add_argument("--only", action="append", default=None, metavar="CHECK",
                    help="run a single check (repeatable; unions with --checks)")
    ap.add_argument("--root", default=str(REPO),
                    help="project root to analyze (default: this repo)")
    ap.add_argument("--list", action="store_true", help="list registered checks and exit")
    ap.add_argument("--require-cuda", action="store_true",
                    help="kernel-grid: a missing CUDA device is a finding")
    args = ap.parse_args(argv)

    if args.list:
        for name in sorted(CHECKERS):
            print(f"{name:20s} {CHECKERS[name].description}")
        return 0

    names = ([c.strip() for c in args.checks.split(",") if c.strip()]
             if args.checks else None)
    if args.only:
        only = [c.strip() for c in args.only if c.strip()]
        names = (names or []) + [c for c in only if c not in (names or [])]
    CHECKERS["kernel-grid"].require_cuda = args.require_cuda
    project = Project(args.root)
    try:
        findings = run_checks(project, names)
    except ValueError as e:
        print(f"analyze: {e}", file=sys.stderr)
        return 2

    selected = names if names is not None else sorted(CHECKERS)
    gating = [f for f in findings if not f.advisory]
    advisory = [f for f in findings if f.advisory]
    if args.json:
        print(json.dumps({"schema": SCHEMA, "checks": selected,
                          "findings": [f.to_json() for f in findings]},
                         indent=1, sort_keys=True))
    else:
        for f in findings:
            print(f.format())
        tick = "clean" if not findings else ", ".join(
            s for s, n in ((f"{len(gating)} finding{'s' if len(gating) != 1 else ''}",
                            len(gating)), (f"{len(advisory)} advisory", len(advisory))) if n)
        print(f"analyze: {len(selected)} check(s) over {len(project.files())} file(s): {tick}")
    return 1 if gating else 0


if __name__ == "__main__":
    raise SystemExit(main())
