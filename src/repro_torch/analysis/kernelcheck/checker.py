"""The registered ``kernel-grid`` checker (tier B, gating).

The counterpart of ``repro.analysis.kernelcheck.checker``.  It proves every
lattice case (``lattice.lattice``: ``default_cases`` and ``autotune_cases``,
each name once) through the plan verifier on the CPU, and proves the
verifier itself: every plan mutant must be flagged with its expected kind
and the control must verify clean.  Its **static tier** (``static = True``,
which the tree test sets) checks only the static theorems of every
case's captured plan and runs no interpreter and no card: the tests prove
each case through the interpreter one by one
(``tests/test_torch_kernelcheck.py``), so the tree check need not run them
again.
With a CUDA device it also runs the lattice through the CUDA kernels (each
output seeded with a canary; each result bit-equal to the plain version)
and the seeded-defect kernels of ``csrc/mutants.cu``.  Without one, that
half prints "skipped: no CUDA device" on stderr, as the JAX package's tier
B reports fixture trees; with ``require_cuda`` set (``--require-cuda`` on
the command line) a missing card is a finding.

It prints one summary line on stderr, ``analyze: [kernel-grid] {json}``:
the cases run a kernel of the table on the CPU and on the card, the
launches the card's cases made (the wrappers' counters) and the canary hits
a kernel, and each mutant's expected and found kinds.

Like the donation check, it imports and runs the port, so it only runs
when the analyzed tree holds the kernel sources.  A deliberate exception
carries a file-scope ``# repro: allow-kernel-grid  <why>`` pragma in the
flagged kernel module.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterator

from ..base import Checker, Finding, Project, register_checker

__all__ = ["KernelGridChecker"]

_CHECK = "kernel-grid"


def _path(module: str) -> str:
    return f"src/repro_torch/kernels/{module}.py"


def _launch_counts() -> Dict[str, int]:
    """The wrappers' launch counters, by the kernel table's six rows."""
    import importlib

    from .lattice import GROUPS

    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("fw_round", "minplus", "fw_block", "row_close")}
    out: Dict[str, int] = {"fw_round": mods["fw_round"].rounds}
    for m in ("minplus", "fw_block", "row_close"):
        for name, n in mods[m].launches.items():
            out[GROUPS[name]] = out.get(GROUPS[name], 0) + n
    return out


class KernelGridChecker(Checker):
    name = _CHECK
    description = (
        "launch-plan grid verifier of the six CUDA kernels: every plan is "
        "race free, covers its output, stays in bounds (grid, shared bytes, "
        "pitches, gather ids) and, run on the CPU, matches the oracle and "
        "the plain version over the shape lattice; the seeded mutants are "
        "caught; on a card the kernels themselves run the lattice"
    )
    require_cuda = False
    static = False
    # The names of the cases the last run proved, in order.
    last_cases: tuple = ()

    _KERNEL_SOURCES = tuple(_path(m) for m in ("minplus", "fw_block", "fw_round",
                                                 "row_close"))

    def run(self, project: Project) -> Iterator[Finding]:
        missing = [s for s in self._KERNEL_SOURCES if not project.has(s)]
        if missing:
            print(f"analyze: [{self.name}] tier B skipped — {project.root} has no "
                  f"{missing[0]} (not the port's tree)", file=sys.stderr)
            return
        import torch

        from .lattice import GROUPS, lattice
        from .mutants import control_case, kernel_mutants, mutant_cases, verify_kernel_mutant
        from .verify import check_static, verify_case, verify_case_cuda

        def finding(module: str, message: str) -> Finding:
            return Finding(check=self.name, path=_path(module), line=0, message=message)

        cases = lattice()
        self.last_cases = tuple(c.name for c in cases)
        if self.static:
            counted: Dict[str, int] = {}
            for case in cases:
                group = GROUPS[case.kernel]
                counted[group] = counted.get(group, 0) + 1
                for p in check_static(case):
                    yield finding(case.module, f"{p.kind}: {p.where}: {p.message}")
            print(f"analyze: [{self.name}] {json.dumps({'static_cases': counted}, sort_keys=True)}",
                  file=sys.stderr)
            return
        summary: Dict[str, dict] = {"cpu_cases": {}, "cuda_cases": {}, "canary_hits": {},
                                    "cuda_launches": {}, "mutants": {}, "kernel_mutants": {}}
        for case in cases:
            group = GROUPS[case.kernel]
            summary["cpu_cases"][group] = summary["cpu_cases"].get(group, 0) + 1
            for p in verify_case(case):
                yield finding(case.module, f"{p.kind}: {p.where}: {p.message}")
        for m in mutant_cases():
            kinds = sorted({p.kind for p in verify_case(m.case)})
            summary["mutants"][m.case.name] = {"expect": m.expect, "found": kinds}
            if m.expect not in kinds:
                yield finding(m.case.module, f"the verifier missed {m.case.name}: expected a "
                                             f"{m.expect} problem, found {kinds}")
        control = control_case()
        found = verify_case(control)
        summary["mutants"][control.name] = {"expect": None,
                                            "found": sorted({p.kind for p in found})}
        for p in found:
            yield finding(control.module, f"the control is not clean: {p}")

        if not torch.cuda.is_available():
            print(f"analyze: [{self.name}] CUDA half skipped: no CUDA device", file=sys.stderr)
            if self.require_cuda:
                yield Finding(check=self.name, path=_path("minplus"), line=0,
                              message="--require-cuda: no CUDA device, so the kernels did "
                                      "not run the lattice")
        else:
            before = _launch_counts()
            for case in cases:
                group = GROUPS[case.kernel]
                problems, hit = verify_case_cuda(case)
                summary["cuda_cases"][group] = summary["cuda_cases"].get(group, 0) + 1
                summary["canary_hits"][group] = summary["canary_hits"].get(group, 0) + int(hit)
                for p in problems:
                    yield finding(case.module, f"on the card: {p.kind}: {p.where}: "
                                               f"{p.message}")
            after = _launch_counts()
            summary["cuda_launches"] = {k: after[k] - before.get(k, 0) for k in after}
            for group, n in summary["cuda_cases"].items():
                if not summary["canary_hits"].get(group):
                    yield finding("minplus", f"on the card no {group} case received the "
                                             f"canary block ({n} cases)")
            for km in kernel_mutants():
                kinds = sorted({p.kind for p in verify_kernel_mutant(km)})
                summary["kernel_mutants"][km.name] = {"expect": km.expect, "found": kinds}
                if (km.expect is None and kinds) or (km.expect and km.expect not in kinds):
                    yield finding("minplus", f"kernel mutant {km.name}: expected "
                                             f"{km.expect or 'clean'}, found {kinds}")
        print(f"analyze: [{self.name}] {json.dumps(summary, sort_keys=True)}", file=sys.stderr)


register_checker(KernelGridChecker())
