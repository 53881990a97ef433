"""Kernel grid verifier: the six CUDA kernels' launch plans, machine-checked.

The counterpart of ``repro.analysis.kernelcheck``.  The JAX package's
verifier captures each ``pallas_call``'s grid and BlockSpec index maps and
interprets the Pallas body per grid point.  The port's kernels are CUDA, so
this package works on their **launch plans**, which every wrapper computes
in Python and its C entry point checks and refuses if they differ from its
own (``minplus.launch_plan``, ``fw_round.launch_plan``,
``fw_block.closure_launch``, ``row_close.launch_plan``):

* ``intercept`` — runs a wrapper on ``meta`` tensors and captures the plan
  it reports (``roofline.op_cost.KernelLog``);
* ``simulate``  — a CPU interpreter of the plans: every CTA of every grid
  reads (bounds-checked), folds with the plain versions' arithmetic, and
  writes (race-checked) into canary-seeded outputs;
* ``verify``    — the six problem kinds: static race, coverage and bounds
  theorems over the plan, then the interpreter against the oracle
  (``kernels.ref``) and the plain version; on a card, the same case
  through the CUDA kernel with a canary-seeded output;
* ``lattice``   — the JAX package's shape lattice plus the shapes where the
  CUDA plans change, and a case for every autotune candidate (``fwround``
  block sizes, the product and row-close tile lattices);
* ``mutants``   — plan mutants with one defect each and a clean control,
  their C forms for the card, and the seeded-defect kernels of
  ``csrc/mutants.cu``;
* ``checker``   — the registered ``kernel-grid`` gating check.
"""

from .intercept import Launch, capture, to_meta
from .simulate import Machine
from .verify import KINDS, Problem, check_plan, check_static, verify_case, verify_case_cuda
from .lattice import (
    Case,
    autotune_cases,
    case_for_fw_round_params,
    case_for_minplus_params,
    case_for_row_close_params,
    default_cases,
    lattice,
)
from .mutants import Mutant, control_case, mutant_cases
from . import checker as _checker  # noqa: F401  (registers "kernel-grid")

__all__ = [
    "Launch",
    "capture",
    "to_meta",
    "Machine",
    "KINDS",
    "Problem",
    "check_plan",
    "check_static",
    "verify_case",
    "verify_case_cuda",
    "Case",
    "default_cases",
    "autotune_cases",
    "case_for_fw_round_params",
    "case_for_minplus_params",
    "case_for_row_close_params",
    "lattice",
    "Mutant",
    "control_case",
    "mutant_cases",
]
