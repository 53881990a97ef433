"""Seeded defects: proof that the grid verifier has teeth.

The counterpart of ``repro.analysis.kernelcheck.mutants``.  Each **plan
mutant** is a lattice case with exactly one defect in its launch plan (or in
the interpreter's rule that the plan stands for); the corpus test asserts
that every mutant is flagged with its expected kind and that the
defect-free control verifies clean:

* ``race``     — two k chunks of a split ``row_close`` overlap by one slice;
  every CTA of ``minplus``'s column grid mapped onto column tile 0;
* ``coverage`` — ``minplus``'s last column tile dropped from the grid;
  the ring's column limit ``ny`` below N; ``fw_update``'s grid one row of
  tiles short;
* ``bounds``   — a ``row_close`` gather id of n; ``fw_round``'s scratch
  pitch below N;
* ``padding``  — k past the end staged as 0.0 in place of the semiring zero;
* ``uninit``   — the split-k merge folding a partial plane no CTA wrote;
* the product's split-k combine: a missed chunk (the plan one chunk
  short, ``coverage``) and the chunks combined in descending order (a
  witness tie then goes to a larger k, ``mismatch``).

Where the defect is a field of the plan the C entry point takes, the
mutant carries that plan (``c_form``): ``refused_on_card`` hands it to the
entry point through the wrapper, which must refuse it (a non-zero
``cudaError_t``, nothing launched, the output's canary intact).  A gather
id is data, not plan (the wrapper checks ids on the host), and the
padding rule is kernel code: those have no C form.

**Kernel mutants** (card only) run ``csrc/mutants.cu``, a mini (min, +)
tile kernel templated on a defect (dropped init, ungated init, zero
padding) with its control, through :func:`verify_kernel_mutant`: the
seeded-defect ``pallas_call``s of the JAX package's corpus, on CUDA.
"""

from __future__ import annotations

import ctypes
import importlib
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.semiring import TROPICAL

from .lattice import (Case, _mat, _minplus_case, _row_close_case, case_for_fw_round_params,
                      reference_cases)
from .verify import Problem, _compare, recording_empty, to_device

__all__ = ["Mutant", "mutant_cases", "control_case", "refused_on_card", "KernelMutant",
           "kernel_mutants", "verify_kernel_mutant"]

CSRC = Path(__file__).resolve().parent / "csrc"


@dataclass
class Mutant:
    case: Case
    expect: str                              # the Problem kind that must appear
    c_form: Optional[Callable] = None        # plan -> the defective plan for the C entry


def _ref_case(name: str) -> Case:
    return next(c for c in reference_cases() if c.name == name)


def _variant(base: Case, name: str, **changes) -> Case:
    return replace(base, name=name, **changes)


def control_case() -> Case:
    """The unmutated product: must verify clean."""
    return _variant(_ref_case("minplus/aligned"), "mutant-control/clean")


def _with_id_n(inputs):
    def make():
        i = inputs()
        rows = i["rows"].clone()
        rows[-1] = i["d"].shape[0]
        return dict(i, rows=rows)
    return make


def _tied(inputs):
    """The case's operands rounded to whole numbers in [1, 4] (the zero
    kept): candidates tie across k chunks, so the combine's chunk order
    decides the witness."""
    def make():
        i = dict(inputs())
        for key in ("x", "y", "a"):
            t = i.get(key)
            if t is not None:
                i[key] = torch.where(torch.isinf(t), t, torch.remainder(t.floor(), 4) + 1)
        return i
    return make


def _split_witness() -> Case:
    """A witness product split over three chunks of its 64-row tile, no
    padding (64 x 96 x 64), with ties."""
    base = _minplus_case("minplus_argmin/split-ties", 64, 96, 64, accumulate=True, argmin=True,
                         seed=50, params={"tile_rows": 64, "chunks": 3})
    return replace(base, inputs=_tied(base.inputs))


def mutant_cases() -> List[Mutant]:
    aligned = _ref_case("minplus/aligned")          # (16, 32) x (32, 256): 2 column tiles
    padded = _ref_case("minplus/padded")            # (13, 21) x (21, 130): ny = 132
    split = _row_close_case("row_close/r16n512-split", 16, 512, seed=27)    # 2 k chunks
    gather = _ref_case("row_close/[bk=8,bn=128,kc=8]@r4n16")
    rnd = case_for_fw_round_params(64, 192, o=64, seed=25)
    tied = _split_witness()
    return [
        Mutant(_variant(split, "mutant/overlapping-k-chunk",
                        options=dict(k_ranges=[range(0, 256), range(224, 512)])),
               expect="race"),
        Mutant(_variant(aligned, "mutant/shrunk-column-grid",
                        options=dict(col_tile=lambda bx: 0)),
               expect="race",
               c_form=lambda p: p._replace(grid=(1,) + p.grid[1:])),
        Mutant(_variant(aligned, "mutant/dropped-last-tile",
                        plan_edit=lambda p: p._replace(grid=(p.grid[0] - 1,) + p.grid[1:])),
               expect="coverage",
               c_form=lambda p: p._replace(grid=(p.grid[0] - 1,) + p.grid[1:])),
        Mutant(_variant(padded, "mutant/ny-below-n", plan_edit=lambda p: p._replace(ny=128)),
               expect="coverage", c_form=lambda p: p._replace(ny=128)),
        Mutant(_variant(rnd, "mutant/fw_update-grid-short",
                        plan_edit=lambda p: p._replace(
                            update_grid=(p.update_grid[0], p.update_grid[1] - 1,
                                         p.update_grid[2]))),
               expect="coverage",
               c_form=lambda p: p._replace(
                   update_grid=(p.update_grid[0], p.update_grid[1] - 1, p.update_grid[2]))),
        Mutant(_variant(rnd, "mutant/fw_round-pitch-below-n",
                        plan_edit=lambda p: p._replace(np=160)),
               expect="bounds", c_form=lambda p: p._replace(np=160)),
        Mutant(_variant(gather, "mutant/gather-id-n", inputs=_with_id_n(gather.inputs)),
               expect="bounds"),
        Mutant(_variant(padded, "mutant/zero-padding", options=dict(fill_k=0.0)),
               expect="padding"),
        Mutant(_variant(split, "mutant/unwritten-partial", options=dict(planes=3)),
               expect="uninit",
               c_form=lambda p: p._replace(chunks=p.chunks + 1)),
        Mutant(_variant(tied, "mutant/combine-missed-chunk",
                        plan_edit=lambda p: p._replace(chunks=p.chunks - 1)),
               expect="coverage", c_form=lambda p: p._replace(chunks=p.chunks - 1)),
        Mutant(_variant(tied, "mutant/combine-chunks-descending",
                        options=dict(combine_planes=[2, 1, 0])),
               expect="mismatch"),
    ]


# ---------------------------------------------------------------------------
# the card: plan mutants through the C entry points, kernel mutants
# ---------------------------------------------------------------------------

def _kernel_mod(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _call_with_plan(case: Case, i: dict, plan):
    """The case's wrapper path with ``plan`` in place of its own."""
    from repro_torch.core.semiring import get_semiring

    sr = get_semiring(i["semiring"])
    if case.module == "minplus":
        mp = _kernel_mod("minplus")
        mode = mp.MODES.index(case.kernel)
        return mp._launch(case.kernel, mode, i["x"], i["y"], i.get("a"), sr, i.get("px"),
                          i.get("py"), i.get("pa"), i.get("k_offset", 0), i.get("j_offset", 0),
                          plan=plan)
    if case.module == "row_close":
        return _kernel_mod("row_close")._launch(case.kernel, i["d"], i["rows"], i.get("pred"),
                                                sr, plan=plan)
    return (_kernel_mod("fw_round")._round(i["d"], i["o"], i["block_size"], sr, plan=plan),)


def refused_on_card(mutant: Mutant, device="cuda") -> dict:
    """Hand the mutant's C form to its entry point on the card: ``refused``
    (the wrapper raised on the entry point's non-zero return), ``intact``
    (the output holds what it held before the call: for ``fw_round`` ``d``
    itself, else the first output, filled with the canary as the wrapper
    allocates it)."""
    from .verify import plan_of

    case = mutant.case
    i = case.inputs()
    plan = mutant.c_form(plan_of(case, i)[0].plan)
    dev_i = {k: to_device(v, device) for k, v in i.items()}
    before = dev_i["d"].clone() if case.module == "fw_round" else None
    refused = False
    with recording_empty(seed_first=True) as made:
        try:
            _call_with_plan(case, dev_i, plan)
        except RuntimeError as e:
            refused = "launch failed" in str(e)
    torch.cuda.synchronize(device)
    if case.module == "fw_round":
        intact = bool(torch.equal(dev_i["d"], before))
    else:
        intact = bool(made) and bool(torch.isnan(made[0]).all())
    return {"refused": refused, "intact": intact}


@dataclass
class KernelMutant:
    name: str
    defect: int          # csrc/mutants.cu DEFECT
    shape: Tuple[int, int, int]
    padded: bool
    expect: Optional[str]    # None: the control, must be clean


def kernel_mutants() -> List[KernelMutant]:
    return [
        KernelMutant("kernel-control/aligned", 0, (32, 32, 48), False, None),
        KernelMutant("kernel-control/padded", 0, (13, 21, 30), True, None),
        KernelMutant("kernel-mutant/dropped-init", 1, (32, 32, 48), False, "uninit"),
        KernelMutant("kernel-mutant/ungated-init", 2, (32, 32, 48), False, "mismatch"),
        KernelMutant("kernel-mutant/zero-padding", 3, (13, 21, 30), True, "padding"),
    ]


def verify_kernel_mutant(km: KernelMutant, device="cuda") -> List[Problem]:
    """Run one seeded-defect kernel on the card with its output seeded with
    the canary, and compare with the plain product."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.minplus import minplus_torch

    _build.register_source("mutants", CSRC / "mutants.cu")
    fn = _build.function("mutants", "mutant_launch",
                         [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
    m, k, n = km.shape
    rng = np.random.default_rng(km.defect * 7 + m)
    x = _mat(rng, (m, k), TROPICAL)
    y = _mat(rng, (k, n), TROPICAL)
    xd, yd = x.to(device), y.to(device)
    z = torch.full((m, n), float("nan"), device=device)
    err = fn(km.defect, xd.data_ptr(), yd.data_ptr(), z.data_ptr(), m, k, n,
             torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"mutant_launch failed: cudaError_t {err}")
    torch.cuda.synchronize(device)
    case = Case(name=km.name, kernel="minplus", module="minplus", inputs=lambda: {},
                padded=km.padded)
    return _compare((z.cpu(),), (minplus_torch(x, y),), case, "the plain version")

