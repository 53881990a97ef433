"""The launch-plan grid verifier (``repro_torch.analysis.kernelcheck``) on
the CPU.

The plans of all six CUDA wrappers are captured on ``meta`` tensors and
equal the plans their modules compute; every lattice case and every case
the autotuners can propose (``fwround`` block sizes, every tile and k split
of the product and row-close lattices) runs clean through the plan
interpreter, each case once (:data:`VERIFIED` is the ``kernel-grid``
check's lattice, which ``tests/test_torch_analysis.py`` holds to it);
every plan mutant is flagged with its kind and the control verifies
clean.  Parity with the JAX package: the lattice's first sixteen
cases carry ``repro.analysis.kernelcheck.lattice.default_cases``' names,
and the interpreter's results on the port's inputs equal the JAX oracle
(``repro.kernels.ref``, through each JAX case's ``expected()``) on the
JAX case's own inputs, drawn from the same seeds: exactly, as the JAX
verifier compares (rtol 0, atol 0).  The card's half (the lattice through
the CUDA kernels, the C entry points refusing the mutants' plans, the
seeded-defect kernels) is in ``tests/test_torch_cuda.py``.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from repro.analysis.kernelcheck import lattice as ref_lattice
from repro_torch.analysis.kernelcheck import (KINDS, autotune_cases, capture, check_plan,
                                              control_case, default_cases, lattice,
                                              mutant_cases, verify_case)
from repro_torch.analysis.kernelcheck.lattice import LATTICE_CHUNKS, GROUPS, reference_cases
from repro_torch.analysis.kernelcheck.simulate import Machine
from repro_torch.analysis.kernelcheck.verify import FAMILY, plan_of

fb = importlib.import_module("repro_torch.kernels.fw_block")
fr = importlib.import_module("repro_torch.kernels.fw_round")
mp = importlib.import_module("repro_torch.kernels.minplus")
rc = importlib.import_module("repro_torch.kernels.row_close")

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The interpreter runs many tiny tensor ops a CTA: one intra-op
    thread, so that a pytest-xdist worker beside others does not
    oversubscribe the host's cores (the module's cases ran 10-100x slower
    so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = {c.name: c for c in default_cases()}
MUTANTS = {m.case.name: m for m in mutant_cases()}
LATTICE = {c.name: c for c in lattice()}
FW_ROUND_AUTOTUNE = [c.name for c in autotune_cases() if c.kernel == "fw_round"]
TILE_AUTOTUNE = [c.name for c in autotune_cases() if c.kernel != "fw_round"]
# Every case these tests run through the interpreter, by name: the
# kernel-grid check's lattice.
VERIFIED = sorted(set(CASES) | set(FW_ROUND_AUTOTUNE) | set(TILE_AUTOTUNE))
_problems = {}


def verified(name):
    """The interpreter's problems for the lattice case ``name``, each case
    run once a process (a name the default lattice and the autotune lattice
    share, ``fw_round/b256@n512o256g0``, is one case)."""
    if name not in _problems:
        _problems[name] = [str(p) for p in verify_case(LATTICE[name])]
    return _problems[name]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_the_six_wrappers_report_their_plans_on_meta():
    i32 = torch.int32
    got = []
    got += capture(mp.minplus_cuda, meta(3, 70, 40), meta(3, 40, 130), meta(3, 70, 130))
    got += capture(mp.minplus_argmin_cuda, meta(70, 40), meta(40, 130))
    got += capture(mp.minplus_pred_cuda, meta(70, 40), meta(40, 130), meta(70, 40, dtype=i32),
                   meta(40, 130, dtype=i32))
    got += capture(fr.fw_round_cuda, meta(2, 512, 512), 256, block_size=256)
    got += capture(fb.fw_block_cuda, meta(3, 64, 64))
    got += capture(fb.fw_block_pred_cuda, meta(512, 512), meta(512, 512, dtype=i32))
    got += capture(rc.row_close_cuda, meta(8192, 8192), meta(16, dtype=i32), track=True)
    got += capture(rc.row_close_pred_cuda, meta(258, 258), meta(129, dtype=i32),
                   meta(258, 258, dtype=i32))
    assert [g.kernel for g in got] == ["minplus", "minplus_argmin", "minplus_pred", "fw_round",
                                       "fw_block", "fw_block_pred", "row_close_argmin",
                                       "row_close_pred"]
    assert {GROUPS[g.kernel] for g in got} == {"fw_round", "minplus", "minplus_argmin",
                                               "fw_block", "fw_block_pred", "row_close"}
    plans = [g.plan for g in got]
    # y (40, 130) contiguous: its rows are not 16-byte aligned, so the ring
    # reads a copy of pitch 160 up to column 132
    assert plans[0] == mp.launch_plan(3, 70, 40, 130, "minplus", ny=132)
    assert plans[0].grid == (2, 2, 3) and plans[0].kmajor_grid == (3, 2, 3)
    assert plans[1] == mp.launch_plan(1, 70, 40, 130, "minplus_argmin", ny=132)
    assert plans[1].cols == 64 and plans[1].grid == (3, 2, 1)
    assert plans[2] == mp.launch_plan(1, 70, 40, 130, "minplus_pred", ny=132)
    assert plans[3] == fr.launch_plan(2, 512, 256)
    assert plans[3].update_grid == (4, 8, 2) and plans[3].colpanel_grid == (4, 4, 2)
    assert plans[4] == fb.closure_launch(64) and plans[5] == fb.closure_launch(512, pred=True)
    assert plans[6] == rc.launch_plan(16, 8192, True) and plans[6].chunks > 1
    assert plans[7] == rc.launch_plan(129, 258, True)


@pytest.mark.parametrize("name", list(CASES))
def test_lattice_case_verifies_clean(name):
    assert verified(name) == []


@pytest.mark.parametrize("name", FW_ROUND_AUTOTUNE)
def test_every_fw_round_autotune_candidate_is_safe(name):
    from repro_torch.kernels import autotune

    assert verified(name) == []
    assert LATTICE[name].shape[2] in set(autotune._FW_ROUND_BLOCKS) | {8, 16}


@pytest.mark.parametrize("name", TILE_AUTOTUNE)
def test_every_product_and_row_close_candidate_is_safe(name):
    """Each tile and k split of the product and row-close lattices, at the
    smallest shape that pads its tiles and splits k, through the
    interpreter (partial planes, the combine or merge) against the oracle
    and the plain version."""
    case = LATTICE[name]
    assert verified(name) == []
    plan = plan_of(case)[0].plan
    assert case.params and plan.rows == case.params["tile_rows"]
    assert plan.chunks == case.params["chunks"]


def test_tile_autotune_cases_cover_every_candidate():
    """Every (tile rows, chunks) the tuners can propose for any shape, in
    every mode, is a lattice case: the candidates' chunk counts never
    exceed the lattice's."""
    from repro_torch.kernels import autotune

    covered = {(c.module, c.kernel, c.params["tile_rows"], c.params["chunks"])
               for c in LATTICE.values() if c.params}
    for m, k, n in ((1, 1, 1), (8, 8192, 8192), (4096, 2048, 4096), (64, 1 << 22, 64),
                    (100, 16384, 30)):
        for p in autotune.candidates("cuda", m, k, n):
            assert ("minplus", "minplus", p["tile_rows"], p["chunks"]) in covered
            assert ("row_close", "row_close", p["tile_rows"], p["chunks"]) in covered
    assert {(c[0], c[1]) for c in covered if c[3] == 3} == {
        ("minplus", "minplus"), ("minplus", "minplus_argmin"), ("minplus", "minplus_pred"),
        ("row_close", "row_close"), ("row_close", "row_close_argmin"),
        ("row_close", "row_close_pred")}
    assert set(LATTICE_CHUNKS) >= {1, 2, 4, 8, 16, 32, 64}


def test_autotune_cases_cover_every_candidate():
    from repro_torch.kernels import autotune

    blocks = {c.shape[2] for c in autotune_cases() if c.kernel == "fw_round"}
    assert set(autotune._FW_ROUND_BLOCKS) <= blocks
    for n in (1, 5, 9, 16, 17, 31, 64, 300, 8192):
        nb = autotune.bucket(n)
        proposed = tuple(b for b in autotune._FW_ROUND_BLOCKS if b <= nb) or (min(nb, 32),)
        assert set(proposed) <= blocks, n


def test_the_lattice_reaches_every_kernel_and_plan_class():
    cases = list(CASES.values())
    assert {GROUPS[c.kernel] for c in cases} == {"fw_round", "minplus", "minplus_argmin",
                                                 "fw_block", "fw_block_pred", "row_close"}
    closures = {c.shape[1] for c in cases if c.module == "fw_block"}
    closures |= {c.shape[2] for c in cases if c.module == "fw_round"}
    assert {8, 64, 256, 512} <= closures
    rows = {c.shape[0] for c in cases if c.module == "row_close"}
    assert {16, 64, 129} <= rows
    split = [c for c in cases if c.module == "row_close" and plan_of(c)[0].plan.chunks > 1]
    assert {c.kernel for c in split} == {"row_close", "row_close_argmin", "row_close_pred"}
    ny = [plan_of(c)[0].plan for c in cases if c.module == "minplus"]
    assert any(p.ny > c.shape[3] for p, c in zip(ny, [c for c in cases
                                                      if c.module == "minplus"]))


@pytest.mark.parametrize("name", list(MUTANTS))
def test_mutant_is_flagged_with_its_kind(name):
    m = MUTANTS[name]
    kinds = {p.kind for p in verify_case(m.case)}
    assert m.expect in KINDS and m.expect in kinds, kinds


def test_control_verifies_clean():
    assert verify_case(control_case()) == []


def test_mutants_cover_every_kind_and_carry_c_forms():
    assert {m.expect for m in MUTANTS.values()} >= {"race", "bounds", "coverage", "padding",
                                                    "uninit"}
    with_c = [m for m in MUTANTS.values() if m.c_form is not None]
    assert {m.case.module for m in with_c} == {"minplus", "fw_round", "row_close"}
    for m in with_c:
        plan = plan_of(m.case)[0].plan
        assert m.c_form(plan) != plan


def test_static_theorems_refuse_plans_over_the_cards_limits():
    case = CASES["minplus/aligned"]
    i = case.inputs()
    plan = plan_of(case, i)[0].plan
    assert check_plan("minplus", plan, i) == []
    kinds = lambda p: {k for k, _ in check_plan("minplus", p, i)}       # noqa: E731
    assert "bounds" in kinds(plan._replace(shared_bytes=300 * 1024))
    assert "bounds" in kinds(plan._replace(grid=(plan.grid[0], 70000, plan.grid[2])))
    assert "bounds" in kinds(plan._replace(xt_pitch=8))
    assert "bounds" in kinds(plan._replace(threads=96))
    rcase = CASES["row_close/r16n512-split"]
    ri = rcase.inputs()
    rplan = plan_of(rcase, ri)[0].plan
    assert check_plan("row_close", rplan, ri) == []
    assert "coverage" in {k for k, _ in check_plan(
        "row_close", rplan, ri, k_ranges=[range(0, 256), range(288, 512)])}
    assert "bounds" in {k for k, _ in check_plan("row_close", rplan._replace(pitch=8), ri)}
    fcase = CASES["fw_block/b64"]
    fi = fcase.inputs()
    fplan = plan_of(fcase, fi)[0].plan
    assert "coverage" in {k for k, _ in check_plan("fw_block", fplan._replace(rows=4), fi)}
    assert "coverage" in {k for k, _ in check_plan("fw_block", fplan._replace(cluster=1), fi)}


def test_the_interpreter_checks_every_index_before_reading():
    mc = Machine("unit")
    buf, _ = mc.input("d", torch.arange(10.0))
    mc.begin("g")
    assert mc.read(buf, torch.tensor([3, 9]), 0, "ok") is not None
    assert mc.read(buf, torch.tensor([3, 10]), 0, "past the end") is None
    out = mc.output("z", 4, torch.float32)
    mc.write(out, torch.tensor([0, 1]), torch.ones(2), 0, "cta 0")
    mc.write(out, torch.tensor([1, 2]), torch.ones(2), 1, "cta 1")
    mc.end()
    assert [k for k, _ in mc.problems] == ["bounds", "race"]
    assert torch.isnan(out.data[3])           # never written: the canary stays


# ---------------------------------------------------------------------------
# parity with the JAX package's lattice
# ---------------------------------------------------------------------------

def test_lattice_carries_the_jax_packages_case_names():
    assert [c.name for c in reference_cases()] == [c.name for c in ref_lattice.default_cases()]


@pytest.mark.parametrize("idx", range(16))
def test_interpreter_equals_the_jax_oracle(idx):
    ours, ref = reference_cases()[idx], ref_lattice.default_cases()[idx]
    assert ours.name == ref.name
    i = ours.inputs()
    plan = plan_of(ours, i)[0].plan
    fam = FAMILY[ours.kernel]
    mc = Machine(ours.name)
    got = fam.simulate(mc, ours.kernel, plan, i)
    assert mc.problems == []
    want = [np.asarray(v) for v in jax.tree_util.tree_leaves(ref.expected())]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w, equal_nan=True), ours.name
