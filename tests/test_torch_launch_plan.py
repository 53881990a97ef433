"""The launch plans that the port's wrappers compute in Python and pass to
the CUDA kernels: the cluster closure's plan (``fw_block.closure_plan``,
taken by ``fw_closure``, ``fw_block`` and ``fw_block_pred`` up to 256
nodes), the grid closure's above it (``fw_block.closure_launch``, its rows
and its scratch ``grid_lines_words``), and ``fw_round``'s
scratches (``fw_round.scratch_shapes``, rows of pitch ``fw_round.pitch``).
The kernels check the same conditions (``close_plan_ok`` and
``grid_plan_ok`` in ``csrc/fw_closure.cuh``, the pitch test in
``fw_round_launch``) and refuse a plan that fails them; these tests hold
the plans to them on the CPU, for every tile size the kernels take.
"""

import importlib
import re
from pathlib import Path

import pytest

# By module path: ``repro_torch.kernels.fw_block`` and ``.fw_round`` are
# the ops functions of those names, as in ``repro.kernels``.
fb = importlib.import_module("repro_torch.kernels.fw_block")
fr = importlib.import_module("repro_torch.kernels.fw_round")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
SHARED_PER_CTA = 227 * 1024      # the H100's 227 KB (232,448 bytes)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / "fw_closure.cuh").read_text())
    assert m, name
    return int(m.group(1))


def _close_smem_bytes(b: int, pred: bool) -> int:
    """C's ``close_smem_bytes(b, pred)``, evaluated from its source in
    ``fw_closure.cuh``: its constants read from the header, its one
    conditional ``(pred ? x : y)`` taken as Python's."""
    text = (CSRC / "fw_closure.cuh").read_text()
    m = re.search(r"int close_smem_bytes\(int b, bool pred\) \{\s*return ([^;]+);", text)
    assert m
    expr = re.sub(r"\(pred \? (\d+) : (\d+)\)", r"(\1 if pred else \2)", m.group(1))
    expr = re.sub(r"\bk\w+", lambda c: str(_constant(c.group(0))), expr)
    assert re.fullmatch(r"[\d\s()*+b]+(if pred else)?[\d\s()*+b]*", expr), expr
    return eval(expr, {}, {"b": b, "pred": pred})


@pytest.mark.parametrize("pred", [False, True])
def test_every_row_of_every_tile_is_owned_once(pred):
    for b in range(1, fb.MAX_BLOCK + 1):
        plan = fb.closure_plan(b, pred=pred)
        owned = [i for c in range(plan.cluster) for i in plan.rows_of(c, b)]
        assert owned == list(range(b)), b
        assert plan.rows % fb.STEP == 0 and plan.rows - fb.STEP < -(-b // plan.cluster) <= plan.rows


@pytest.mark.parametrize("pred", [False, True])
def test_plans_fit_the_kernel(pred):
    """What close_plan_ok checks: the portable cluster, at most 32 rows in
    registers in whole groups of STEP pivots, one thread a column in whole
    warps, the slots of C's close_smem_bytes inside the shared bytes and the
    shared bytes inside a CTA's 227 KB."""
    max_rows, step = _constant("kCloseMaxRows"), _constant("kCloseStep")
    assert (max_rows, step) == (fb.MAX_ROWS, fb.STEP)
    for b in range(1, fb.MAX_BLOCK + 1):
        plan = fb.closure_plan(b, pred=pred)
        assert plan.cluster == fb.CLUSTER == _constant("kClusterMax")
        assert 1 <= plan.rows <= max_rows and plan.rows % step == 0
        assert b <= plan.threads <= fb.MAX_BLOCK and plan.threads % 32 == 0
        assert _close_smem_bytes(b, pred) <= plan.shared_bytes <= SHARED_PER_CTA


def test_the_tile_held_on_chip_fits_a_cluster():
    """The tile lives in the cluster's registers: R values (and R preds) a
    thread.  At B = 256, 32 KiB of values and 32 KiB of preds a CTA, far
    inside one SM's 256 KiB register file."""
    for pred in (False, True):
        plan = fb.closure_plan(256, pred=pred)
        tile_bytes = 4 * plan.rows * plan.threads * (2 if pred else 1)
        assert tile_bytes == (64 if pred else 32) * 1024
        assert tile_bytes + plan.shared_bytes <= 256 * 1024


def test_cluster_classes():
    """Small B leaves CTAs without rows; B not a multiple of C * STEP a short
    last CTA; every group of STEP pivots lies in one CTA."""
    def owned(b):
        return [len(fb.closure_plan(b).rows_of(c, b)) for c in range(8)]

    assert fb.STEP == 8
    assert fb.closure_plan(1).rows == 8 and owned(1) == [1] + [0] * 7
    assert owned(5) == [5] + [0] * 7
    assert owned(9) == [8, 1] + [0] * 6
    assert owned(33) == [8, 8, 8, 8, 1, 0, 0, 0]
    assert owned(100) == [16] * 6 + [4, 0]
    assert owned(256) == owned(255)[:7] + [32] == [32] * 8
    for b in range(1, fb.MAX_BLOCK + 1):
        rows = fb.closure_plan(b).rows
        assert all(k // rows == (k - k % fb.STEP) // rows for k in range(b))


@pytest.mark.parametrize("b", [0, -1, fb.MAX_BLOCK + 1])
def test_closure_plan_rejects_tiles_the_kernels_do_not_take(b):
    with pytest.raises(ValueError):
        fb.closure_plan(b)


def test_scratch_pitch_is_a_multiple_of_32_at_least_n():
    for n in list(range(1, 2049)) + [8191, 8192, 8193, 100_000]:
        np_ = fr.pitch(n)
        assert np_ % 32 == 0 and n <= np_ < n + 32, n


# Tiles of the grid closure: just above the cluster closure, the reference
# cells' 512 and 1024, and one that is not a multiple of 32 or of 4.
GRID_B = [257, 512, 1000, 1024]


def _grid_lines_words(b: int, tiles: int, pred: bool) -> int:
    """C's ``grid_lines_words(b, tiles, pred)``, evaluated from its source."""
    text = (CSRC / "fw_closure.cuh").read_text()
    m = re.search(r"long long grid_lines_words\(int b, int tiles, bool pred\) \{\s*return ([^;]+);",
                  text)
    assert m
    expr = re.sub(r"\(pred \? (\d+) : (\d+)\)", r"(\1 if pred else \2)", m.group(1))
    expr = expr.replace("2LL", "2")
    assert re.fullmatch(r"[\d\s()*+a-z]+", expr), expr
    return eval(expr, {}, {"b": b, "tiles": tiles, "pred": pred})


@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("b", GRID_B)
def test_grid_plan_fits_the_kernel(b, pred):
    """Above 256 nodes the wrappers pass the grid closure's plan, which
    grid_plan_ok accepts: no cluster, no rows in registers, kGridThreads
    threads, no dynamic shared memory; up to 256 the cluster plan."""
    assert fb.GRID_THREADS == _constant("kGridThreads")
    assert fb.closure_launch(b, pred) == (0, 0, fb.GRID_THREADS, 0)
    assert fb.closure_launch(fb.MAX_BLOCK, pred) == fb.closure_plan(fb.MAX_BLOCK, pred)
    with pytest.raises(ValueError):
        fb.closure_plan(b, pred)      # the cluster plan keeps its meaning


@pytest.mark.parametrize("b", GRID_B)
@pytest.mark.parametrize("tiles", [1, 3])
def test_grid_closure_rows_and_columns_are_owned_once(b, tiles):
    """grid_close's loops: CTA c of C owns rows c, c + C, ... of the stacked
    tiles (tile t's row r is row t*B + r), its thread j columns j, j +
    kGridThreads, ...  Every row belongs to one CTA whatever the grid (the
    launch takes min(SMs, rows) CTAs), and the threads cover 0..B-1 once."""
    rows = tiles * b
    for ctas in (1, 7, 132, rows):
        owned = sorted(r for c in range(ctas) for r in range(c, rows, ctas))
        assert owned == list(range(rows)), ctas
    cols = sorted(c for j in range(fb.GRID_THREADS) for c in range(j, b, fb.GRID_THREADS))
    assert cols == list(range(b))


@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("b", GRID_B)
@pytest.mark.parametrize("tiles", [1, 3])
def test_grid_closure_scratch(b, tiles, pred):
    """The scratch the wrappers allocate is C's grid_lines_words: a barrier
    counter, then two buffers of the pivot's old row and column (and pred
    row) a tile; a 1024-node tile's lines are a few KiB beside its 4 MiB."""
    words = fb.grid_lines_words(b, tiles, pred)
    assert words == _grid_lines_words(b, tiles, pred)
    assert words == 4 + 2 * tiles * b * (3 if pred else 2)
    assert 4 * words < 4 * b * b * tiles / 8


@pytest.mark.parametrize("b", GRID_B)
@pytest.mark.parametrize("g", [1, 3])
def test_round_scratch_shapes(b, g):
    """fw_round's scratches at B > 256: (G, B, B) pivots, (G, B, Np) col'^T
    and row panel, and the grid closure's lines; none of it B-limited."""
    n = 2 * b
    shapes = fr.scratch_shapes(g, n, b)
    np_ = fr.pitch(n)
    assert shapes == {"apiv": (g, b, b), "colt": (g, b, np_), "rowp": (g, b, np_),
                      "lines": (fb.grid_lines_words(b, g),)}
    assert "lines" not in fr.scratch_shapes(g, 512, 256)
