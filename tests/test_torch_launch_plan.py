"""The launch plans that the port's wrappers compute in Python and pass to
the CUDA kernels: the cluster closure's plan (``fw_block.closure_plan``,
taken by ``fw_closure``, ``fw_block`` and ``fw_block_pred`` up to 256
nodes), the grid closure's above it (``fw_block.closure_launch``, its rows
and its scratch ``grid_lines_words``), and ``fw_round``'s
scratches (``fw_round.scratch_shapes``, rows of pitch ``fw_round.pitch``).
The kernels check the same conditions (``close_plan_ok`` and
``grid_plan_ok`` in ``csrc/fw_closure.cuh``, the pitch test in
``fw_round_launch``) and refuse a plan that fails them; these tests hold
the plans to them on the CPU, for every tile size the kernels take.  The
row-close pass's plan (``row_close.launch_plan``: its tile, its k chunks
and its scratch; ``plan_ok`` in ``csrc/row_close.cu``) is held the same
way, and so are the product's (``minplus.launch_plan``: the tile, the
product and k-major grids, X^T's pitch, the ring's ``ny``, shared bytes;
``plan_is`` in ``csrc/minplus.cu``) and the fused round's
(``fw_round.launch_plan``: the grids of ``fw_panels``, ``fw_colpanel`` and
``fw_update``, the ring's tile, the pitches; ``round_plan_is`` in
``csrc/fw_round.cu``), for every shape the port launches.
"""

import importlib
import re
from pathlib import Path

import pytest

# By module path: ``repro_torch.kernels.fw_block`` and ``.fw_round`` are
# the ops functions of those names, as in ``repro.kernels``.
fb = importlib.import_module("repro_torch.kernels.fw_block")
fr = importlib.import_module("repro_torch.kernels.fw_round")
rc = importlib.import_module("repro_torch.kernels.row_close")
mp = importlib.import_module("repro_torch.kernels.minplus")

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
    """fw_round's scratches at B > 256: (G, B, B) pivots and their copy in
    rows of a 16-byte pitch, (G, B, Np) col'^T, row panel and transposed
    column panel, and the grid closure's lines; none of it B-limited."""
    n = 2 * b
    shapes = fr.scratch_shapes(g, n, b)
    np_ = fr.pitch(n)
    assert shapes == {"apiv": (g, b, b), "colt": (g, b, np_), "rowp": (g, b, np_),
                      "coln": (g, b, np_), "apv": (g, b, fr.pitch(b)),
                      "lines": (fb.grid_lines_words(b, g),)}
    assert "lines" not in fr.scratch_shapes(g, 512, 256)


# The row-close pass (csrc/row_close.cu): row lists the engine sends, from
# one row to a long list, sampled densely where the tile and the split
# change, on matrices of every class of n (1, below and above a tile, not a
# multiple of 4, the engine's 8192).
ROW_CLOSE_R = sorted(set(range(1, 70)) | {95, 96, 127, 128, 129, 200, 255, 256, 257, 511,
                                          512, 513, 1000, 1023, 1024, 1025, 1500, 2047, 2048})
ROW_CLOSE_N = [1, 3, 63, 64, 65, 8191, 8192]


def _row_close_constant(name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", (CSRC / "row_close.cu").read_text())
    assert m, name
    return int(m.group(1))


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("n", ROW_CLOSE_N)
def test_row_close_plan_owns_every_output_and_k_once(n, track):
    """Row tiles, column tiles and k chunks partition (r, n, n): every
    (row, column, k) is folded by exactly one CTA, no chunk is empty, every
    chunk but the last is whole slices long, and the grid fits CUDA's
    limits."""
    for r in ROW_CLOSE_R:
        plan = rc.launch_plan(r, n, track)
        rows = [i for m0 in range(0, -(-r // plan.rows) * plan.rows, plan.rows)
                for i in range(m0, min(r, m0 + plan.rows))]
        cols = [j for n0 in range(0, -(-n // plan.cols) * plan.cols, plan.cols)
                for j in range(n0, min(n, n0 + plan.cols))]
        ks = [k for c in range(plan.chunks) for k in plan.k_of(c, n)]
        assert rows == list(range(r)) and cols == list(range(n)) and ks == list(range(n))
        assert all(len(plan.k_of(c, n)) for c in range(plan.chunks)), (r, n)
        assert plan.chunk % plan.depth == 0 and plan.chunks <= 65535
        assert -(-r // plan.rows) <= 65535 and -(-n // 32) <= 65535


@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("n", ROW_CLOSE_N)
def test_row_close_plan_scratch(n, track):
    """The scratch bytes of the plan hold every element the kernels address:
    the k-major copy of d[rows] (n rows of the pitch, r rounded up to 32,
    the gather's 32-row tiles), the partial (value, k) planes (chunks, r, n)
    when k is split, and the 16-byte-pitch copy of d when n is not a
    multiple of 4."""
    for r in ROW_CLOSE_R:
        plan = rc.launch_plan(r, n, track)
        assert plan.pitch % 32 == 0 and r <= plan.pitch < r + 32
        xt = n * plan.pitch                           # xt[k][i], k < n, i < pitch
        assert (n - 1) * plan.pitch + plan.pitch - 1 < xt
        partial = 0
        if plan.chunks > 1:
            last = ((plan.chunks - 1) * r + r - 1) * n + n - 1
            partial = plan.chunks * r * n
            assert last < partial
        aligned = n * (-(-n // 32) * 32) if n % 4 else 0
        assert plan.scratch_bytes == 4 * (xt + partial * (2 if track else 1) + aligned)


@pytest.mark.parametrize("track", [False, True])
def test_row_close_tiles_fit_the_kernel(track):
    """The tiles row_close_launch takes (Tile in csrc/row_close.cu): 16, 32
    or 64 rows by the list's length, 128 threads of 8 x 8 outputs (8 x 4
    with a witness), a ring of three slices that leaves room for three CTAs
    an SM (CTAS_PER_SM, the kernels' kMinBlocks) in the SM's 228 KB."""
    assert rc.CTAS_PER_SM == _row_close_constant("kMinBlocks")
    threads = _row_close_constant("kThreads")
    tn = 4 if track else 8
    for r in ROW_CLOSE_R:
        plan = rc.launch_plan(r, 8192, track)
        assert plan.rows == (16 if r <= 16 else 32 if r <= 32 else 64)
        assert (plan.rows // 8) * (plan.cols // tn) == threads
        ring = 3 * plan.depth * (plan.rows + plan.cols) * 4
        assert rc.CTAS_PER_SM * (ring + 1024) <= 228 * 1024
        assert plan.depth * plan.cols // 4 % threads == 0        # whole 16-byte chunks


@pytest.mark.parametrize("track", [False, True])
def test_row_close_plan_fills_the_card(track):
    """At the engine's n the grid fills at least WAVE_FILL of its last wave
    of CTAS_PER_SM * SMs CTAs, k splits only where the row tiles alone do
    not, and every chunk is at least MIN_CHUNK long."""
    n, sms = 8192, 132
    wave = rc.CTAS_PER_SM * sms
    for r in ROW_CLOSE_R:
        plan = rc.launch_plan(r, n, track, sms)
        tiles = -(-r // plan.rows) * -(-n // plan.cols)
        ctas = tiles * plan.chunks
        assert ctas / (-(-ctas // wave) * wave) >= rc.WAVE_FILL, r
        assert plan.chunks == 1 or tiles / (-(-tiles // wave) * wave) < rc.WAVE_FILL
        assert plan.chunks == 1 or len(plan.k_of(0, n)) >= rc.MIN_CHUNK
    assert rc.launch_plan(4096, n, track, sms).chunks == 1
    assert rc.launch_plan(16, n, track, sms).chunks > 1


@pytest.mark.parametrize("r,n", [(0, 8), (4, 0)])
def test_row_close_plan_rejects_empty_operands(r, n):
    with pytest.raises(ValueError):
        rc.launch_plan(r, n, True)


# The product (csrc/minplus.cu) and the fused round's ring grids
# (csrc/fw_round.cu): the shapes the port launches.  Rounds: G graphs of N
# nodes at every tile the solvers and the tuner take (the paper corpus
# stacks up to 1000 graphs).  Products: the split and pred rounds' stages at
# N = 8192 and 16384 for B = 256, 512 and 1024, rank-k passes, squaring,
# R-Kleene's quadrants, spd_features' hops, batched stacks, N not a
# multiple of 4, and the empty k.
ROUND_SHAPES = [(g, n, b) for b in (8, 16, 32, 64, 100, 128, 256, 512, 1024)
                for n in (b, 2 * b, 8192 // b * b, 16384 // b * b) for g in (1, 4)] + [
    (1000, 1024, 256), (64, 2048, 256), (8, 8191 // 64 * 64, 64)]
PRODUCT_SHAPES = sorted({
    *((1, n, b, n) for n in (8192, 16384) for b in (256, 512, 1024)),
    *((1, b, b, n) for n in (8192, 16384) for b in (256, 512, 1024)),
    *((1, n, b, b) for n in (8192, 16384) for b in (256, 512, 1024)),
    *((1, 8192, k, 8192) for k in (1, 4, 16, 64)), (4, 8192, 16, 8192),
    (1, 1024, 1024, 1024), (1, 4096, 4096, 4096), (1, 8192, 8192, 8192),
    (1, 2048, 2048, 2048), (1, 8, 8191, 8191), (1, 64, 8192, 8192), (1, 8, 2708, 2708),
    (1000, 64, 64, 64), (64, 512, 256, 512), (2, 13, 21, 130), (1, 1, 1, 1), (1, 5, 0, 7)})


def _cfg(name: str, text: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", text)
    assert m, name
    return int(m.group(1))


def _ring_smem(bm: int, bn: int, bk: int, stages: int) -> int:
    """C's RingShape::kSmemBytes (minplus_tile.cuh), from its source."""
    text = (CSRC / "minplus_tile.cuh").read_text()
    assert "kStageFloats = BK * (BM + BN);" in text
    assert "kSmemBytes = STAGES * kStageFloats * 4;" in text
    return stages * bk * (bm + bn) * 4


@pytest.mark.parametrize("mode", ["minplus", "minplus_argmin", "minplus_pred"])
def test_product_plan_is_the_kernels(mode):
    """What plan_is checks: Cfg's tile (64 rows, 16 * TN columns, TN 8 for
    values and 4 with a witness, 32-deep slices, 3 slots), 128 threads of
    8 x TN outputs, the ring's shared bytes inside a CTA's 227 KB."""
    text = (CSRC / "minplus.cu").read_text()
    assert "static constexpr int TN = TRACK ? 4 : 8;" in text
    tn = 4 if mode != "minplus" else 8
    bm, bk, stages = _cfg("BM", text), _cfg("BK", text), _cfg("STAGES", text)
    assert "BN = 16 * TN" in text
    plan = mp.launch_plan(1, 100, 50, 300, mode)
    assert (plan.rows, plan.cols, plan.depth) == (bm, 16 * tn, bk)
    assert plan.threads == (bm // 8) * (16 * tn // tn) == 128
    assert plan.shared_bytes == _ring_smem(bm, 16 * tn, bk, stages) <= SHARED_PER_CTA
    with pytest.raises(ValueError):
        mp.launch_plan(1, 4, 4, 4, "minplus_pred_x")


@pytest.mark.parametrize("mode", ["minplus", "minplus_argmin", "minplus_pred"])
@pytest.mark.parametrize("g,m,k,n", PRODUCT_SHAPES)
def test_product_grids_cover_the_output_and_the_copy(g, m, k, n, mode):
    """The product grid's tiles cover (G, M, N) once with no tile past the
    last, within CUDA's 65535 for y and z; the k-major grid's 32 x 32 tiles
    cover X^T's (G, K, Mp) exactly (none when K = 0); Mp is M rounded up to
    32 floats (16-byte rows); the default ny is N rounded up to 4."""
    p = mp.launch_plan(g, m, k, n, mode)
    gx, gy, gz = p.grid
    assert gz == g and gx * p.cols >= n > (gx - 1) * p.cols and gy * p.rows >= m > (gy - 1) * p.rows
    assert gy <= 65535 and gz <= 65535
    assert p.xt_pitch % 32 == 0 and m <= p.xt_pitch < m + 32
    assert p.ny % 4 == 0 and n <= p.ny < n + 4
    if k:
        kx, ky, kz = p.kmajor_grid
        assert kx * 32 == p.xt_pitch and ky * 32 >= k > (ky - 1) * 32 and kz == g
        assert ky <= 65535 and kz <= 65535
    else:
        assert p.kmajor_grid == (0, 0, 0)


@pytest.mark.parametrize("g,n,b", ROUND_SHAPES)
def test_round_grids_cover_their_outputs(g, n, b):
    """fw_panels' 32 x 32 tiles cover the (B, N) panels, fw_colpanel's ring
    tiles col'^T's (B, N), fw_update's (N, N), each once, grid z G, y and z
    within 65535; the pitches are N and B rounded up to 32 floats, and the
    scratches of scratch_shapes have them."""
    p = fr.launch_plan(g, n, b)
    um, un = p.rows, p.cols
    assert p.panels_grid[0] * 32 >= n > (p.panels_grid[0] - 1) * 32
    assert p.panels_grid[1] * 32 >= b > (p.panels_grid[1] - 1) * 32
    assert p.colpanel_grid[0] * un >= n > (p.colpanel_grid[0] - 1) * un
    assert p.colpanel_grid[1] * um >= b > (p.colpanel_grid[1] - 1) * um
    assert p.update_grid[0] * un >= n > (p.update_grid[0] - 1) * un
    assert p.update_grid[1] * um >= n > (p.update_grid[1] - 1) * um
    for grid in (p.panels_grid, p.colpanel_grid, p.update_grid):
        assert grid[2] == g and grid[1] <= 65535 and grid[2] <= 65535
    assert (p.np, p.bp) == (fr.pitch(n), fr.pitch(b))
    assert p.scratch == fr.scratch_shapes(g, n, b) and p.closure == fb.closure_launch(b)


def test_round_ring_is_the_kernels():
    """round_plan_is's tile: UM x UN outputs, UK-deep slices, kStages slots
    (csrc/fw_round.cu), 128 threads of 8 x 8, the ring inside 227 KB."""
    text = (CSRC / "fw_round.cu").read_text()
    um, un, uk, st = (_cfg(k, text) for k in ("UM", "UN", "UK", "kStages"))
    p = fr.launch_plan(1, 512, 256)
    assert (p.rows, p.cols, p.depth) == (um, un, uk)
    assert p.threads == (um // 8) * (un // 8) == 128
    assert p.shared_bytes == _ring_smem(um, un, uk, st) <= SHARED_PER_CTA


@pytest.mark.parametrize("g,n,b", [(0, 8, 8), (1, 12, 8), (1, 4, 8), (1, 8, 0)])
def test_round_plan_rejects_shapes_the_kernel_does_not_take(g, n, b):
    with pytest.raises(ValueError):
        fr.launch_plan(g, n, b)
