"""The product kernels' tunable tile lattice on the CPU: ``minplus`` and
``row_close`` launch plans with the tuner's knobs (``tile_rows``,
``chunks``), ``autotune.candidates`` / ``_row_close_candidates``, the
measuring ``tune`` / ``tune_row_close`` on a stubbed card, ``tune_blocked_fw``,
``tune_fw_round``'s product warm-up, the ``**block_kw`` seam of
``kernels.ops`` (explicit knobs, the cache's winner, the plan reported on
``meta``) and the serving warm-up.

Held against the JAX package wherever it has a counterpart: the same key
families and fallbacks (``repro.kernels.autotune``), the three panel shapes
of ``tune_blocked_fw``, the warm-up branch of ``repro.launch.serve`` for
each method, and ``repro.kernels.ops`` on the same seeded numpy inputs
(integer weights: exact).  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``); here the plans, the plain versions of the
split-k product (the chunk partials and their combine) and the dispatch
are checked.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_autotune
from repro.kernels import ops as jax_ops
from repro_torch.kernels import autotune
from repro_torch.roofline import op_cost

mp = importlib.import_module("repro_torch.kernels.minplus")
rc = importlib.import_module("repro_torch.kernels.row_close")
ops = importlib.import_module("repro_torch.kernels.ops")
serve = importlib.import_module("repro_torch.launch.serve")

CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def at_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax-autotune.json"))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    return path


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _pr24_product_plan(g, m, k, n, mode):
    """The one plan the product kernel ran before the lattice (the 64-row
    tile, k whole), field for field (y's rows lying ready up to N rounded
    up to 4; N itself when k == 0)."""
    bn = 64 if mode != "minplus" else 128
    mpitch = -(-m // 32) * 32
    kgrid = (mpitch // 32, -(-k // 32), g) if k else (0, 0, 0)
    return ((64, bn, 32, (-(-n // bn), -(-m // 64), g), kgrid, mpitch,
             -(-n // 4) * 4 if k else n, 128, 3 * 32 * (64 + bn) * 4))


def _pr24_row_close_plan(r, n, track, sms=132):
    """``row_close.launch_plan`` before the knobs: the fill rule."""
    bm = 16 if r <= 16 else 32 if r <= 32 else 64
    tn = 4 if track else 8
    bn, bk = 16 * tn * 64 // bm, min(32, bm if track else bm // 2)
    tiles = -(-r // bm) * -(-n // bn)
    wave = 3 * sms

    def split(c):
        chunk = -(-(-(-n // c)) // bk) * bk
        return chunk, -(-n // chunk)

    def fill(c):
        ctas = tiles * split(c)[1]
        return ctas / (-(-ctas // wave) * wave)

    most = max(1, n // 256)
    c = next((c for c in range(1, most + 1) if fill(c) >= 0.9), max(range(1, most + 1), key=fill))
    chunk, chunks = split(c)
    pitch = -(-r // 32) * 32
    scratch = 4 * n * pitch + (chunks * r * n * (8 if track else 4) if chunks > 1 else 0)
    scratch += 4 * n * -(-n // 32) * 32 if n % 4 else 0
    return (bm, bn, bk, chunk, chunks, pitch, scratch)


PRODUCT_SHAPES = [(1, 8, 8192, 8192), (1, 64, 8192, 8192), (4, 8192, 16, 8192),
                  (1, 4096, 2048, 4096), (1, 256, 256, 8192), (1, 8192, 256, 256),
                  (1, 13, 21, 130), (2, 16, 32, 256), (1, 5, 0, 7), (1000, 64, 64, 64)]


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", mp.MODES)
def test_no_knob_no_entry_is_the_fixed_plan_on_meta(at_cache, mode):
    """With no cache entry and no knob, ``ops`` on ``meta`` reports the plan
    of the kernel before the lattice, field for field; the new fields say
    k is whole."""
    for g, m, k, n in PRODUCT_SHAPES:
        lead = (g,) if g > 1 else ()
        x, y, a = meta(*lead, m, k), meta(*lead, k, -(-n // 4) * 4)[..., :n], meta(*lead, m, n)
        with op_cost.KernelLog() as log:
            if mode == "minplus":
                ops.minplus(x, y, a)
            elif mode == "minplus_argmin":
                ops.minplus_argmin(x, y, a)
            else:
                px, py = meta(*lead, m, k, dtype=torch.int32), meta(*lead, k, n, dtype=torch.int32)
                ops.minplus_pred(x, y, px, py, a=a, pa=meta(*lead, m, n, dtype=torch.int32))
        assert [launch[0] for launch in log.launches] == [mode]
        plan = log.launches[0][2]
        assert tuple(plan)[:9] == _pr24_product_plan(g, m, k, n, mode), (g, m, k, n)
        assert (plan.chunks, plan.combine_grid, plan.partial_bytes) == (1, (0, 0, 0), 0)
        assert plan.chunk == (-(-k // 32) * 32)


@pytest.mark.parametrize("track", [False, True])
def test_no_knob_row_close_plan_is_the_fill_rule(at_cache, track):
    for n in (1, 3, 64, 65, 8191, 8192):
        for r in (1, 5, 16, 17, 33, 64, 129, 1024, 2048):
            assert tuple(rc.launch_plan(r, n, track)) == _pr24_row_close_plan(r, n, track)
    d, rows = meta(8192, 8192), meta(16, dtype=torch.int32)
    with op_cost.KernelLog() as log:
        ops.row_restricted_close(d, rows, pred=meta(8192, 8192, dtype=torch.int32)
                                 if track else None)
    assert tuple(log.launches[0][2]) == _pr24_row_close_plan(16, 8192, True if track else False)


def test_knobs_plan_the_tile_and_the_split():
    p = mp.launch_plan(1, 64, 8192, 8192, tile_rows=16, chunks=8)
    assert (p.rows, p.cols, p.depth, p.chunk, p.chunks) == (16, 512, 8, 1024, 8)
    assert p.grid == (16, 4, 8) and p.combine_grid == (32, 64, 1)
    assert p.partial_bytes == 8 * 64 * 8192 * 4
    w = mp.launch_plan(3, 70, 100, 130, "minplus_pred", tile_rows=32, chunks=3)
    assert (w.rows, w.cols, w.depth, w.chunk, w.chunks) == (32, 128, 32, 64, 2)
    assert w.grid == (2, 3, 6) and w.partial_bytes == 2 * 3 * 70 * 130 * 8
    assert [len(w.k_of(c, 100)) for c in range(w.chunks)] == [64, 36]
    assert w.knobs() == {"tile_rows": 32, "chunks": 2}
    assert mp.launch_plan(1, 5, 0, 7, chunks=4).chunks == 1
    for bad in ({"tile_rows": 48}, {"tile_rows": 128}, {"chunks": 0}, {"chunks": -2}):
        with pytest.raises(ValueError):
            mp.launch_plan(1, 64, 64, 64, **bad)
        with pytest.raises(ValueError):
            rc.launch_plan(16, 64, False, **bad)
    q = rc.launch_plan(16, 8192, True, tile_rows=64, chunks=4)
    assert (q.rows, q.cols, q.depth, q.chunk, q.chunks) == (64, 64, 32, 2048, 4)


# ---------------------------------------------------------------------------
# the lattice
# ---------------------------------------------------------------------------

SHAPES = [(1, 1, 1), (8, 8192, 8192), (64, 8192, 8192), (8192, 16, 8192), (4096, 2048, 4096),
          (256, 256, 8192), (8192, 256, 256), (100, 300, 500), (33, 16384, 40), (17, 1, 3),
          (64, 1 << 20, 64)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_every_candidate_is_a_legal_plan_bounded_by_the_bucket(m, k, n):
    """Every candidate plans for every mode at the bucketed shape (the
    tuner's) and the real one; tile rows never exceed what the bucketed m
    needs, chunks stay at least MIN_CHUNK of the bucketed k; the lattice is
    small (3 tiles by at most log2(k / 256) + 1 splits of at most 64 chunks:
    no larger than the JAX Pallas lattice's 3 x 2 x 2 x 2), no candidate
    twice."""
    cands = autotune.candidates("cuda", m, k, n)
    mb, kb, nb = autotune.bucket(m), autotune.bucket(k), autotune.bucket(n)
    assert cands and len(cands) == len({tuple(sorted(c.items())) for c in cands})
    assert len(cands) <= 3 * (1 + max(0, int(np.log2(max(kb // rc.MIN_CHUNK, 1)))))
    assert max(c["chunks"] for c in cands) <= 64 and len(cands) <= 24
    for c in cands:
        assert set(c) == {"tile_rows", "chunks"}
        assert c["tile_rows"] <= max(16, mb) and (c["chunks"] == 1 or kb // c["chunks"]
                                                  >= rc.MIN_CHUNK)
        for mode in mp.MODES:
            for shape in ((mb, kb, nb), (m, k, n)):
                plan = mp.launch_plan(1, *shape, mode, **c)
                assert plan.rows == c["tile_rows"] and plan.chunks <= c["chunks"]
    assert len(jax_autotune.candidates("pallas", m, k, n)) <= 24      # the JAX lattice's scale
    assert autotune.candidates("torch", m, k, n) == [{"fold_elements": mp._FOLD_BUDGET}]


@pytest.mark.parametrize("r,n", [(1, 8), (16, 8192), (64, 8192), (129, 8192), (1024, 8192),
                                 (5, 300)])
def test_row_close_candidates_hold_the_fill_rule(r, n):
    cands = autotune._row_close_candidates("cuda", r, n)
    fill = rc.launch_plan(r, n, False)
    assert {"tile_rows": fill.rows, "chunks": fill.chunks} in cands
    for c in cands:
        for track in (False, True):
            plan = rc.launch_plan(r, n, track, **c)
            assert plan.rows == c["tile_rows"] and plan.chunk % plan.depth == 0
    assert len(cands) <= len(autotune.candidates("cuda", r, n, n)) + 1


def test_candidates_split_only_a_grid_short_of_a_wave_within_the_partial_cap():
    """k is split only where the unsplit grid fills less than WAVE_FILL of
    its last wave (row_close's fill test), and no candidate's partials pass
    the cap: a 16384^3 or 8192^3 product, whose grid fills the card many
    times over, is measured whole; a short spd hop splits; a 1024-row panel
    splits no further than 1 GiB of partials allows."""
    cap = autotune._MAX_PARTIAL_BYTES
    for m, k, n, g in ((16384, 16384, 16384, 0), (8192, 8192, 8192, 0), (8, 8192, 8192, 0),
                       (1024, 1 << 22, 8192, 0), (64, 8192, 8192, 8), (129, 8192, 8192, 0)):
        mb, kb, nb, gb = (autotune.bucket(v) for v in (m, k, n, g or 1))
        gb = gb if g else 1
        cands = autotune.candidates("cuda", m, k, n, g=g)
        for c in cands:
            plan = mp.launch_plan(gb, mb, kb, nb, "minplus_argmin", **c)
            assert plan.partial_bytes <= cap
            ctas = plan.grid[0] * plan.grid[1] * gb
            assert c["chunks"] == 1 or rc.wave_fill(ctas) < rc.WAVE_FILL, (m, c)
    assert [c["chunks"] for c in autotune.candidates("cuda", 16384, 16384, 16384)] == [1, 1, 1]
    assert {c["chunks"] for c in autotune.candidates("cuda", 8192, 8192, 8192)} == {1}
    assert max(c["chunks"] for c in autotune.candidates("cuda", 8, 8192, 8192)) == 32
    wide = autotune.candidates("cuda", 1024, 1 << 22, 8192)
    assert max(c["chunks"] for c in wide if c["tile_rows"] == 64) == 16     # 16 x 64 MiB
    # a card of fewer SMs fills sooner: the 8192-row panel of 64-row tiles
    # fills 8 SMs' waves and is not split there either
    assert {c["chunks"] for c in autotune.candidates("cuda", 1024, 8192, 8192, sms=8)} == {1}


def test_lookups_read_the_cache_file_once_a_path(at_cache, monkeypatch):
    """A dispatch's lookup reads no file: the cache is parsed once a path,
    each bucket resolved once, and a save by this process (or another
    path) is read afresh."""
    autotune._save({autotune.key_for("cuda", torch.float32, 64, 8192, 8192):
                    {"params": {"tile_rows": 16, "chunks": 8}}})
    assert autotune.lookup("cuda", torch.float32, 64, 8192, 8192) == {"tile_rows": 16,
                                                                      "chunks": 8}
    real = autotune.Path.read_text

    def no_read(self, *a, **kw):
        raise AssertionError(f"a lookup read {self}")

    monkeypatch.setattr(autotune.Path, "read_text", no_read)
    for m in (33, 40, 64):
        assert autotune.lookup("cuda", torch.float32, m, 5000, 8000) == {"tile_rows": 16,
                                                                        "chunks": 8}
    assert len(autotune._memo["resolved"]) == 1        # one bucket, whatever the raw shape
    monkeypatch.setattr(autotune.Path, "read_text", real)
    autotune._save({autotune.key_for("cuda", torch.float32, 64, 8192, 8192):
                    {"params": {"tile_rows": 32, "chunks": 2}}})
    assert autotune.lookup("cuda", torch.float32, 64, 8192, 8192) == {"tile_rows": 32,
                                                                      "chunks": 2}
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(at_cache.parent / "other.json"))
    assert autotune.lookup("cuda", torch.float32, 64, 8192, 8192) == {}


# ---------------------------------------------------------------------------
# the tuners on a stubbed card
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """The tuners' card path on the CPU: ``_device`` says cuda, the
    operands stay on the CPU, the kernels record the knobs they were given
    and ``measure`` times a candidate by its knobs (fastest: 32 rows, 4
    chunks; row pass: 16 rows, 2 chunks)."""
    calls = []

    def kernel(kind, **kw):
        calls.append((kind, dict(kw)))

    monkeypatch.setattr(autotune, "_device", lambda device: CUDA)
    monkeypatch.setattr(autotune, "_sms", lambda device: 132)
    monkeypatch.setattr(autotune, "_in_domain", lambda shape, sr, dev, seed: torch.zeros(shape))
    monkeypatch.setattr(autotune, "_tuning_rows",
                        lambda n, r, dev: torch.arange(r, dtype=torch.int32))
    monkeypatch.setattr(mp, "minplus_cuda",
                        lambda x, y, a, semiring, **kw: kernel("product", **kw))
    monkeypatch.setattr(rc, "_prepare", lambda name, d, rows, pred, sr, **kw:
                        (lambda: kernel("row", **kw) or 0, None, None, None))
    fastest = {"product": {"tile_rows": 32, "chunks": 4}, "row": {"tile_rows": 16, "chunks": 2}}

    def measure(fn, reps, device="cpu", burst=1):
        assert burst == 8
        fn()
        kind, kw = calls[-1]
        return 1.0 if kw == fastest[kind] else 5.0 + kw["chunks"]

    monkeypatch.setattr(autotune, "measure", measure)
    return calls


def test_tune_measures_the_lattice_and_persists_the_fastest(at_cache, fake_card):
    e = autotune.tune(64, 8192, 8192, device="cuda")
    assert e["source"] == "measured" and e["params"] == {"tile_rows": 32, "chunks": 4}
    assert e["lattice"] == len(autotune.candidates("cuda", 64, 8192, 8192)) and e["us"] == 1.0
    tried = {tuple(sorted(c.items())) for _, c in fake_card}
    assert tried == {tuple(sorted(c.items())) for c in autotune.candidates("cuda", 64, 8192,
                                                                           8192)}
    # interleaved: every candidate timed once a round, two rounds
    assert len(fake_card) == 2 * e["lattice"]
    key = autotune.key_for("cuda", torch.float32, 64, 8192, 8192)
    assert key == jax_autotune.key_for("cuda", jnp.float32, 64, 8192, 8192)
    assert autotune.load_entries()[key]["params"] == e["params"]
    n = len(fake_card)
    again = autotune.tune(64, 8192, 8192, device="cuda")
    assert again["source"] == "cache" and again["params"] == e["params"] and len(fake_card) == n
    # lookups: same bucket, g -> 0 and semiring -> tropical fallbacks
    assert autotune.lookup("cuda", torch.float32, 40, 5000, 6000) == e["params"]
    assert autotune.lookup("cuda", torch.float32, 40, 5000, 6000, g=3,
                           semiring="reliability") == e["params"]
    assert autotune.lookup("torch", torch.float32, 40, 5000, 6000) == {}


def test_tune_honours_disabled_and_force(at_cache, fake_card, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert autotune.tune(64, 8192, 8192, device="cuda")["source"] == "disabled"
    assert autotune.tune_row_close(16, 8192, device="cuda")["source"] == "disabled"
    assert fake_card == [] and not at_cache.exists()
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    autotune.tune(64, 8192, 8192, device="cuda")
    n = len(fake_card)
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    assert autotune.tune(64, 8192, 8192, device="cuda")["source"] == "measured"
    assert len(fake_card) == 2 * n
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert autotune.tune(64, 8192, 8192, device="cuda", force=True)["source"] == "measured"


def test_tune_row_close_measures_its_lattice(at_cache, fake_card):
    e = autotune.tune_row_close(16, 8192, device="cuda")
    assert e["source"] == "measured" and e["params"] == {"tile_rows": 16, "chunks": 2}
    assert e["lattice"] == len(autotune._row_close_candidates("cuda", 16, 8192))
    key = autotune.key_for_row_close("cuda", torch.float32, 16, 8192)
    assert key == jax_autotune.key_for_row_close("cuda", jnp.float32, 16, 8192)
    assert autotune.lookup_row_close("cuda", torch.float32, 12, 8000) == e["params"]
    assert autotune.tune_row_close(16, 8192, device="cuda")["source"] == "cache"


def test_cpu_tuners_measure_and_write_nothing(at_cache, monkeypatch):
    monkeypatch.setattr(autotune, "measure", lambda *a, **k: pytest.fail("measured"))
    assert autotune.tune(64, 8192, 8192, device="cpu")["params"] == {
        "fold_elements": mp._FOLD_BUDGET}
    assert autotune.tune_blocked_fw(64, 16, device="cpu")["phase3"]["source"].startswith(
        "fixed plan")
    assert not at_cache.exists()


def test_tune_blocked_fw_tunes_the_jax_packages_three_shapes(monkeypatch):
    ours, theirs = [], []
    monkeypatch.setattr(autotune, "tune", lambda m, k, n, g=0, **kw: ours.append((m, k, n, g)))
    monkeypatch.setattr(jax_autotune, "tune", lambda m, k, n, g=0, **kw: theirs.append((m, k, n, g)))
    for n, b, g in ((8192, 256, 0), (1024, 64, 16), (100, 256, 3)):
        autotune.tune_blocked_fw(n, b, g=g, device="cpu")
        jax_autotune.tune_blocked_fw(n, b, g=g, backend="xla")
    assert ours == theirs and ours[:3] == [(256, 256, 8192, 0), (8192, 256, 256, 0),
                                           (8192, 256, 8192, 0)]


def test_tune_fw_round_warms_each_blocks_product_before_the_sweep(at_cache, monkeypatch):
    """The repair: the sweep times each round with the products its
    dispatch will run, so each candidate block's (N, B, N) product is tuned
    first, as ``repro.kernels.autotune.tune_fw_round`` does."""
    order = []
    monkeypatch.setattr(autotune, "_device", lambda device: CUDA)
    monkeypatch.setattr(autotune, "_sms", lambda device: 132)
    monkeypatch.setattr(autotune, "_in_domain", lambda shape, sr, dev, seed: torch.zeros(shape))
    monkeypatch.setattr(autotune, "tune", lambda m, k, n, **kw: order.append(("tune", m, k, n)))
    bfw = importlib.import_module("repro_torch.core.blocked_fw")
    monkeypatch.setattr(bfw, "blocked_fw",
                        lambda h, **kw: order.append(("solve", kw["block_size"])) or (h, None))
    monkeypatch.setattr(autotune, "measure",
                        lambda fn, reps, device="cpu", burst=1: (fn(), 1.0)[1])
    jax_order = []
    monkeypatch.setattr(jax_autotune, "tune",
                        lambda m, k, n, **kw: jax_order.append(("tune", m, k, n)))
    e = autotune.tune_fw_round(1000, device="cuda", blocks=(32, 64, 128))
    assert e["source"] == "measured"
    first_solve = next(i for i, step in enumerate(order) if step[0] == "solve")
    assert order[:first_solve] == [("tune", 1024, b, 1024) for b in (32, 64, 128)]
    jbfw = importlib.import_module("repro.core.blocked_fw")
    monkeypatch.setattr(jbfw, "blocked_fw", lambda h, **kw: (h, None))
    jax_autotune.tune_fw_round(1000, backend="xla", blocks=(32, 64, 128), reps=1)
    assert jax_order == order[:first_solve]


@pytest.mark.parametrize("backend", ["pallas", "xla", "interpret", None])
def test_tuners_take_and_drop_the_jax_backend(at_cache, fake_card, monkeypatch, backend):
    """The repair: a call written for the JAX tuners' signature passes
    ``backend=``; the port drops it whatever its value (the route follows
    ``device``), so each tuner measures the same candidates on the card and
    keys and returns the same entries as without it."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "force")
    bfw = importlib.import_module("repro_torch.core.blocked_fw")
    monkeypatch.setattr(bfw, "blocked_fw", lambda h, **kw: (h, None))

    card_measure = autotune.measure         # the stubbed card's: times a candidate's knobs

    def sweep(**kw):
        del fake_card[:]
        monkeypatch.setattr(autotune, "measure", card_measure)
        got = [autotune.tune(64, 8192, 8192, device="cuda", **kw),
               autotune.tune_row_close(16, 8192, device="cuda", **kw),
               *autotune.tune_blocked_fw(8192, 256, device="cuda", **kw).values()]
        # the round sweep times whole (stubbed) solves, a burst of one each
        monkeypatch.setattr(autotune, "measure",
                            lambda fn, reps, device="cpu", burst=1: (fn(), 1.0)[1])
        got.append(autotune.tune_fw_round(1000, device="cuda", blocks=(32, 64), **kw))
        return ([{k: v for k, v in e.items() if k != "measured_at"} for e in got],
                list(fake_card), sorted(autotune.load_entries(reload=True)))

    plain = sweep()
    given = sweep(backend=backend)
    assert given == plain
    assert all(e["source"] == "measured" for e in given[0])
    assert given[1] and all(kind in ("product", "row") for kind, _ in given[1])
    assert all(key.startswith(("cuda|", "rowclose|cuda|", "fwround|cuda|")) for key in given[2])


# ---------------------------------------------------------------------------
# the dispatch seam
# ---------------------------------------------------------------------------

def test_jax_signatures_block_kw_no_longer_raise(at_cache):
    """The repair: a call written for the JAX signature passes its Pallas
    knobs through ``**block_kw``; the port keeps only its own knobs (none
    for the plain versions), as ``repro.kernels.ops._tuned`` filters."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(1, 9, (6, 5)).astype(np.float32))
    y = torch.from_numpy(rng.integers(1, 9, (5, 7)).astype(np.float32))
    kw = dict(bm=64, bn=128, bk=256, kc=8, row_chunk=4, tile_rows=16, chunks=2)
    assert torch.equal(ops.minplus(x, y, **kw), ops.minplus(x, y))
    assert torch.equal(ops.minplus_argmin(x, y, **kw)[1], ops.minplus_argmin(x, y)[1])
    with op_cost.KernelLog() as log:
        ops.minplus(x.to("meta"), y.to("meta"), bm=64, bn=128)
    assert log.launches[0][2] == mp.launch_plan(1, 6, 5, 7, ny=8)


def test_meta_dispatch_reports_the_cached_winner_and_explicit_knobs_win(at_cache):
    autotune._save({
        autotune.key_for("cuda", torch.float32, 64, 8192, 8192):
            {"params": {"tile_rows": 16, "chunks": 8, "us": 3}},
        autotune.key_for("cuda", torch.float32, 8192, 16, 8192):
            {"params": {"tile_rows": 32, "chunks": 1}},
        autotune.key_for_row_close("cuda", torch.float32, 16, 8192):
            {"params": {"tile_rows": 32, "chunks": 4}},
        autotune.key_for("cuda", torch.float32, 8192, 256, 8192):
            {"params": {"tile_rows": 16, "chunks": 1}}})
    x, h = meta(64, 8192), meta(8192, 8192)
    i32 = torch.int32

    def plans(fn):
        with op_cost.KernelLog() as log:
            fn()
        return [(name, plan) for name, _, plan, _ in log.launches]

    got = plans(lambda: ops.minplus(x, h, x))
    want = mp.launch_plan(1, 64, 8192, 8192, tile_rows=16, chunks=8)
    assert got == [("minplus", want), ("minplus_combine", (8,) + want.combine_grid[:2])]
    got = plans(lambda: ops.minplus_argmin(x, h, x, semiring="bottleneck"))   # tropical fallback
    assert got[0] == ("minplus_argmin", mp.launch_plan(1, 64, 8192, 8192, "minplus_argmin",
                                                       tile_rows=16, chunks=8))
    assert plans(lambda: ops.minplus(x, h, x, tile_rows=64))[0][1] == mp.launch_plan(
        1, 64, 8192, 8192, tile_rows=64)                                    # explicit wins
    got = plans(lambda: ops.minplus_pred(x, h, meta(64, 8192, dtype=i32), meta(8192, 8192, dtype=i32),
                                         a=x, pa=meta(64, 8192, dtype=i32)))
    assert got[0][1].rows == 16 and got[1][0] == "minplus_combine"
    d4, u = meta(4, 8192, 8192), meta(4, 16, dtype=torch.int64)
    got = plans(lambda: ops.rank_k_update(d4, u, u, meta(4, 16)))            # g 4 -> 0
    assert got == [("minplus", mp.launch_plan(4, 8192, 16, 8192, tile_rows=32))]
    got = plans(lambda: ops.row_restricted_close(h, meta(16, dtype=i32)))
    assert tuple(got[0][1]) == tuple(rc.launch_plan(16, 8192, False, tile_rows=32, chunks=4))
    got = plans(lambda: ops.row_restricted_close(h, meta(16, dtype=i32), tile_rows=64))
    assert got[0][1][0] == 64 and tuple(got[0][1]) == tuple(rc.launch_plan(16, 8192, False,
                                                                          tile_rows=64))
    got = plans(lambda: ops.fw_round_pred(h, meta(8192, 8192, dtype=i32), 256, block_size=256))
    assert [n_ for n_, _ in got] == ["fw_block_pred", "minplus_pred", "minplus_pred"]
    assert got[2][1].rows == 16                                              # the (N, B, N) winner
    with pytest.raises(ValueError):
        ops.minplus(x, h, x, tile_rows=48)
    with pytest.raises(ValueError):
        ops.row_restricted_close(h, meta(16, dtype=i32), chunks=0)


def test_disabled_cache_reaches_no_dispatch(at_cache, monkeypatch):
    autotune._save({autotune.key_for("cuda", torch.float32, 64, 8192, 8192):
                    {"params": {"tile_rows": 16, "chunks": 8}}})
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    with op_cost.KernelLog() as log:
        ops.minplus(meta(64, 8192), meta(8192, 8192), meta(64, 8192))
    assert [n_ for n_, *_ in log.launches] == ["minplus"]
    assert log.launches[0][2] == mp.launch_plan(1, 64, 8192, 8192)


def _ints(rng, shape, hi=9, zero=0.25):
    a = rng.integers(1, hi, shape).astype(np.float32)
    return np.where(rng.uniform(size=shape) < zero, np.inf, a).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"bm": 64, "bn": 128, "bk": 256, "kc": 8},
                                {"tile_rows": 16, "chunks": 4}])
def test_ops_with_block_kw_equal_the_jax_dispatch(at_cache, kw):
    """On the CPU the port's ``ops`` with any knobs equal
    ``repro.kernels.ops`` with the same knobs, exactly (integer weights)."""
    rng = np.random.default_rng(5)
    x, y, a = _ints(rng, (9, 40)), _ints(rng, (40, 11)), _ints(rng, (9, 11))
    t, j = torch.from_numpy, jnp.asarray
    jkw = {k: v for k, v in kw.items() if k in ("bm", "bn", "bk", "kc")}
    np.testing.assert_array_equal(ops.minplus(t(x), t(y), t(a), **kw).numpy(),
                                  np.asarray(jax_ops.minplus(j(x), j(y), j(a), **jkw)))
    z, ks = ops.minplus_argmin(t(x), t(y), t(a), **kw)
    jz, jk = jax_ops.minplus_argmin(j(x), j(y), j(a), **jkw)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jk))
    px, py, pa = (rng.integers(-1, 40, s).astype(np.int32) for s in ((9, 40), (40, 11), (9, 11)))
    z, pz = ops.minplus_pred(t(x), t(y), t(px), t(py), a=t(a), pa=t(pa), k_offset=3, **kw)
    jz, jp = jax_ops.minplus_pred(j(x), j(y), j(px), j(py), a=j(a), pa=j(pa), k_offset=3,
                                  **jkw)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jp))
    d = _ints(rng, (12, 12))
    np.fill_diagonal(d, 0)
    u, v = np.array([0, 3, 5], np.int32), np.array([4, 7, 1], np.int32)
    w = np.array([1, 2, 3], np.float32)
    pd = np.where(np.isinf(d), -1, np.arange(12)[:, None]).astype(np.int32)
    z, pz = ops.rank_k_update(t(d), t(u), t(v), t(w), pred=t(pd), **kw)
    jz, jp = jax.jit(lambda *args: jax_ops.rank_k_update(*args[:4], pred=args[4], **jkw))(
        j(d), j(u), j(v), j(w), j(pd))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jp))
    rows = np.array([0, 5, 11, 5], np.int32)
    z, pz = ops.row_restricted_close(t(d), t(rows), pred=t(pd), **kw)
    jz, jp = jax_ops.row_restricted_close(j(d), j(rows), pred=j(pd),
                                          **{k: v for k, v in jkw.items() if k != "bm"})
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jp))
    z, pz = ops.fw_round_pred(t(d), t(pd), 4, block_size=4, **kw)
    jz, jp = jax_ops.fw_round_pred(j(d), j(pd), 4, block_size=4, **jkw)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jp))


@pytest.mark.parametrize("chunks", [2, 3, 5])
def test_split_k_plain_fold_equals_the_jax_witness_fold(chunks):
    """The split-k product's plain versions (each k chunk folded from the
    zero, then the chunks combined in ascending order with the strict
    improvement) equal ``repro.kernels.ops.minplus_argmin`` and
    ``minplus_pred`` bit for bit on tied integer weights: ties keep the
    smallest k across chunks."""
    rng = np.random.default_rng(chunks)
    x, y, a = _ints(rng, (2, 7, 37), 3), _ints(rng, (2, 37, 9), 3), _ints(rng, (2, 7, 9), 5)
    t = torch.from_numpy
    chunk = -(-37 // chunks)
    for mode in mp.MODES:
        pz, pk = mp.minplus_partials_torch(t(x), t(y), chunk, track=mode != "minplus")
        assert pz.shape == (-(-37 // chunk), 2, 7, 9)
        if mode == "minplus":
            z, _ = mp.minplus_combine_torch(pz, None, t(a))
            np.testing.assert_array_equal(z.numpy(), np.asarray(jax_ops.minplus(x, y, a)))
        elif mode == "minplus_argmin":
            z, ks = mp.minplus_combine_torch(pz, pk, t(a), mode=mode)
            jz, jk = jax_ops.minplus_argmin(x, y, a)
            np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
            np.testing.assert_array_equal(ks.numpy(), np.asarray(jk))
        else:
            px, py, pa = (rng.integers(-1, 9, s).astype(np.int32)
                          for s in ((2, 7, 37), (2, 37, 9), (2, 7, 9)))
            z, pz_ = mp.minplus_combine_torch(pz, pk, t(a), t(px), t(py), t(pa), mode=mode,
                                              k_offset=2, j_offset=1)
            jz, jp = jax.vmap(lambda *v: jax_ops.minplus_pred(
                v[0], v[1], v[2], v[3], a=v[4], pa=v[5], k_offset=2, j_offset=1))(
                x, y, px, py, a, pa)
            np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
            np.testing.assert_array_equal(pz_.numpy(), np.asarray(jp))


# ---------------------------------------------------------------------------
# the serving warm-up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["blocked_fw", "squaring", "squaring_3d", "rkleene",
                                    "classic"])
def test_serving_warm_up_takes_the_jax_branch(at_cache, monkeypatch, capsys, method):
    """``serve_apsp`` warms what the JAX server warms, before its first
    batch: the same tuner calls in the same order for each method, and the
    same ``[autotune] dispatch warm`` line."""
    import repro.launch.serve as jax_serve

    def recorder(log):
        def tune(*args, **kw):
            log.append(("tune",) + tuple(args) + (kw.get("g", 0),))
            return {"params": {}, "source": "measured"}

        def tune_fw_round(n, **kw):
            log.append(("tune_fw_round", n))
            return {"params": {"block_size": 32}, "source": "measured"}

        def tune_blocked_fw(n, b, **kw):
            log.append(("tune_blocked_fw", n, b, kw.get("g", 0)))
            return {"row_panel": {"source": "cache"}}

        return dict(tune=tune, tune_fw_round=tune_fw_round, tune_blocked_fw=tune_blocked_fw)

    ours, theirs = [], []
    for name, fn in recorder(ours).items():
        monkeypatch.setattr(autotune, name, fn)
    for name, fn in recorder(theirs).items():
        monkeypatch.setattr(jax_autotune, name, fn)
    n_max = 300 if method == "rkleene" else 64
    assert serve.serve_apsp(0, batch=4, n_max=n_max, method=method, device="cpu") == 0
    port_out = capsys.readouterr().out
    assert jax_serve.serve_apsp(0, batch=4, n_max=n_max, method=method) == 0
    jax_out = capsys.readouterr().out
    assert ours == theirs
    assert (ours == []) == (method == "classic")
    warm = [ln.split(",")[0] for ln in port_out.splitlines() if "dispatch warm" in ln]
    assert warm == [ln.split(",")[0] for ln in jax_out.splitlines() if "dispatch warm" in ln]
