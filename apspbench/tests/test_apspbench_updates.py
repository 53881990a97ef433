"""The ``updates`` kind on the CPU at V = 256, out-degree 4.9 as in the
cell: the table is a stratified sample of uniformly drawn edges, the same
for a seed; every window walks whole cycles of it, the top strata's raises
re-solving warm and the others re-closing rows; a sound engine reads 0 on
every limit, and an engine whose worsening phase leaves its state stale
reads ``rows_off`` above it.

    python -m pytest -q apspbench/tests/test_apspbench_updates.py
"""

import sys
import time

import numpy as np
import pytest
import torch

from apspbench import graphs, kinds, run, spec
from apspbench.kinds import updates
from apspbench.tests.test_apspbench_harness import Program, StaleEngine
from apspbench.tests.test_apspbench_parts import brute_closure

sys.path.insert(0, str(spec.ROOT / "src"))
import repro_torch  # noqa: E402

V = 256
SEEDS = (2 ** 31 + 21, 3_200_000_023, 5)


def small():
    bench = spec.load()
    wl = spec.cell(bench, "gen32k.updates")
    cfg = dict(spec.config(bench, wl["config"]), V=V, rho=200 * 4.9 / V)
    return bench, cfg, spec.traffic(wl["traffic"])


def cell_run(program, seed, seconds=0.5):
    bench, cfg, traffic = small()
    return run.run_cell(program, bench, "gen32k.updates", cfg, traffic, seed, seconds, False,
                        "cpu", time.perf_counter())


def test_table_is_a_stratified_uniform_draw():
    _, cfg, traffic = small()
    h = graphs.paper_graph(graphs.torch_generator(SEEDS[0], "cpu"), V, cfg["rho"],
                           int(cfg["alpha"]))
    strata, per = traffic["strata"], traffic["edges_per_stratum"]
    k = strata * per
    tu, tv, share, tight = updates.draw_table(h, graphs.numpy_rng(SEEDS[0], 2),
                                              traffic["sample"], strata, per)
    assert tu.shape == tv.shape == share.shape == (k,) and tight.shape == (k, V)
    assert len(set((tu * V + tv).tolist())) == k                     # distinct edges
    hn = h.numpy()
    assert np.all(np.isfinite(hn[tu, tv])) and np.all(tu != tv)     # existing edges
    d = brute_closure(hn)
    want = np.isfinite(d[:, tv]) & (d[:, tu] + hn[tu, tv] == d[:, tv])
    assert np.array_equal(tight.numpy(), want.T)
    assert np.array_equal(share, want.mean(axis=0))
    # the sample holds every edge here: set j is the j-th edge at the
    # midpoint of each of the equal strata of all edges sorted by share,
    # the low strata and the high alike
    edge = np.isfinite(hn) & ~np.eye(V, dtype=bool)
    assert edge.sum() <= traffic["sample"]
    eu, ev = np.nonzero(edge)
    every = np.sort(np.mean(np.isfinite(d[:, ev]) & (d[:, eu] + hn[eu, ev] == d[:, ev]), axis=0))
    mid = ((np.arange(strata) + 0.5) * every.size / strata).astype(np.int64)
    for j, sets in enumerate(share.reshape(per, strata)):
        assert np.array_equal(sets, every[mid + j - (per - 1) // 2])
    assert share[0] < 0.05 and share[strata - 1] > 0.5
    again = updates.draw_table(h, graphs.numpy_rng(SEEDS[0], 2), traffic["sample"], strata, per)
    assert np.array_equal(again[0], tu) and np.array_equal(again[1], tv)


def test_table_of_too_few_edges_says_so():
    h = graphs.paper_graph(graphs.torch_generator(SEEDS[0], "cpu"), 8, 8.0, 100)
    with pytest.raises(RuntimeError, match="the table needs"):
        updates.draw_table(h, graphs.numpy_rng(1, 2), 64, 16, 4)


@pytest.mark.parametrize("seed", SEEDS)
def test_every_window_walks_whole_cycles_and_reads_zero(seed):
    result, rec = cell_run(Program(), seed)
    c = rec["counters"]
    steps = rec["steps"]
    cycles, rest = divmod(steps, spec.traffic("updates")["strata"])
    assert result["correct"] is True and cycles > 0 and rest == 0 and result["failed"] == 0
    assert all(ch["value"] == 0 and ch["limit"] == 0 for ch in result["checks"].values())
    assert {"rows_off", "last_bellman_off", "pred_rows_off", "last_pred_off"} == \
        set(result["checks"])
    # the top strata's raises re-solve warm, the others re-close rows; each
    # batch's put-back is a rank-k pass
    warm = c.get("path.warm_resolve+rank_k", 0)
    assert warm >= cycles
    assert c["path.row_resolve+rank_k"] + warm == steps
    assert c["engine.row_resolve"] + c["engine.warm_resolve"] == c["engine.rank_k"] == steps
    assert c["engine.full_resolve"] == 0
    assert c["affected_rows.min"] <= 0.05 * V and c["affected_rows.max"] > 0.5 * V
    assert set(result["metrics"]) == {"update_ms", "setup_s"}
    assert rec["reference_s"] > 0


def test_stale_engine_reads_rows_off():
    for seed in SEEDS:
        result, _ = cell_run(Program(DynamicAPSP=StaleEngine), seed, seconds=1.0)
        assert result["correct"] is False
        assert result["checks"]["rows_off"]["value"] > 0, seed


def test_raises_are_the_mix_and_put_back():
    _, cfg, traffic = small()
    loop = kinds.load("updates")(repro_torch, cfg, traffic, SEEDS[1], "cpu")
    lo, hi = traffic["raise"]
    gap = loop.raised_w - loop.base_w
    assert np.all((gap >= lo) & (gap < hi)) and np.all(gap == np.floor(gap))
    strata = traffic["strata"]
    assert np.all(np.diff(loop.share.reshape(-1, strata), axis=1) >= 0)   # each set by share
    base = loop.h.clone()
    loop.warm()
    loop.step(0)
    # set-up raised the top stratum, then the lowest; window step 0 raises
    # stratum 1, and only its edge is raised in the engine's graph
    want = base.numpy().copy()
    want[loop.tu[1], loop.tv[1]] = loop.raised_w[1]
    assert np.array_equal(loop.eng.h, want)
    assert torch.equal(loop.h, base)
    # its kept rows: the pool's, and sources that its raise affects
    row, src, _, _ = loop.kept[0]
    assert row == 1
    assert set(src[traffic["check_rows_per_step"]:].tolist()) <= \
        set(loop.affected_order[1].tolist())
