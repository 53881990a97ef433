"""The benchmark's frozen parts on the CPU: the generator's recipe, the
inputs of the ``solve`` and ``corpus`` kinds fingerprinted, the plain
reference against a brute-force closure, the peak and the work count,
every metric reader on recorded traces, and ``BENCHMARK.json`` against the
files it names.

    python -m pytest -q apspbench/tests
"""

import gzip
import hashlib
import json
import math
import re

import numpy as np
import pytest
import torch

from apspbench import graphs, kinds, peaks, reference, spec, trace
from apspbench.tests.test_apspbench_spans import SPAN_READERS

FIXTURES = spec.HERE / "tests" / "fixtures"
INF = float("inf")


def brute_closure(h: np.ndarray) -> np.ndarray:
    """Floyd-Warshall, one pivot at a time, in float64."""
    d = h.astype(np.float64).copy()
    for k in range(d.shape[0]):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return d


def small_graph(seed: int, n: int = 40, rho: float = 8.0, alpha: int = 50) -> torch.Tensor:
    return graphs.paper_graph(graphs.torch_generator(seed, "cpu"), n, rho, alpha)


# -- generator ---------------------------------------------------------------

def test_paper_graph_recipe():
    n, rho, alpha = 512, 20.0, 10000
    h = small_graph(7, n, rho, alpha)
    assert h.dtype == torch.float32 and h.shape == (n, n)
    assert torch.all(torch.diagonal(h) == 0)
    off = h[~torch.eye(n, dtype=torch.bool)]
    edges = off[torch.isfinite(off)]
    assert torch.all(edges == edges.floor()) and edges.min() >= 1 and edges.max() <= alpha
    # edge probability rho / 100 * U[0, 1): density rho / 200 on average
    density = edges.numel() / (n * (n - 1))
    assert abs(density - rho / 200) < 0.01
    # costs uniform over [1, alpha]: mean (alpha + 1) / 2
    assert abs(float(edges.mean()) - (alpha + 1) / 2) < 0.03 * alpha
    assert torch.equal(h, small_graph(7, n, rho, alpha))
    assert not torch.equal(h, small_graph(8, n, rho, alpha))


def test_seed_streams_and_large_seeds():
    big = 2 ** 31 + 12345
    a = graphs.torch_generator(big, "cpu")
    b = graphs.torch_generator(big, "cpu", stream=1)
    assert not torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    assert graphs.numpy_rng(big).integers(0, 1 << 30) == graphs.numpy_rng(big).integers(0, 1 << 30)
    graphs.torch_generator(-5, "cpu")       # any whole number
    graphs.numpy_rng(-5)


def test_corpus_recipe():
    g, v_min, v_max = 24, 4, 40
    stack, sizes = graphs.corpus(graphs.torch_generator(3, "cpu"), g, v_min, v_max, 100.0, 100,
                                 chunk=5)
    assert stack.shape == (g, v_max, v_max)
    # the same set of sizes for every seed, in another order
    want = graphs.size_grid(g, v_min, v_max)
    assert sorted(sizes) == sorted(want) and want.min() == v_min and want.max() == v_max
    _, other = graphs.corpus(graphs.torch_generator(4, "cpu"), g, v_min, v_max, 100.0, 100)
    assert sorted(other) == sorted(sizes) and list(other) != list(sizes)
    eye = torch.eye(v_max, dtype=torch.bool)
    for i, k in enumerate(sizes):
        h = stack[i]
        assert torch.all(torch.diagonal(h) == 0)
        pad = torch.ones(v_max, v_max, dtype=torch.bool)
        pad[:k, :k] = False
        assert torch.all(torch.isinf(h[pad & ~eye]))        # inert padding
        block = h[:k, :k][~eye[:k, :k]]
        fin = block[torch.isfinite(block)]
        assert torch.all(fin == fin.floor()) and (fin.numel() == 0 or fin.max() <= 100)


def digest(*arrays) -> str:
    """sha256 of the arrays' dtypes, shapes and bytes."""
    m = hashlib.sha256()
    for a in arrays:
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        m.update(str(a.dtype).encode())
        m.update(str(a.shape).encode())
        m.update(np.ascontiguousarray(a).tobytes())
    return m.hexdigest()


# (graph or corpus, sources and picks) of each kind's inputs at a small size,
# as the traffic kinds made them before they were files of their own
FINGERPRINTS = {
    (2 ** 31 + 99, "solve"): ("d60824f3ac9381975b3230ed7598fb09a309037d5d29b79407e9595d821167fe",
                              "e4b39dc661466cc6eedff5a33be1479a6e8dea216362eef0501d0d418ca48032"),
    (2 ** 31 + 99, "pred"): ("d60824f3ac9381975b3230ed7598fb09a309037d5d29b79407e9595d821167fe",
                             "e4b39dc661466cc6eedff5a33be1479a6e8dea216362eef0501d0d418ca48032"),
    (2 ** 31 + 99, "blocked"): ("9e099fe6c43979acc0a86af69f21cb08a47297244c229aeba1fa54f46cb72862",
                                "5c6c79c0f89b6092176272d873a8e2bd7c4cc8fca1d9bf725df38a8752ee3438"),
    (7, "solve"): ("655e93faaf57699fc605aa495b9630462c3fbdbd3673ce5272ab483d22815c7e",
                   "4277adaea4eafb736bc034bf43345d55ba7c5917a0f4ddf08e0da357664a9dff"),
    (7, "pred"): ("655e93faaf57699fc605aa495b9630462c3fbdbd3673ce5272ab483d22815c7e",
                  "4277adaea4eafb736bc034bf43345d55ba7c5917a0f4ddf08e0da357664a9dff"),
    (7, "blocked"): ("894b37d292ba0939c1a663cd53a6e356f03590d4aab4abe75671fdf7fc212816",
                     "bc06f58d1ec22657d7bc2c6ea307ed336afb02288fdb3d17766af94b2b2c34cb"),
}


@pytest.mark.parametrize("seed,mix", sorted(FINGERPRINTS), ids=lambda x: str(x))
def test_kind_inputs_are_unchanged(seed, mix):
    """The ``solve`` and ``corpus`` kinds make bit for bit the inputs, check
    sources and picks they made as classes of one module: a cell keeps its
    inputs for a given seed when its kind moves."""
    bench = spec.load()
    traffic = spec.traffic(mix)
    loop_cls = kinds.load(traffic["kind"])
    if traffic["kind"] == "solve":
        cfg = dict(spec.config(bench, "gen32k"), V=96, rho=6.0)
        loop = loop_cls(None, cfg, traffic, seed, "cpu")
        got = (digest(loop.h), digest(loop.sources, loop.picks))
    else:
        cfg = dict(spec.config(bench, "paper-corpus"), n_graphs=12, v_min=4, v_max=24)
        loop = loop_cls(None, cfg, traffic, seed, "cpu")
        got = (digest(loop.stack, loop.sizes), digest(loop.pool_g, loop.pool_s, loop.picks))
    assert got == FINGERPRINTS[(seed, mix)]


# -- the plain reference -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_rows_equal_brute_closure(seed):
    h = small_graph(seed, 48, rho=6.0)          # sparse: some pairs unreachable
    want = brute_closure(h.numpy())
    assert np.isinf(want).any()
    src = torch.tensor([0, 5, 17, 47])
    got = reference.sssp_rows(h, src)
    assert np.array_equal(got.numpy(), want[src.numpy()].astype(np.float32))


def test_bellman_and_pred_checks():
    h = small_graph(3, 40, rho=10.0)
    d = torch.from_numpy(brute_closure(h.numpy()).astype(np.float32))
    assert reference.bellman_off(d, h) == 0
    assert reference.bellman_off(d[5:9], h, rows=torch.arange(5, 9)) == 0
    n = h.shape[0]
    reach = torch.nonzero(torch.isfinite(d) & ~torch.eye(n, dtype=torch.bool))
    (a, b), (c, e) = reach[0].tolist(), reach[-1].tolist()
    for i, j, delta in [(a, b, 1.0), (4, 4, 1.0), (c, e, -1.0)]:
        bad = d.clone()
        bad[i, j] += delta
        assert reference.bellman_off(bad, h) > 0
    assert reference.bellman_off(h.clone(), h) > 0          # a solve that returned its input
    # a witnessing predecessor for every reachable pair, from the brute closure
    hn, dn = h.numpy(), d.numpy()
    pred = np.full((n, n), -1, np.int32)
    for i in range(n):
        for j in range(n):
            if i == j:
                pred[i, j] = i
            elif np.isfinite(dn[i, j]):
                pred[i, j] = next(p for p in range(n) if p != j and dn[i, p] + hn[p, j] == dn[i, j])
    p = torch.from_numpy(pred)
    assert reference.pred_off(d, p, h) == 0
    assert reference.pred_off(d[3:6], p[3:6], h, rows=torch.arange(3, 6)) == 0
    broken = p.clone()
    reach = torch.nonzero(torch.isfinite(d) & ~torch.eye(n, dtype=torch.bool))[0]
    broken[reach[0], reach[1]] = (broken[reach[0], reach[1]] + 1) % n
    assert reference.pred_off(d, broken, h) > 0


def test_relax_blocks_agree(monkeypatch):
    h = small_graph(4, 40, rho=20.0)
    d = torch.from_numpy(brute_closure(h.numpy()).astype(np.float32))
    K, W = reference.in_edges(h)
    whole = reference.relax(d, K, W)
    monkeypatch.setattr(reference.apsp, "BLOCK_ELEMS", K.numel() * 3)   # three rows a block
    assert torch.equal(reference.relax(d, K, W), whole)


# -- the yardstick -----------------------------------------------------------

def test_peak_and_work():
    assert peaks.CANDIDATES_PER_S == 132 * 128 * 1980e6
    assert math.isclose(peaks.CANDIDATES_PER_S, 3.345e13, rel_tol=1e-3)
    assert peaks.solve_work(32768) == 32768 ** 3
    assert peaks.corpus_work([4, 10, 1000]) == 64 + 1000 + 10 ** 9


# -- the metric readers ------------------------------------------------------

def synthetic_record() -> dict:
    """A traced stretch of 50 ns with known busy time, gaps and labels."""
    tr = {"t1": 50, "steps": 2,
          "device": [["void repro_torch::fw_update<0, float>(...)", 0, 10],
                     ["void at::native::copy(...)", 5, 10],
                     ["Memcpy HtoD (Pageable -> Device)", 30, 10]],
          "host": [["apspbench.step", 0, 50], ["aten::copy_", 16, 10]]}
    return {"setup_s": 9.5, "window_s": 2.0, "steps": 4, "items_per_step": 1000,
            "step_ms": [5.0, 50.0, 6.0, 7.0],
            "counters": {"fw_round": 8, "minplus": 4}, "work_per_step": 10 ** 12,
            "peak_candidates_per_s": peaks.CANDIDATES_PER_S, "trace": tr}


def test_trace_arithmetic_on_a_known_stretch():
    rec = synthetic_record()
    tr = rec["trace"]
    assert trace.busy_s(tr) == 25e-9 and trace.window_s(tr) == 50e-9
    assert trace.idle_share(tr) == pytest.approx(50.0)
    assert trace.gaps(tr) == [(15, 30), (40, 50)]
    assert trace.idle_by_host(tr) == pytest.approx({"aten::copy_": 15e-9, "apspbench.step": 10e-9})
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["void repro_torch::fw_update<0, float>(...)", 10e-9]
    assert len(b["device_ops"]) == 3 and len(b["idle_gaps"]) == 2


def test_readers_on_a_known_record():
    rec = synthetic_record()
    r = {name: spec.reader(name)(rec) for name in
         ["setup_s", "solve_ms", "graphs_per_s", "launches.solve", "device.idle.solve",
          "kernels_roofline.solve", "frontend.torch_ms.corpus"]}
    assert r["setup_s"] == 9.5
    assert r["solve_ms"] == 500.0
    assert r["graphs_per_s"] == 2000.0
    assert r["launches.solve"] == 3.0
    assert r["device.idle.solve"] == pytest.approx(50.0)
    assert r["kernels_roofline.solve"] == pytest.approx(
        100 * 2 * 10 ** 12 / (peaks.CANDIDATES_PER_S * 25e-9))
    assert r["frontend.torch_ms.corpus"] == pytest.approx(20e-6 / 2)
    assert spec.reader("passes.updates")(rec) is None        # no engine counts recorded
    assert spec.reader("warm_resolve_ms.updates")(rec) is None
    rec["counters"].update({"engine.row_iters": 7, "engine.warm_iters": 3,
                            "engine.rank_k_passes": 6, "path.row_resolve+rank_k": 3,
                            "path.warm_resolve+rank_k": 1, "path_ms.row_resolve+rank_k": 300.0,
                            "path_ms.warm_resolve+rank_k": 900.0, "affected_rows.sum": 400})
    u = {name: spec.reader(name)(rec) for name in
         ["update_ms", "launches.updates", "passes.updates", "h2d_ms.updates",
          "device.idle.updates", "row_resolve_ms.updates", "warm_resolve_ms.updates"]}
    assert u["update_ms"] == 500.0
    assert u["launches.updates"] == 3.0        # the loop's own counts are no launches
    assert u["passes.updates"] == 4.0
    assert u["row_resolve_ms.updates"] == 100.0
    assert u["warm_resolve_ms.updates"] == 900.0
    assert u["h2d_ms.updates"] == pytest.approx(10e-6 / 2)
    assert u["device.idle.updates"] == pytest.approx(50.0)
    rec["trace"] = None
    for name in ["device.idle.corpus", "kernels_roofline.corpus", "frontend.torch_ms.corpus",
                 "h2d_ms.updates", "device.idle.updates"]:
        assert spec.reader(name)(rec) is None
    rec["counters"] = {"fw_round": 0}
    assert spec.reader("launches.corpus")(rec) is None


def fixture(cell: str) -> dict:
    with gzip.open(FIXTURES / f"{cell}.record.json.gz", "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["gen32k.solve", "corpus.blocked", "gen32k.pred",
                                  "gen32k.updates"])
def test_readers_on_recorded_traces(cell):
    """Records of traced runs on an H100 (80GB HBM3, 700 W), made with
    ``python3 -m apspbench.run ... --trace 1 --record <file>``: every
    per-layer reader gives back what the run printed."""
    fx = fixture(cell)
    rec, printed = fx["record"], fx["printed"]
    bench = spec.load()
    names = [m["name"] for m in spec.metrics(bench, cell, per_layer=True)]
    assert names and sorted(names) == sorted(printed["metrics"])
    if cell != "gen32k.updates":
        # the engine has no program span yet; the other cells read theirs
        assert set(SPAN_READERS) & set(names)
    for name in names:
        assert spec.reader(name)(rec) == printed["metrics"][name]["value"], name
    assert trace.busy_s(rec["trace"]) == printed["device"]["busy_s"]
    assert trace.window_s(rec["trace"]) == printed["device"]["window_s"]
    for m in spec.metrics(bench, cell, per_layer=True):
        if m["unit"] == "%":
            assert 0 <= spec.reader(m["name"])(rec) <= 100
    if printed["breakdown"] is not None:
        assert trace.breakdown(rec["trace"]) == printed["breakdown"]


# -- BENCHMARK.json ----------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_resolves_to_files():
    bench = spec.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["apspbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("apspbench/") and (spec.ROOT / c["file"]).is_file()
        cfg = spec.config(bench, c["name"])
        assert cfg["source"] and cfg["reduced"] == c["reduced"] and "assumed" in cfg
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert callable(spec.reader(m["name"]))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    cfgs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in cfgs and w["chips"] == 1 and len(w["why"]) <= 200
        t = spec.traffic(w["traffic"])
        assert (spec.HERE / "kinds" / f"{t['kind']}.py").is_file()
        assert callable(kinds.load(t["kind"]))
        ends = [m for m in spec.metrics(bench, w["name"], per_layer=False)]
        assert any(m["name"] == "setup_s" for m in ends) and len(ends) >= 2
        assert spec.metrics(bench, w["name"], per_layer=True)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])
    assert len(json.dumps(bench).encode()) <= 64 * 1024
