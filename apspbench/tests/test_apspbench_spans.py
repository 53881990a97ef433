"""The readers of the program's spans (``frontend.idle_ms.corpus``,
``frontend.ops.corpus``, ``rounds.idle_ms.corpus``, ``rounds.idle_ms.solve``)
on hand-built records, on a traced run of the corpus cell on the CPU, and
on the recorded traces: the midpoint rule, the nesting, the outermost
operators, None without program spans, and the accounting identity (front
end + round loop + outside the program = the traced idle a step).

    python -m pytest -q apspbench/tests
"""

import gzip
import importlib.util
import json
import sys
import time

import pytest

from apspbench import run, spec, trace

sys.path.insert(0, str(spec.ROOT / "src"))
import repro_torch  # noqa: E402

SPAN_READERS = ["frontend.idle_ms.corpus", "frontend.ops.corpus", "rounds.idle_ms.corpus",
                "rounds.idle_ms.solve"]
# Traced runs recorded on an H100 (80GB HBM3, 700 W) with the program's
# spans, the records that ``test_apspbench_parts.py`` reads too:
#     python3 -m apspbench.run --workload <cell> --seed <n> --seconds 51 --trace 1 --record <file>
FIXTURES = spec.HERE / "tests" / "fixtures"


def split_of(tr):
    """The readers' own split of the idle ns by phase."""
    path = spec.HERE / "metrics" / "frontend.idle_ms.corpus.py"
    mod_spec = importlib.util.spec_from_file_location("apspbench_split", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.split(tr)


def spanned_record() -> dict:
    """Two traced steps of 500 ns each, one corpus call in them.

    Gaps, and where their midpoints lie: [20, 180) at 100 in ``bucket``;
    [240, 400) at 320 in ``dispatch``, though it opens outside it;
    [420, 540) at 480 in a ``validate`` nested in ``dispatch``; [560, 940)
    at 750 in ``scatter``, though it opens in ``dispatch``; [960, 1000) at
    980 in the harness's step alone."""
    host = [["apspbench.step", 0, 500], ["apspbench.step", 500, 500],
            ["repro_torch.solve_batch", 10, 900],
            ["repro_torch.validate", 20, 80],
            ["aten::isnan", 25, 10],
            ["aten::sum", 40, 20], ["aten::as_strided", 45, 5],
            ["repro_torch.bucket", 100, 100],
            ["aten::slice", 110, 10], ["aten::as_strided", 112, 3],
            ["aten::to", 250, 10],
            ["repro_torch.dispatch", 300, 400],
            ["aten::empty", 310, 5],
            ["repro_torch.validate", 470, 20], ["aten::isnan", 472, 5],
            ["repro_torch.scatter", 700, 150],
            ["aten::copy_", 720, 10], ["cudaLaunchKernel", 722, 2],
            ["repro_torch.check", 850, 50],
            ["aten::index_select", 950, 10], ["cudaStreamSynchronize", 962, 30]]
    device = [["k", 0, 20], ["k", 180, 60], ["k", 400, 20], ["k", 540, 20], ["k", 940, 20]]
    tr = {"t1": 1000, "steps": 2, "device": device, "host": host}
    return {"steps": 40, "window_s": 1.0, "trace": tr}


def read_all(rec):
    return {name: spec.reader(name)(rec) for name in SPAN_READERS}


def test_midpoint_rule_and_nesting():
    rec = spanned_record()
    tr = rec["trace"]
    assert trace.gaps(tr) == [(20, 180), (240, 400), (420, 540), (560, 940), (960, 1000)]
    assert split_of(tr) == {"front": 160 + 380, "rounds": 160 + 120, "outside": 40}
    r = read_all(rec)
    assert r["frontend.idle_ms.corpus"] == pytest.approx(540e-6 / 2)
    assert r["rounds.idle_ms.corpus"] == pytest.approx(280e-6 / 2)
    assert r["rounds.idle_ms.solve"] == r["rounds.idle_ms.corpus"]


def test_a_gap_in_the_step_alone_goes_to_neither():
    rec = spanned_record()
    tr = rec["trace"]
    # a device operation that closes every gap but the harness's last one
    tr["device"] = [["k", 0, 960]]
    assert split_of(tr) == {"front": 0, "rounds": 0, "outside": 40}
    r = read_all(rec)
    assert r["frontend.idle_ms.corpus"] == 0 and r["rounds.idle_ms.corpus"] == 0


def test_outermost_operators_in_the_front_end():
    # isnan, sum, slice (its as_strided inside), the stray to in
    # solve_batch, copy_; not the dispatch's empty, the validate inside
    # dispatch, nor the harness's index_select
    assert spec.reader("frontend.ops.corpus")(spanned_record()) == 5 / 2


def test_none_without_program_spans():
    rec = spanned_record()
    rec["trace"]["host"] = [e for e in rec["trace"]["host"] if not e[0].startswith("repro_torch.")]
    assert read_all(rec) == dict.fromkeys(SPAN_READERS)
    rec["trace"] = None
    assert read_all(rec) == dict.fromkeys(SPAN_READERS)


def idle_ms_a_step(tr):
    return trace.idle_share(tr) / 100 * trace.window_s(tr) * 1e3 / tr["steps"]


def assert_identity(tr, tol_ms):
    ns = split_of(tr)
    parts = (ns["front"] + ns["rounds"] + ns["outside"]) / 1e6 / tr["steps"]
    assert abs(parts - idle_ms_a_step(tr)) <= tol_ms


def test_accounting_identity():
    assert_identity(spanned_record()["trace"], 1e-6)       # 1e-9 s


def test_traced_corpus_run_on_the_cpu():
    """A traced run of the corpus cell on the CPU keeps the program's spans
    in its record: the operator count is there and the same on another
    seed (the sizes are the same for every seed); the CPU has no device
    trace, so the idle readers give nothing."""
    bench = spec.load()
    wl = spec.cell(bench, "corpus.blocked")
    cfg = dict(spec.config(bench, wl["config"]), n_graphs=10, v_min=4, v_max=24)
    traffic = spec.traffic(wl["traffic"])
    counts = []
    for seed in (2 ** 31 + 7, 11):
        result, rec = run.run_cell(repro_torch, bench, "corpus.blocked", cfg, traffic, seed,
                                   0.3, True, "cpu", time.perf_counter())
        assert result["correct"] is True
        names = {e[0] for e in rec["trace"]["host"]}
        assert {"repro_torch.solve_batch", "repro_torch.scatter"} <= names
        counts.append(result["metrics"]["frontend.ops.corpus"]["value"])
        assert "frontend.idle_ms.corpus" not in result["metrics"]
    assert counts[0] == counts[1] > 0


def spanned_fixture(cell: str) -> dict:
    with gzip.open(FIXTURES / f"{cell}.record.json.gz", "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["gen32k.solve", "corpus.blocked", "gen32k.pred"])
def test_identity_on_recorded_traces(cell):
    tr = spanned_fixture(cell)["record"]["trace"]
    assert split_of(tr) is not None
    assert_identity(tr, 1e-6)

