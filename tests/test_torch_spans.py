"""The program's spans (``repro_torch._spans``) on the CPU: with no
profiler running a span is the shared no-op and records nothing; under
``torch.profiler`` the front end's calls emit their ``repro_torch.*``
phases nested by interval, once a phase (one a bucket, never one a
graph), and the answers stay bit-equal to an unprofiled call."""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch import _spans
from repro_torch.core import InputValidationError, generate_np

RAGGED = [3, 9, 17, 33]                 # four buckets: edges 8, 16, 32, 64


@pytest.fixture(autouse=True)
def _own_autotune_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


def _corpus(sizes=RAGGED, seed=0):
    rng = np.random.default_rng(seed)
    return [generate_np(rng, n).h for n in sizes]


def _stack(mats):
    n = max(m.shape[0] for m in mats)
    out = np.full((len(mats), n, n), np.inf, np.float32)
    for i, m in enumerate(mats):
        k = m.shape[0]
        out[i, :k, :k] = m
        out[i, range(k, n), range(k, n)] = 0.0
    return torch.from_numpy(out), np.array([m.shape[0] for m in mats])


def _spans_of(prof):
    """``(phase, start_ns, end_ns)`` of every ``repro_torch.*`` range."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro_torch."):
            s = e.start_ns()
            out.append((e.name()[len("repro_torch."):], s, s + e.duration_ns()))
    return sorted(out, key=lambda x: (x[1], -x[2]))


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2] and child is not parent


def _parent(sp, every):
    """The innermost span that encloses ``sp``."""
    around = [p for p in every if _inside(sp, p)]
    return min(around, key=lambda p: p[2] - p[1])[0] if around else None


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans_of(prof)


def test_no_profiler_no_range(monkeypatch):
    """Off the profiler, a span is the one shared no-op: neither the fast
    range nor ``record_function`` is entered by any entry point."""
    entered = collections.Counter()

    def counting(name, *a, **kw):
        entered[name] += 1
        return contextlib.nullcontext()

    monkeypatch.setattr(_spans, "_range", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    assert not torch._C._autograd._profiler_enabled()
    assert _spans.span("repro_torch.solve") is _spans._NOOP
    assert _spans.span("repro_torch.pad") is _spans.span("repro_torch.scatter")
    mats = _corpus()
    repro_torch.solve(mats[-1], device="cpu")
    repro_torch.solve_batch(mats, bucket_by_size=True, device="cpu")
    repro_torch.solve_batch(*_stack(mats), device="cpu")
    assert sum(entered.values()) == 0


def test_under_the_profiler_a_span_is_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _spans.span("repro_torch.probe") as ctx:
            pass
    assert ctx is not _spans._NOOP
    assert [s[0] for s in _spans_of(prof)] == ["probe"]


@pytest.mark.parametrize("form", ["ragged list", "padded stack"])
def test_bucketed_corpus_spans(form):
    mats = _corpus()
    args = (mats,) if form == "ragged list" else _stack(mats)

    def run():
        return repro_torch.solve_batch(*args, bucket_by_size=True, device="cpu")

    want = run()
    got, spans = _profiled(run)
    assert np.array_equal(got.dist.numpy(), want.dist.numpy())
    assert np.array_equal(got.sizes, want.sizes)
    count = collections.Counter(s[0] for s in spans)
    buckets = len(RAGGED)
    assert count == {"solve_batch": 1, "validate": 1, "bucket": 1, "check": 1,
                     "pad": buckets, "dispatch": buckets, "scatter": buckets}
    assert sum(count.values()) == 4 + 3 * buckets
    for sp in spans:
        if sp[0] != "solve_batch":
            assert _parent(sp, spans) == "solve_batch", sp
    # the phases follow one another: validate, bucket, (pad, dispatch,
    # scatter) a bucket, check
    order = [s[0] for s in spans if s[0] != "solve_batch"]
    assert order == ["validate", "bucket"] + ["pad", "dispatch", "scatter"] * buckets + ["check"]


def test_single_stack_spans():
    mats = _corpus()

    def run():
        return repro_torch.solve_batch(mats, device="cpu", with_pred=True)

    want = run()
    got, spans = _profiled(run)
    assert np.array_equal(got.dist.numpy(), want.dist.numpy())
    assert np.array_equal(got.pred.numpy(), want.pred.numpy())
    assert [s[0] for s in spans] == ["solve_batch", "validate", "pad", "dispatch", "check"]
    assert all(_parent(sp, spans) == "solve_batch" for sp in spans[1:])


@pytest.mark.parametrize("method", ["blocked_fw", "squaring", "rkleene"])
def test_solve_spans(method):
    h = _corpus([40], seed=3)[0]

    def run():
        return repro_torch.solve(h, method=method, with_pred=True, device="cpu")

    want = run()
    got, spans = _profiled(run)
    assert np.array_equal(got.dist.numpy(), want.dist.numpy())
    assert np.array_equal(got.pred.numpy(), want.pred.numpy())
    assert [s[0] for s in spans] == ["solve", "validate", "dispatch", "check"]
    assert all(_parent(sp, spans) == "solve" for sp in spans[1:])


def test_span_closes_on_a_raise():
    bad = _corpus([9])[0].copy()
    bad[1, 2] = np.nan
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(InputValidationError):
            repro_torch.solve_batch([bad, bad], bucket_by_size=True, device="cpu")
    spans = _spans_of(prof)
    assert [s[0] for s in spans] == ["solve_batch", "validate"]
    assert _inside(spans[1], spans[0])
