"""The port's CUDA kernels (fw_round, minplus, minplus_argmin,
minplus_pred, fw_block, fw_block_pred, row_close) against their plain
PyTorch versions, and the dynamic engine, the five solve methods and
``solve_batch`` on the card against the same calls on the CPU.  Marked ``cuda``: every test skips, with its reason, on a host without
a CUDA device.  Run them on the GPU host with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerance: exact (``torch.equal`` with NaN in the same places).  ⊕ is
selective and each candidate is one rounded operation, so the kernel and
the plain version give the same bits.
"""

import importlib

import numpy as np
import pytest
import torch

from oracle import generate

import repro_torch
from repro_torch.core import DynamicAPSP, Semiring, generate_edge_updates, generate_np, init_pred, solve
from repro_torch.core.semiring import TROPICAL, get_semiring
from repro_torch.kernels import ops

# The kernel submodules by module path: ``repro_torch.kernels.fw_block``,
# ``.fw_round`` and ``.minplus`` are the ops functions, as in repro.kernels.
fb = importlib.import_module("repro_torch.kernels.fw_block")
fr = importlib.import_module("repro_torch.kernels.fw_round")
mp = importlib.import_module("repro_torch.kernels.minplus")
rc = importlib.import_module("repro_torch.kernels.row_close")

pytestmark = pytest.mark.cuda

# Tile sizes that exercise the cluster closure's layout (csrc/fw_closure.cuh,
# 8 CTAs a tile): B < 8, B not a multiple of 8, one row a CTA, full width.
CLOSURE_B = [1, 5, 8, 9, 31, 32, 33, 100, 255, 256]
# Tile sizes of the grid closure (above 256 nodes): just above the cluster
# closure, not a multiple of 4 or of the CTA's 512 threads, and the
# reference's own cells' B = 512 and 1024.
LARGE_B = [257, 300, 511, 512, 1000, 1024]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))


def _round_pair(d, o, b, semiring):
    before = fr.rounds
    got = fr.fw_round_cuda(d.clone(), o, block_size=b, semiring=semiring)
    assert fr.rounds == before + 1
    want = fr.fw_round_torch(d, o, block_size=b, semiring=semiring)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("semiring", ["tropical", "bottleneck", "reliability", "boolean"])
@pytest.mark.parametrize("b", [64, 256])
def test_kernel_matches_plain(cuda, semiring, b):
    n = 1024
    h = torch.from_numpy(generate(np.random.default_rng(b), n, semiring)).to(cuda)
    got, want = _round_pair(h, b * (n // b // 2), b, semiring)
    assert _same(got, want)


@pytest.mark.parametrize("n,b", [(7, 7), (19, 19), (100, 50), (384, 128)]
                         + [(2 * b, b) for b in CLOSURE_B])
def test_kernel_matches_plain_ragged_tiles(cuda, n, b):
    h = torch.from_numpy(generate_np(np.random.default_rng(n), n).h).to(cuda)
    for o in range(0, n, b):
        got, want = _round_pair(h, o, b, "tropical")
        assert _same(got, want), o


def test_kernel_matches_plain_batched(cuda):
    rng = np.random.default_rng(4)
    hs = np.stack([generate_np(rng, 512).h for _ in range(4)])
    got, want = _round_pair(torch.from_numpy(hs).to(cuda), 256, 256, "tropical")
    assert _same(got, want)


def test_kernel_matches_plain_bf16(cuda):
    h = torch.from_numpy(generate_np(np.random.default_rng(3), 1024).h).to(cuda)
    got, want = _round_pair(h.to(torch.bfloat16), 512, 256, "tropical")
    assert got.dtype == torch.bfloat16 and _same(got.float(), want.float())


def test_kernel_propagates_nan(cuda):
    h = generate_np(np.random.default_rng(5), 64).h
    h[3, 40] = np.nan
    h[35, 2] = np.nan
    d = torch.from_numpy(h).to(cuda)
    for o in (0, 32):
        got, want = _round_pair(d, o, 32, "tropical")
        assert torch.isnan(want).any() and _same(got, want), o


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    d = torch.zeros((64, 64), device=cuda)
    with pytest.raises(ValueError):
        fr.fw_round_cuda(d, 0, block_size=48, semiring="tropical")
    with pytest.raises(ValueError):
        fr.fw_round_cuda(d.t(), 0, block_size=32, semiring="tropical")
    with pytest.raises(TypeError):
        fr.fw_round_cuda(d.double(), 0, block_size=32, semiring="tropical")
    custom = Semiring(
        name="custom", add=torch.minimum, mul=torch.add, zero=float("inf"),
        one=0.0, reduce=torch.amin, argreduce=torch.argmin,
        better=TROPICAL.better,
    )
    with pytest.raises(NotImplementedError):
        fr.fw_round_cuda(d, 0, block_size=32, semiring=custom)



@pytest.mark.parametrize("b", [5, 33, 100, 256])
def test_fused_round_closure_matches_plain_batched_and_bf16(cuda, b):
    """fw_closure on a G = 3 stack of clusters, and with bf16 storage."""
    rng = np.random.default_rng(b)
    hs = torch.from_numpy(np.stack([generate(rng, 2 * b, "bottleneck") for _ in range(3)])).to(cuda)
    got, want = _round_pair(hs, b, b, "bottleneck")
    assert _same(got, want)
    h = torch.from_numpy(generate_np(rng, 2 * b).h).to(cuda)
    got, want = _round_pair(h.to(torch.bfloat16), b, b, "tropical")
    assert got.dtype == torch.bfloat16 and _same(got.float(), want.float())


@pytest.mark.parametrize("b", [9, 100, 255])
def test_cluster_closures_negative_cycle_and_nan(cuda, b):
    """A tropical negative cycle (step k rewrites row and column k, so every
    step must read the old ones) and NaN, on a tile that is not a multiple
    of the cluster."""
    h = generate_np(np.random.default_rng(b), b, rho=30.0).h
    h[2, 7], h[7, 2] = -9.0, 3.0
    h[b - 2, b - 1] = np.nan
    d = torch.from_numpy(h).to(cuda)
    p = torch.arange(b, dtype=torch.int32, device=cuda).repeat(b, 1).t().contiguous()
    got = fb.fw_block_pred_cuda(d, p)
    want = fb.fw_block_pred_torch(d, p)
    torch.cuda.synchronize()
    assert bool((torch.diagonal(want[0]) < 0).any())
    assert _same(got[0], want[0]) and torch.equal(got[1], want[1])
    got = fb.fw_block_cuda(d)
    torch.cuda.synchronize()
    assert _same(got, fb.fw_block_torch(d))


@pytest.mark.parametrize("b", [5, 100, 256])
def test_closures_run_on_the_plans_cluster(cuda, b):
    """Each closure records the cluster size the hardware gave its launch
    (%cluster_nctarank); reading it back gives the plan's cluster, and
    reading sets it to 0."""
    import ctypes

    from repro_torch.kernels import _build

    fb_seen = _build.load("fw_block").fw_block_cluster_ctas
    fb_seen.argtypes = [ctypes.c_int]
    fr_seen = _build.load("fw_round").fw_round_cluster_ctas
    d = torch.from_numpy(generate(np.random.default_rng(b), 2 * b, "tropical")).to(cuda)
    p = init_pred(d[:b, :b]).contiguous()
    fr.fw_round_cuda(d, 0, block_size=b)
    fb.fw_block_cuda(d[:b, :b].contiguous())
    fb.fw_block_pred_cuda(d[:b, :b].contiguous(), p)
    torch.cuda.synchronize()
    want = fb.closure_plan(b).cluster
    assert (fr_seen(), fb_seen(0), fb_seen(1)) == (want, want, want)
    assert (fr_seen(), fb_seen(0), fb_seen(1)) == (0, 0, 0)


def test_solve_on_card_at_8191_matches_plain_solve(cuda):
    """N = 8191 pads to 8192: the main path against the plain rounds on the card."""
    from repro_torch.core.semiring import pad_to_multiple, unpad

    n, b = 8191, 256
    h = generate_np(np.random.default_rng(0), n, rho=2.0).h
    before = fr.rounds
    got = solve(h).dist
    assert fr.rounds - before == 32
    d = pad_to_multiple(torch.from_numpy(h).to(cuda), b)
    for o in range(0, d.shape[0], b):
        d = fr.fw_round_torch(d, o, block_size=b, semiring="tropical")
    assert torch.equal(got, unpad(d, n))


@pytest.mark.parametrize("n", [1, 100, 384])
def test_solve_on_card_matches_cpu(cuda, n):
    h = generate_np(np.random.default_rng(n), n).h
    before = fr.rounds
    got = solve(h).dist
    assert got.is_cuda and fr.rounds - before == -(-n // min(256, n))
    assert torch.equal(got.cpu(), solve(h, device="cpu").dist)


ZERO = {"tropical": np.inf, "bottleneck": -np.inf, "reliability": 0.0, "boolean": 0.0}
SEMIRINGS = ["tropical", "bottleneck", "reliability", "boolean"]


def _mat(rng, shape, semiring, ties=False, density=0.6):
    if semiring == "boolean":
        vals = np.ones(shape)
    elif semiring == "reliability":
        vals = rng.choice([0.25, 0.5, 1.0], size=shape) if ties else rng.uniform(0.05, 0.999, size=shape)
    else:
        vals = rng.integers(1, 4, size=shape) if ties else rng.uniform(1, 100, size=shape)
    out = np.where(rng.uniform(size=shape) < density, vals, ZERO[semiring])
    return torch.from_numpy(out.astype(np.float32))


def _product_pair(kind, x, y, a, semiring):
    cuda_fn, plain_fn = ((mp.minplus_cuda, mp.minplus_torch) if kind == "minplus"
                         else (mp.minplus_argmin_cuda, mp.minplus_argmin_torch))
    before = mp.launches[kind]
    got = cuda_fn(x, y, a, semiring=semiring)
    assert mp.launches[kind] == before + 1
    want = plain_fn(x, y, a, semiring=semiring)
    torch.cuda.synchronize()
    if kind == "minplus":
        return _same(got, want)
    return _same(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["minplus", "minplus_argmin"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_minplus_kernels_match_plain(cuda, kind, semiring, acc, ties):
    rng = np.random.default_rng(acc + 2 * ties)
    m, k, n = 1000, 300, 777
    x, y = _mat(rng, (m, k), semiring, ties).to(cuda), _mat(rng, (k, n), semiring, ties).to(cuda)
    a = _mat(rng, (m, n), semiring, ties, 0.3).to(cuda) if acc else None
    assert _product_pair(kind, x, y, a, semiring)


@pytest.mark.parametrize("kind", ["minplus", "minplus_argmin"])
def test_minplus_kernels_match_plain_batched_and_nan(cuda, kind):
    rng = np.random.default_rng(7)
    x, y = _mat(rng, (4, 130, 70), "tropical").to(cuda), _mat(rng, (4, 70, 200), "tropical").to(cuda)
    a = _mat(rng, (4, 130, 200), "tropical", density=0.3).to(cuda)
    assert _product_pair(kind, x, y, a, "tropical")
    x[1, 5, :] = float("nan")
    x[2, 7, 3] = float("nan")
    a[3, 0, 0] = float("nan")
    assert _product_pair(kind, x, y, a, "tropical")
    assert _product_pair(kind, x, y, None, "bottleneck")


@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("b,t", [(256, 1), (100, 3), (7, 2)] + [
    (b, 1 + 2 * (i % 2)) for i, b in enumerate(CLOSURE_B) if b not in (100, 256)])
def test_fw_block_kernels_match_plain(cuda, pred, semiring, b, t):
    rng = np.random.default_rng(b + t)
    d = torch.stack([torch.from_numpy(generate(rng, b, semiring)) for _ in range(t)]).to(cuda)
    p = torch.randint(-1, 5000, d.shape, dtype=torch.int32, device=cuda)
    if pred:
        before = fb.launches["fw_block_pred"]
        got = fb.fw_block_pred_cuda(d, p, semiring=semiring)
        assert fb.launches["fw_block_pred"] == before + 1
        want = fb.fw_block_pred_torch(d, p, semiring=semiring)
        torch.cuda.synchronize()
        assert _same(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        before = fb.launches["fw_block"]
        got = fb.fw_block_cuda(d, semiring=semiring)
        assert fb.launches["fw_block"] == before + 1
        torch.cuda.synchronize()
        assert _same(got, fb.fw_block_torch(d, semiring=semiring))


def test_fw_block_pred_negative_cycle_and_nan(cuda):
    h = generate_np(np.random.default_rng(2), 256).h
    h[2, 7], h[7, 2] = -9.0, 3.0
    h[40, 41] = np.nan
    d = torch.from_numpy(h).to(cuda)
    p = torch.arange(256, dtype=torch.int32, device=cuda).repeat(256, 1).t().contiguous()
    got = fb.fw_block_pred_cuda(d, p)
    want = fb.fw_block_pred_torch(d, p)
    torch.cuda.synchronize()
    assert bool((torch.diagonal(want[0]) < 0).any())
    assert _same(got[0], want[0]) and torch.equal(got[1], want[1])


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((64, 32), device=cuda)
    with pytest.raises(ValueError):
        mp.minplus_cuda(x, x)
    with pytest.raises(TypeError):
        mp.minplus_argmin_cuda(x.bfloat16(), x.t().contiguous().bfloat16())
    with pytest.raises(ValueError):
        mp.minplus_cuda(x, x.t())
    with pytest.raises(ValueError):
        fb.fw_block_cuda(torch.zeros((300, 299), device=cuda))
    with pytest.raises(ValueError):
        fb.fw_block_pred_cuda(torch.zeros((8, 8), device=cuda), torch.zeros((8, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        fb.fw_block_cuda(torch.zeros((0, 0), device=cuda))


@pytest.mark.parametrize("options", [
    {"with_pred": True}, {"round_mode": "split"}, {"round_mode": "split", "with_pred": True}])
@pytest.mark.parametrize("n", [100, 384])
def test_pred_and_split_solves_on_card_match_cpu(cuda, options, n):
    h = generate_np(np.random.default_rng(n), n).h
    mp.launches.update(minplus=0, minplus_argmin=0, minplus_pred=0)
    fb.launches.update(fw_block=0, fw_block_pred=0)
    got = solve(h, **options)
    want = solve(h, device="cpu", **options)
    assert got.dist.is_cuda and torch.equal(got.dist.cpu(), want.dist)
    rounds = -(-n // min(256, n))
    if options.get("with_pred"):
        assert got.pred.is_cuda and got.pred.dtype == torch.int32
        assert torch.equal(got.pred.cpu(), want.pred)
        assert fb.launches["fw_block_pred"] == rounds
        assert mp.launches["minplus_pred"] == (3 if options.get("round_mode") else 2) * rounds
        assert mp.launches["minplus_argmin"] == 0
    else:
        assert fb.launches["fw_block"] == rounds and mp.launches["minplus"] == 3 * rounds


def test_ops_bf16_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(9)
    x = _mat(rng, (300, 256), "tropical", ties=True).bfloat16()
    y = _mat(rng, (256, 500), "tropical", ties=True).bfloat16()
    a = _mat(rng, (300, 500), "tropical", ties=True).bfloat16()
    got = ops.minplus_argmin(x.to(cuda), y.to(cuda), a.to(cuda))
    want = ops.minplus_argmin(x, y, a)
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
    assert torch.equal(ops.minplus(x.to(cuda), y.to(cuda)).cpu(), ops.minplus(x, y))


def _row_close_pair(d, rows, semiring, track, pred=None):
    """One launch of a row_close mode (value, witness, or preds when
    ``pred`` is given) against its plain version: equal, and counted once
    under its mode."""
    name = "row_close_pred" if pred is not None else "row_close_argmin" if track else "row_close"
    before = dict(rc.launches)
    if pred is not None:
        got = rc.row_close_pred_cuda(d, rows, pred, semiring=semiring)
        want = rc.row_close_pred_torch(d, rows, pred, semiring=semiring)
    else:
        got = rc.row_close_cuda(d, rows, track=track, semiring=semiring)
        want = rc.row_close_torch(d, rows, track=track, semiring=semiring)
    torch.cuda.synchronize()
    assert rc.launches == {**before, name: before[name] + 1}
    return _same(got[0], want[0]) and (got[1] is None) == (want[1] is None) and (
        got[1] is None or torch.equal(got[1], want[1]))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("n,r", [(40, 6), (300, 130), (1000, 4)])
def test_row_close_kernel_matches_plain(cuda, semiring, track, n, r):
    rng = np.random.default_rng(n + r)
    d = torch.from_numpy(generate(rng, n, semiring)).to(cuda)
    rows = torch.from_numpy(rng.integers(0, n, r).astype(np.int32)).to(cuda)
    rows[-1] = rows[0]                       # a repeated row id
    assert _row_close_pair(d, rows, semiring, track)


@pytest.mark.parametrize("track", [False, True])
def test_row_close_kernel_ties_and_nan(cuda, track):
    rng = np.random.default_rng(11)
    d = _mat(rng, (257, 257), "tropical", ties=True).to(cuda)
    rows = torch.tensor([0, 5, 5, 256, 100], dtype=torch.int32, device=cuda)
    assert _row_close_pair(d, rows, "tropical", track)
    d[5, 3] = d[40, 7] = float("nan")
    assert _row_close_pair(d, rows, "tropical", track)


@pytest.mark.parametrize("mode", ["row_close", "row_close_argmin", "row_close_pred"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("r", [1, 4, 16, 64, 128, 129, 1024])
@pytest.mark.parametrize("n", [255, 1030])
def test_row_close_modes_match_plain(cuda, mode, semiring, r, n):
    """Each mode against its plain version on every tile height, with k
    whole (n = 255) and split (n = 1030; neither is a multiple of 4, so the
    ring reads an aligned copy of d), with repeated row ids, ties, and NaN
    candidates and start values where the semiring's ⊗ keeps them."""
    rng = np.random.default_rng(r + n)
    d = _mat(rng, (n, n), semiring, ties=True, density=0.3)
    d.fill_diagonal_(get_semiring(semiring).one)
    if semiring in ("tropical", "bottleneck"):
        d[3, 17] = d[100, 5] = d[n - 1, n - 1] = float("nan")
    d = d.to(cuda)
    rows = torch.from_numpy(rng.integers(0, n, r).astype(np.int32))
    rows[:: 3] = rows[0]                     # repeated row ids
    rows[-1] = 3
    rows = rows.to(cuda)
    pred = init_pred(d, semiring) if mode == "row_close_pred" else None
    plan = rc.launch_plan(r, n, mode != "row_close")
    assert (plan.chunks > 1) == (n > 1000)
    assert _row_close_pair(d, rows, semiring, mode == "row_close_argmin", pred)


def test_row_close_pred_is_the_witness_through_pred_from_kstar(cuda):
    """The pred mode's preds are the witness mode's K* through
    pred_from_kstar, on the card, at a split and an unsplit plan."""
    rng = np.random.default_rng(4)
    h = torch.from_numpy(generate_np(rng, 2051, rho=20.0).h).to(cuda)
    p = init_pred(h)
    for r in (16, 1500):
        rows = torch.from_numpy(rng.choice(2051, r, replace=False).astype(np.int32)).to(cuda)
        z, ks = rc.row_close_cuda(h, rows, track=True)
        zp, pz = rc.row_close_pred_cuda(h, rows, p)
        ppanel = p.index_select(0, rows.long())
        assert torch.equal(z, zp) and bool((ks >= 0).any())
        assert torch.equal(pz, ops.pred_from_kstar(ks, ppanel, p, fallback=ppanel))


def test_row_close_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    d = torch.zeros((64, 64), device=cuda)
    rows = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(IndexError):
        rc.row_close_cuda(d, torch.tensor([0, 64], dtype=torch.int32, device=cuda))
    with pytest.raises(IndexError):
        rc.row_close_cuda(d, torch.tensor([-1], dtype=torch.int32, device=cuda))
    with pytest.raises(TypeError):
        rc.row_close_cuda(d, rows.long())
    with pytest.raises(TypeError):
        rc.row_close_cuda(d.bfloat16(), rows)
    with pytest.raises(ValueError):
        rc.row_close_cuda(d[:, :32], rows)
    with pytest.raises(ValueError):
        rc.row_close_cuda(d, rows.cpu())
    p = torch.zeros((64, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        rc.row_close_pred_cuda(d, rows, p.long())
    with pytest.raises(ValueError):
        rc.row_close_pred_cuda(d, rows, p[:32])
    with pytest.raises(ValueError):
        rc.row_close_pred_cuda(d, rows, p.cpu())
    with pytest.raises(ValueError):
        rc.row_close_pred_cuda(d, rows, p.t())


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_restricted_close_on_card_matches_cpu(cuda, with_pred, dtype):
    n = 300
    h = generate_np(np.random.default_rng(5), n, rho=10.0).h
    d = torch.from_numpy(h).to(dtype)             # unsolved, so the pass moves
    p = init_pred(d) if with_pred else None
    rows = torch.tensor([3, 7, 7, 200, 299, 3], dtype=torch.int32)
    want = ops.row_restricted_close(d, rows, pred=p)
    before = dict(rc.launches)
    got = ops.row_restricted_close(d.to(cuda), rows.to(cuda),
                                   pred=None if p is None else p.to(cuda))
    torch.cuda.synchronize()
    mode = "row_close_pred" if with_pred else "row_close"
    assert rc.launches == {**before, mode: before[mode] + 1}   # never row_close_argmin
    assert not torch.equal(want[0], d)
    assert torch.equal(got[0].cpu(), want[0])
    assert not with_pred or torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("row_threshold", [0.5, 0.0])
def test_dynamic_stream_on_card_matches_cpu(cuda, with_pred, row_threshold):
    rng = np.random.default_rng(21)
    h = generate_np(rng, 300, rho=40.0).h        # dense: most drawn pairs are edges
    kw = dict(with_pred=with_pred, resolve_threshold=1.0, row_threshold=row_threshold)
    card, host = DynamicAPSP(h, **kw), DynamicAPSP(h, device="cpu", **kw)
    assert card.dist.is_cuda and card.device.type == "cuda"
    rc.launches.update(dict.fromkeys(rc.launches, 0))
    mp.launches.update(minplus=0, minplus_argmin=0, minplus_pred=0)
    for wf in (0.0, 0.5, 1.0, 0.5):
        batch = generate_edge_updates(rng, host.h, 16, worsen_frac=wf)
        assert card.update(*batch) == host.update(*batch)
        assert torch.equal(card.dist.cpu(), host.dist)
        assert not with_pred or torch.equal(card.pred.cpu(), host.pred)
    assert card.stats == host.stats and card.stats["rank_k"] >= 1
    if row_threshold:
        mode = "row_close_pred" if with_pred else "row_close"
        assert card.stats["row_iters"] >= 1 and rc.launches == {
            **dict.fromkeys(rc.launches, 0), mode: card.stats["row_iters"]}
    else:
        assert card.stats["warm_resolve"] >= 1 and not any(rc.launches.values())
    assert mp.launches["minplus_argmin" if with_pred else "minplus"] > 0



def _pred_pair(x, y, px, py, a, pa, k_offset, j_offset, semiring="tropical"):
    before = mp.launches["minplus_pred"]
    got = mp.minplus_pred_cuda(x, y, px, py, a, pa, k_offset=k_offset, j_offset=j_offset,
                               semiring=semiring)
    assert mp.launches["minplus_pred"] == before + 1
    want = mp.minplus_pred_torch(x, y, px, py, a, pa, k_offset=k_offset, j_offset=j_offset,
                                 semiring=semiring)
    torch.cuda.synchronize()
    return _same(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_minplus_pred_kernel_matches_plain(cuda, semiring, acc, ties):
    """The pred epilogue against minplus_argmin_torch + pred_from_kstar: a
    batch of G = 3, k_offset != j_offset (so that some winners are the
    output's own column), px a strided view of a wider pred matrix."""
    rng = np.random.default_rng(31 + acc + 2 * ties)
    g, m, k, n = 3, 300, 96, 260
    x = _mat(rng, (g, m, k), semiring, ties).to(cuda)
    y = _mat(rng, (g, k, n), semiring, ties).to(cuda)
    a = _mat(rng, (g, m, n), semiring, ties, 0.3).to(cuda) if acc else None
    wide = torch.randint(-1, 5000, (g, m, k + 40), dtype=torch.int32, device=cuda)
    px = wide[..., 17:17 + k]                       # strided: row pitch k + 40
    py = torch.randint(-1, 5000, (g, k, n), dtype=torch.int32, device=cuda)
    pa = torch.randint(-1, 5000, (g, m, n), dtype=torch.int32, device=cuda) if acc else None
    assert not px.is_contiguous()
    for k_offset, j_offset in ((0, 0), (100, 40), (0, 50)):
        assert _pred_pair(x, y, px, py, a, pa, k_offset, j_offset, semiring)
    if acc:   # an accumulator without a fallback: -1 where it was kept
        assert _pred_pair(x, y, px, py, a, None, 100, 40, semiring)


def test_minplus_pred_kernel_on_state_panels(cuda):
    """The pred round's two shapes on strided panels of one state, as
    ops.fw_round_pred passes them: stage 2 (col ⊗ A*, accumulate into col)
    and stage 3 (col' ⊗ row, accumulate into D), and ops.minplus_pred is one
    launch on a CUDA tensor."""
    n, b, o = 1024, 256, 512
    h = torch.from_numpy(generate_np(np.random.default_rng(8), n, rho=8.0).h).to(cuda)
    p = init_pred(h)
    piv, ppiv = fb.fw_block_pred_torch(h[o:o + b, o:o + b], p[o:o + b, o:o + b])
    col, pcol = h[:, o:o + b], p[:, o:o + b]
    assert _pred_pair(col, piv, pcol, ppiv, col, pcol, o, o)
    colp, pcolp = mp.minplus_pred_torch(col, piv, pcol, ppiv, col, pcol, k_offset=o, j_offset=o)
    assert _pred_pair(colp, h[o:o + b, :], pcolp, p[o:o + b, :], h, p, o, 0)
    before = dict(mp.launches)
    got = ops.minplus_pred(col, piv, pcol, ppiv, a=col, pa=pcol, k_offset=o, j_offset=o)
    assert mp.launches["minplus_pred"] == before["minplus_pred"] + 1
    assert {k_: v for k_, v in mp.launches.items() if k_ != "minplus_pred"} == {
        k_: v for k_, v in before.items() if k_ != "minplus_pred"}
    want = ops.minplus_pred(col.cpu(), piv.cpu(), pcol.cpu(), ppiv.cpu(), a=col.cpu(),
                            pa=pcol.cpu(), k_offset=o, j_offset=o)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


# A finite start value that every candidate of _mat's operands improves on.
WORSE = {"tropical": 1e6, "bottleneck": -1e6, "reliability": 1e-6, "boolean": 0.5}


def _eager_fold(x, y, a, semiring):
    """The sequential witness fold, one k at a time on the card: each
    candidate against the accumulator with the strict better, so the bits
    of each output are those of its first winning candidate."""
    sr = get_semiring(semiring)
    acc = (torch.full(x.shape[:-1] + y.shape[-1:], sr.zero, device=x.device) if a is None
           else a.clone())
    idx = torch.full(acc.shape, -1, dtype=torch.int32, device=x.device)
    for kk in range(x.shape[-1]):
        c = sr.mul(x[..., :, kk, None], y[..., None, kk, :])
        won = sr.better(c, acc)
        acc = torch.where(won, c, acc)
        idx = torch.where(won, torch.full_like(idx, kk), idx)
    return acc, idx


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _routes(semiring, route, rng):
    """(x, y, a, product knobs) of a product that drives one way of the
    witness fold (csrc/minplus_tile.cuh fold_ring): ``one_lane``, a start
    value that nothing improves but at a few scattered outputs (deferred
    slices, one lane of a warp rescanning); ``all_lanes``, a start value
    every candidate improves on (a deferred first slice in which every lane
    rescans for all its outputs, then eager slices); ``from_zero``, a split
    product folded from the semiring zero (an all-improving first slice,
    eager); ``signed_zero``, ±0 candidates below a start of 1 (tropical: the
    witness candidate's own sign)."""
    m, k, n = 256, 256, 320
    x = _mat(rng, (m, k), semiring, ties=True)
    y = _mat(rng, (k, n), semiring, ties=True)
    if route == "one_lane":
        a = mp.minplus_torch(x, y, semiring=semiring)
        i = torch.from_numpy(rng.integers(0, m, 24))
        j = torch.from_numpy(rng.integers(0, n, 24))
        a[i, j] = WORSE[semiring]
        return x, y, a, {}
    if route == "all_lanes":
        return x, y, torch.full((m, n), WORSE[semiring]), {}
    if route == "from_zero":
        return x, y, None, {"chunks": 4}
    x = torch.from_numpy(rng.choice([0.0, -0.0, 1.0], size=(m, k)).astype(np.float32))
    y = torch.from_numpy(rng.choice([0.0, -0.0, 2.0], size=(k, n)).astype(np.float32))
    return x, y, torch.ones(m, n), {}


ROUTES = [(sr, route) for sr in SEMIRINGS for route in ("one_lane", "all_lanes", "from_zero")
          ] + [("tropical", "signed_zero")]
# The fold's way each route must take at least once (mp.FOLD_COUNTS).
ROUTE_COUNT = {"one_lane": "rescans", "all_lanes": "eager", "from_zero": "eager",
               "signed_zero": "resolved"}


@pytest.mark.parametrize("semiring,route", ROUTES)
def test_witness_fold_routes_match_the_eager_fold(cuda, semiring, route):
    """The deferred witness fold's rescans and its eager slices give the
    sequential fold's (Z, K*) bit for bit, and the preds through
    pred_from_kstar; the fold's counts (read under a profiler) show the
    way taken."""
    rng = np.random.default_rng(len(route) + 7 * SEMIRINGS.index(semiring))
    x, y, a, knobs = _routes(semiring, route, rng)
    x, y = x.to(cuda), y.to(cuda)
    a = None if a is None else a.to(cuda)
    px = torch.randint(-1, 5000, x.shape, dtype=torch.int32, device=cuda)
    py = torch.randint(-1, 5000, y.shape, dtype=torch.int32, device=cuda)
    pa = None if a is None else torch.randint(-1, 5000, a.shape, dtype=torch.int32, device=cuda)
    mp.fold_counts(cuda, reset=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        z, ks = mp.minplus_argmin_cuda(x, y, a, semiring=semiring, **knobs)
        zp, p = mp.minplus_pred_cuda(x, y, px, py, a, pa, k_offset=3, j_offset=0,
                                     semiring=semiring, **knobs)
    counts = mp.fold_counts(cuda, reset=True)
    wz, wk = _eager_fold(x, y, a, semiring)
    assert _bits(z, wz) and torch.equal(ks, wk) and _bits(zp, wz)
    assert torch.equal(p, mp.pred_from_kstar(wk, px, py, k_offset=3, fallback=pa))
    assert counts[ROUTE_COUNT[route]] > 0, counts
    if route == "one_lane":
        assert counts["eager"] == 0 and 0 < counts["resolved"] <= 2 * 24 * 8, counts
    if route == "all_lanes":
        assert counts["rescans"] > 0 and counts["resolved"] >= 2 * x.shape[0] * y.shape[1], counts


def test_witness_fold_counter_is_kept_only_under_a_profiler(cuda):
    """Under a profiler the counts' slices equal the product's output tiles
    x warps x slices (a split plan: x chunks, each chunk's slices), and
    every slice is eager or deferred; off the profiler the kernel gets a
    null pointer and nothing is counted."""
    rng = np.random.default_rng(3)
    m, k, n = 200, 250, 300
    x, y = _mat(rng, (m, k), "tropical").to(cuda), _mat(rng, (k, n), "tropical").to(cuda)
    a = _mat(rng, (m, n), "tropical", density=0.3).to(cuda)
    mp.fold_counts(cuda, reset=True)
    assert mp._fold_buffer(cuda) is None
    mp.minplus_argmin_cuda(x, y, a)
    assert set(mp.fold_counts(cuda).values()) == {0}
    for knobs in ({}, {"chunks": 3, "tile_rows": 32}):
        plan = mp.launch_plan(1, m, k, n, "minplus_argmin", **knobs)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            want = mp.minplus_argmin_cuda(x, y, a, **knobs)
        counts = mp.fold_counts(cuda, reset=True)
        tiles = plan.grid[0] * plan.grid[1]
        slices = sum(-(-len(plan.k_of(c, k)) // plan.depth) for c in range(plan.chunks))
        assert counts["slices"] == tiles * (plan.threads // 32) * slices, (counts, plan)
        assert counts["eager"] <= counts["slices"]
        got = mp.minplus_argmin_cuda(x, y, a, **knobs)
        assert set(mp.fold_counts(cuda).values()) == {0}
        assert _bits(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_row_close_pred_pass_matches_the_eager_fold(cuda, semiring):
    """A row_close pred pass (the pred engine's, folded from the zero with
    D's rows folded in last) against its plain version, values bit for
    bit, at an unsplit and a split plan."""
    rng = np.random.default_rng(29)
    for n, r in ((300, 64), (1030, 40)):
        d = _mat(rng, (n, n), semiring, ties=True, density=0.3)
        d.fill_diagonal_(get_semiring(semiring).one)
        d = d.to(cuda)
        rows = torch.from_numpy(rng.integers(0, n, r).astype(np.int32)).to(cuda)
        pred = init_pred(d, semiring)
        got = rc.row_close_pred_cuda(d, rows, pred, semiring=semiring)
        want = rc.row_close_pred_torch(d, rows, pred, semiring=semiring)
        assert _bits(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["minplus", "minplus_argmin"])
@pytest.mark.parametrize("m,k,n", [(7, 19, 100), (19, 7, 257), (100, 257, 7), (257, 100, 19),
                                   (257, 257, 257), (7, 1, 7)])
def test_minplus_kernels_ragged_shapes(cuda, kind, m, k, n):
    """M, N, K that are not multiples of the tile or of 4: the k-major copy's
    padding, a y whose rows the ring cannot copy as they lie, the last
    partial k slice of the witness fold."""
    rng = np.random.default_rng(m * k + n)
    x = _mat(rng, (m, k), "tropical", True).to(cuda)
    y = _mat(rng, (k, n), "tropical", True).to(cuda)
    a = _mat(rng, (m, n), "tropical", True, 0.3).to(cuda)
    assert _product_pair(kind, x, y, None, "tropical")
    assert _product_pair(kind, x, y, a, "tropical")
    assert _product_pair(kind, x, y, a, "reliability")


@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("b", LARGE_B)
def test_large_tile_closures_match_plain(cuda, pred, b):
    """The grid closure on a T = 3 stack, and on one tile with a tropical
    negative cycle and NaN (every step must read the old row and column)."""
    rng = np.random.default_rng(b)
    d = torch.stack([torch.from_numpy(generate(rng, b, "tropical")) for _ in range(3)]).to(cuda)
    p = torch.randint(-1, 5000, d.shape, dtype=torch.int32, device=cuda)
    h = generate_np(rng, b, rho=30.0).h
    h[2, 7], h[7, 2] = -9.0, 3.0
    h[b - 2, b - 1] = np.nan
    one = torch.from_numpy(h).to(cuda)
    pone = init_pred(one)
    for tiles, ptiles in ((d, p), (one, pone)):
        if pred:
            before = fb.launches["fw_block_pred"]
            got = fb.fw_block_pred_cuda(tiles, ptiles)
            assert fb.launches["fw_block_pred"] == before + 1
            want = fb.fw_block_pred_torch(tiles, ptiles)
            torch.cuda.synchronize()
            assert _same(got[0], want[0]) and torch.equal(got[1], want[1])
        else:
            got = fb.fw_block_cuda(tiles)
            torch.cuda.synchronize()
            assert _same(got, fb.fw_block_torch(tiles))
    assert bool((torch.diagonal(fb.fw_block_pred_torch(one, pone)[0]) < 0).any())


@pytest.mark.parametrize("b", LARGE_B)
def test_large_tile_rounds_match_plain(cuda, b):
    """fw_round with the grid closure: G = 3 bottleneck, and bf16 storage
    (the closed pivot rounded through bf16)."""
    rng = np.random.default_rng(b + 1)
    hs = torch.from_numpy(np.stack([generate(rng, 2 * b, "bottleneck") for _ in range(3)])).to(cuda)
    got, want = _round_pair(hs, b, b, "bottleneck")
    assert _same(got, want)
    h = torch.from_numpy(generate_np(rng, 2 * b).h).to(cuda)
    got, want = _round_pair(h.to(torch.bfloat16), 0, b, "tropical")
    assert got.dtype == torch.bfloat16 and _same(got.float(), want.float())
    d = torch.stack([torch.from_numpy(generate(rng, b, "tropical")) for _ in range(3)]).to(cuda)
    got = ops.fw_block(d.bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), ops.fw_block(d.cpu().bfloat16()))


@pytest.mark.parametrize("options", [{}, {"with_pred": True}, {"round_mode": "split"},
                                     {"round_mode": "split", "with_pred": True}])
def test_large_tile_solves_on_card_match_cpu(cuda, options):
    """B = 512 on every path at n = 700 (padded to 1024), against the CPU."""
    h = generate_np(np.random.default_rng(700), 700, rho=4.0).h
    got = solve(h, block_size=512, **options)
    want = solve(h, block_size=512, device="cpu", **options)
    assert torch.equal(got.dist.cpu(), want.dist)
    assert got.pred is None or torch.equal(got.pred.cpu(), want.pred)


@pytest.mark.parametrize("b", [512, 1024])
def test_large_tile_solve_at_8192_equals_b256(cuda, b):
    """Integer weights: every sum is exact, so any B gives the same bits."""
    h = generate_np(np.random.default_rng(0), 8192, rho=2.0).h
    want = solve(h).dist
    before = fr.rounds
    got = solve(h, block_size=b).dist
    assert fr.rounds - before == 8192 // b
    assert torch.equal(got, want)


# The paper's solvers and the batch engine on the card, against the same
# calls on the CPU (the plain versions).

METHOD_KW = {"squaring": {}, "squaring_3d": {}, "classic": {}, "blocked_fw": {"block_size": 16},
             "rkleene": {"base": 8}}


def _counts():
    return {"fw_round": fr.rounds, **mp.launches, **fb.launches}


def _launched_since(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("method", sorted(METHOD_KW))
def test_methods_on_card_match_cpu(cuda, method, semiring, with_pred):
    h = generate(np.random.default_rng(77), 77, semiring)
    got = solve(h, method=method, with_pred=with_pred, semiring=semiring, **METHOD_KW[method])
    want = solve(h, method=method, with_pred=with_pred, semiring=semiring, device="cpu",
                 **METHOD_KW[method])
    assert got.dist.is_cuda and _same(got.dist.cpu(), want.dist)
    assert got.pred is None or torch.equal(got.pred.cpu(), want.pred)


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("base", [6, 8, 64])
def test_rkleene_on_card_launches_its_kernels(cuda, base, with_pred):
    """Quadrant products on the kernel (base 6: quadrants not 16-byte
    aligned, the copy path), every leaf on fw_block; the counts follow the
    recursion: 6 products and 2 halves a level."""
    rk = importlib.import_module("repro_torch.core.rkleene")

    n = 300
    h = generate_np(np.random.default_rng(base), n, rho=5.0).h

    def count(m):
        if m <= base:
            return 0, 1
        half = m // 2 if with_pred else rk.split_point(m, base)
        p1, l1 = count(half)
        p2, l2 = count(m - half)
        return 6 + p1 + p2, l1 + l2

    edge = rk.pow2_size(n, base) if with_pred else rk.padded_size(n, base)
    products, leaves = count(edge)
    before = _counts()
    got = solve(h, method="rkleene", base=base, with_pred=with_pred)
    torch.cuda.synchronize()
    prod, leaf = ("minplus_pred", "fw_block_pred") if with_pred else ("minplus", "fw_block")
    assert _launched_since(before) == {prod: products, leaf: leaves}
    want = solve(h, method="rkleene", base=base, with_pred=with_pred, device="cpu")
    assert torch.equal(got.dist.cpu(), want.dist)
    assert torch.equal(got.dist.cpu(), solve(h, device="cpu").dist)
    assert got.pred is None or torch.equal(got.pred.cpu(), want.pred)


@pytest.mark.parametrize("with_pred", [False, True])
def test_squaring_on_card_launches_log2_products(cuda, with_pred):
    """ceil(log2 n) products with x, y and the accumulator the same tensor."""
    h = generate_np(np.random.default_rng(3), 1000, rho=1.0).h
    before = _counts()
    got = solve(h, method="squaring", with_pred=with_pred)
    torch.cuda.synchronize()
    assert _launched_since(before) == {"minplus_pred" if with_pred else "minplus": 10}
    want = solve(h, method="squaring", with_pred=with_pred, device="cpu")
    assert torch.equal(got.dist.cpu(), want.dist)
    assert got.pred is None or torch.equal(got.pred.cpu(), want.pred)


def test_squaring_3d_and_classic_launch_no_kernel(cuda):
    h = generate_np(np.random.default_rng(4), 96, rho=5.0).h
    want = solve(h).dist
    for method in ("squaring_3d", "classic"):
        before = _counts()
        got = solve(h, method=method).dist
        torch.cuda.synchronize()
        assert _launched_since(before) == {} and torch.equal(got, want), method


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("method", sorted(METHOD_KW))
def test_solve_batch_on_card_matches_cpu(cuda, method, bucket):
    rng = np.random.default_rng(9)
    hs = [generate_np(rng, n).h for n in (4, 17, 33, 64, 7, 50, 130, 1)]
    with_pred = method != "squaring_3d"
    got = repro_torch.solve_batch(hs, method=method, with_pred=with_pred, bucket_by_size=bucket,
                                  **METHOD_KW[method])
    want = repro_torch.solve_batch(hs, method=method, with_pred=with_pred,
                                   bucket_by_size=bucket, device="cpu", **METHOD_KW[method])
    assert got.dist.is_cuda and torch.equal(got.dist.cpu(), want.dist)
    assert not with_pred or torch.equal(got.pred.cpu(), want.pred)
    for i, h in enumerate(hs):
        assert torch.equal(got.unpadded(i).dist, solve(h).dist), i


@pytest.mark.parametrize("options", [{}, {"with_pred": True}, {"round_mode": "split"},
                                     {"round_mode": "split", "with_pred": True}])
def test_blocked_fw_batch_on_card_counts_one_launch_a_step(cuda, options):
    """G = 64 graphs advance one pivot a round: the launch counts are those
    of one graph's solve."""
    rng = np.random.default_rng(10)
    hs = np.stack([generate_np(rng, 300, rho=3.0).h for _ in range(64)])
    before = _counts()
    got = repro_torch.solve_batch(hs, block_size=128, **options)
    torch.cuda.synchronize()
    rounds = 3
    pred, split = options.get("with_pred", False), "round_mode" in options
    expect = ({"fw_block_pred": rounds, "minplus_pred": (3 if split else 2) * rounds} if pred
              else {"fw_block": rounds, "minplus": 3 * rounds} if split else {"fw_round": rounds})
    assert _launched_since(before) == expect
    for i in (0, 31, 63):
        one = solve(hs[i], block_size=128, **options)
        assert torch.equal(got.dist[i], one.dist)
        assert got.pred is None or torch.equal(got.pred[i], one.pred)


def test_core_products_on_card(cuda):
    from repro_torch.core import minplus, minplus_3d, minplus_3d_argmin, minplus_pred, softmin_matmul

    rng = np.random.default_rng(12)
    x = torch.from_numpy(generate_np(rng, 200).h)
    for fn in (minplus, minplus_3d):
        assert torch.equal(fn(x.to(cuda), x.to(cuda)).cpu(), fn(x, x))
    z, k = minplus_3d_argmin(x[:64, :64].to(cuda), x[:64, :64].to(cuda))
    wz, wk = minplus_3d_argmin(x[:64, :64], x[:64, :64])
    assert torch.equal(z.cpu(), wz) and torch.equal(k.cpu(), wk)
    p = init_pred(x)
    before = _counts()
    gz, gp = minplus_pred(x.to(cuda), x.to(cuda), p.to(cuda), p.to(cuda), k_offset=3, j_offset=3)
    assert _launched_since(before) == {"minplus_pred": 1}
    wz, wp = minplus_pred(x, x, p, p, k_offset=3, j_offset=3)
    assert torch.equal(gz.cpu(), wz) and torch.equal(gp.cpu(), wp)
    s, w = softmin_matmul(x.to(cuda), x.to(cuda), tau=0.1).cpu(), softmin_matmul(x, x, tau=0.1)
    fin = torch.isfinite(w)
    assert torch.equal(fin, torch.isfinite(s))
    assert float((s[fin] - w[fin]).abs().max()) <= 1e-5 * 100


def test_early_exit_on_card(cuda):
    from repro_torch.core import fw_squaring_early_exit

    h = torch.from_numpy(generate_np(np.random.default_rng(13), 500, rho=2.0).h)
    gd, git = fw_squaring_early_exit(h.to(cuda))
    wd, wit = fw_squaring_early_exit(h)
    assert git == wit and torch.equal(gd.cpu(), wd)


def test_generate_batch_on_card(cuda):
    from repro_torch.core import generate_batch

    gen = torch.Generator(device="cuda").manual_seed(1)
    h, adj, sizes = generate_batch(gen, [30, 100, 64])
    assert h.is_cuda and h.shape == (3, 100, 100) and sizes.is_cuda
    res = repro_torch.solve_batch(h, sizes.cpu().numpy(), method="squaring")
    for i, n in enumerate((30, 100, 64)):
        assert torch.equal(res.unpadded(i).dist, solve(h[i, :n, :n]).dist)


# -- the serving tier's shapes: the batched rank-k pass, the pool, serve ----

def _rank_k_operands(rng, g, n, k):
    """The batched rank-k pass's product operands: x (G, n, k) = d[:, U] ⊗ W,
    y (G, k, n) = d[V, :], a = the (G, n, n) state."""
    d = torch.stack([torch.from_numpy(generate_np(rng, n, rho=20.0).h) for _ in range(g)])
    u = torch.from_numpy(rng.integers(0, n, (g, k)))
    v = torch.from_numpy(rng.integers(0, n, (g, k)))
    w = torch.from_numpy(rng.uniform(1, 20, (g, k)).astype(np.float32))
    x = torch.gather(d, 2, u[:, None, :].expand(g, n, k)) + w[:, None, :]
    y = torch.gather(d, 1, v[:, :, None].expand(g, k, n))
    return x.contiguous(), y.contiguous(), d


@pytest.mark.parametrize("kind", ["minplus", "minplus_argmin"])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("k", [1, 8, 16, 64])
@pytest.mark.parametrize("n", [63, 1024])
def test_batched_rank_k_products_match_plain(cuda, kind, g, k, n):
    """K = 1-64 with G > 1 in the grid's z: n = 1024 runs the cp.async ring
    on y's rows as they lie, n = 63 the padded copy."""
    x, y, d = _rank_k_operands(np.random.default_rng(g * 100 + k), g, n, k)
    if n % 4 == 0:
        assert mp._ring_limit(y.to(cuda), n) == n
    assert _product_pair(kind, x.to(cuda), y.to(cuda), d.to(cuda), "tropical")


@pytest.mark.parametrize("with_pred", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_rank_k_update_on_card_matches_cpu(cuda, with_pred, dtype):
    rng = np.random.default_rng(31)
    g, n, k = 3, 300, 16
    d = torch.stack([solve(generate_np(rng, n, rho=10.0).h, device="cpu").dist
                     for _ in range(g)]).to(dtype)
    p = torch.stack([init_pred(torch.from_numpy(generate_np(rng, n).h)) for _ in range(g)])
    u = torch.from_numpy(rng.integers(0, n, (g, k)).astype(np.int32))
    v = torch.from_numpy(rng.integers(0, n, (g, k)).astype(np.int32))
    w = torch.from_numpy(rng.uniform(1, 5, (g, k)).astype(np.float32)).to(dtype)
    pred = p if with_pred else None
    want = ops.rank_k_update(d, u, v, w, pred=pred)
    before = _counts()
    got = ops.rank_k_update(d.to(cuda), u.to(cuda), v.to(cuda), w.to(cuda),
                            pred=None if pred is None else pred.to(cuda))
    torch.cuda.synchronize()
    assert _launched_since(before) == {"minplus_argmin" if with_pred else "minplus": 1}
    assert torch.equal(got[0].cpu(), want[0])
    assert not with_pred or torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("with_pred", [False, True])
def test_apply_updates_batched_on_card(cuda, with_pred):
    """One batched launch a pass; each engine equal to its twin updated with
    ``update`` (dist, pred, version) and to the CPU's batched drain."""
    from repro_torch.core import apply_updates_batched

    rng = np.random.default_rng(41)
    hs = [generate_np(rng, 500, rho=8.0).h for _ in range(4)]
    card = [DynamicAPSP(h, with_pred=with_pred) for h in hs]
    twins = [DynamicAPSP(h, with_pred=with_pred) for h in hs]
    host = [DynamicAPSP(h, with_pred=with_pred, device="cpu") for h in hs]
    batches = [generate_edge_updates(rng, h, 12) for h in hs]
    kind = "minplus_argmin" if with_pred else "minplus"
    before = _counts()
    infos, deferred = apply_updates_batched(card, batches)
    assert deferred == [] and all(i["batched"] == 4 for i in infos)
    assert _launched_since(before) == {kind: infos[0]["passes"]}
    assert apply_updates_batched(host, batches) == (infos, deferred)
    for c, t, hh, b in zip(card, twins, host, batches):
        t.update(*b)
        assert torch.equal(c.dist, t.dist) and c.version == t.version
        assert torch.equal(c.dist.cpu(), hh.dist)
        if with_pred:
            assert torch.equal(c.pred, t.pred) and torch.equal(c.pred.cpu(), hh.pred)


def test_launch_counters_exact_under_threads(cuda):
    """Kernels launched from eight threads at once (the serving tier's
    background drains do so): no launch is lost from the counts, and a
    first call raced from two threads loads the library once."""
    import threading

    from repro_torch.kernels import _build

    x, y, d = _rank_k_operands(np.random.default_rng(5), 2, 256, 8)
    x, y, d = x.to(cuda), y.to(cuda), d.to(cuda)
    want = mp.minplus_torch(x, y, d)
    loads = []
    real_build = _build.build
    _build._libs.pop("minplus", None)
    _build._functions.pop(("minplus", "minplus_launch"), None)
    _build.build = lambda names: loads.append(tuple(names)) or real_build(names)
    bad = []
    try:
        def first():
            if not torch.equal(mp.minplus_cuda(x, y, d), want):
                bad.append("first")

        ts = [threading.Thread(target=first) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120.0)
        assert not any(t.is_alive() for t in ts)
    finally:
        _build.build = real_build
    assert loads == [("minplus",)] and not bad
    before = mp.launches["minplus"]

    def many():
        for _ in range(50):
            mp.minplus_cuda(x, y, d)

    ts = [threading.Thread(target=many) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120.0)
    assert not any(t.is_alive() for t in ts)
    torch.cuda.synchronize()
    assert mp.launches["minplus"] - before == 400


def test_pool_on_card_matches_cpu_pool(cuda):
    from repro_torch.launch import EnginePool

    def run(device):
        pool = EnginePool(method="blocked_fw", with_pred=True, device=device,
                          backlog_watermark=2, seed=2)
        rng = np.random.default_rng(2)
        for gid in range(3):
            pool.admit(gid, generate_np(rng, 200, rho=20.0).h)
        out = []
        try:
            for _ in range(24):
                gid = int(rng.integers(0, 3))
                if rng.uniform() < 0.6:
                    pool.submit_update(gid, *generate_edge_updates(
                        rng, pool.slots[gid].engine.h, 6, worsen_frac=0.1))
                    if pool.backlog() > pool.backlog_watermark:
                        pool.drain_all()
                else:
                    r = pool.query(gid, rng.integers(0, 200, 8), rng.integers(0, 200, 8))
                    out.append((r.values.tolist(), r.source, r.staleness))
            pool.recover_all()
            return out, pool.summary(), [pool.slots[g].engine.dist.cpu() for g in range(3)]
        finally:
            pool.close()

    ca, cs, cd = run("cuda")
    ha, hs, hd = run("cpu")
    assert ca == ha and cs["pool"] == hs["pool"] and cs["slots"] == hs["slots"]
    assert cs["pool"]["drain_batched"] >= 1 and cs["slots"]["retries"] == 0
    assert all(torch.equal(a, b) for a, b in zip(cd, hd))


def test_serve_on_card(cuda, tmp_path, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    got = {}
    assert serve.serve_apsp(32, batch=8, n_max=128, method="blocked_fw",
                            summary_out=got) == 0
    assert got["graphs"] == 32
    assert serve.serve_apsp_dynamic(
        32, n_max=256, graphs=3, verify_every=8, seed=3,
        fault_spec="nan:0.2,crash:0.1:3,poison:0.1", deadline_ms=200.0,
        backlog_watermark=3) == 0


# -- the training slice: spd_features and the GNN train step ---------------

@pytest.mark.parametrize("n,n_landmarks", [(300, 8), (257, 3), (1024, 64)])
def test_spd_features_on_card_matches_plain(cuda, monkeypatch, n, n_landmarks):
    """One ``minplus`` launch a hop, the hops of the CPU loop, the same
    bits; n = 257 takes h's rows padded once (``ring_rows``), not a hop."""
    h = generate_np(np.random.default_rng(n), n, rho=4.0).h
    lm = np.linspace(0, n - 1, n_landmarks).astype(np.int64)
    calls = []
    real = ops.minplus
    monkeypatch.setattr(ops, "minplus", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    want = repro_torch.spd_features(torch.from_numpy(h), lm)
    hops = len(calls)
    before = _counts()
    got = repro_torch.spd_features(torch.from_numpy(h).to(cuda), torch.from_numpy(lm).to(cuda))
    torch.cuda.synchronize()
    assert _launched_since(before) == {"minplus": hops} and len(calls) == 2 * hops
    assert got.is_cuda and _same(got.cpu(), want)
    y = mp.ring_rows(torch.from_numpy(h).to(cuda))
    assert mp._ring_limit(y, n) == -(-n // 4) * 4


def test_spd_features_out_of_range_landmark_raises_before_the_card(cuda):
    """An id outside [-n, n) raises IndexError on the host, with no launch
    and no device-side assert: the card stays usable."""
    h = torch.from_numpy(generate_np(np.random.default_rng(0), 64).h).to(cuda)
    before = _counts()
    with pytest.raises(IndexError, match=r"outside \[-64, 64\)"):
        repro_torch.spd_features(h, torch.tensor([3, 64], device=cuda))
    torch.cuda.synchronize()
    assert _launched_since(before) == {}
    got = repro_torch.spd_features(h, [-1])
    assert _same(got.cpu(), repro_torch.spd_features(h.cpu(), [63]))


@pytest.mark.parametrize("arch_id", ["gcn-cora", "gin-tu", "pna", "nequip"])
def test_gnn_train_steps_on_card_match_cpu(cuda, arch_id):
    """Three smoke-config steps from one initial state: losses and grad
    norms within rtol 1e-4 (the card's index_add sums in no fixed order)."""
    from repro_torch.launch.train import build_smoke_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for dev in ("cpu", "cuda"):
        step, state, batches = build_smoke_trainer(arch_id, seed=0, device=dev)
        out = []
        for _ in range(3):
            state, m = step(state, next(batches))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = out
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the grid verifier's card half (repro_torch.analysis.kernelcheck)
# ---------------------------------------------------------------------------

def test_kernelcheck_lattice_through_the_cuda_kernels(cuda):
    """Every lattice case and autotune candidate through its CUDA kernel,
    the output seeded with the canary: bit-equal to the plain version, and
    at least one canary hit for each of the six kernels."""
    from repro_torch.analysis.kernelcheck import autotune_cases, default_cases
    from repro_torch.analysis.kernelcheck.lattice import GROUPS
    from repro_torch.analysis.kernelcheck.verify import verify_case_cuda

    hits = {}
    for case in default_cases() + autotune_cases():
        problems, hit = verify_case_cuda(case, cuda)
        assert [str(p) for p in problems] == [], case.name
        hits[GROUPS[case.kernel]] = hits.get(GROUPS[case.kernel], 0) + int(hit)
    assert len(hits) == 6 and all(hits.values()), hits


def test_kernelcheck_c_entry_points_refuse_the_mutants_plans(cuda):
    from repro_torch.analysis.kernelcheck.mutants import mutant_cases, refused_on_card

    forms = [m for m in mutant_cases() if m.c_form is not None]
    assert len(forms) >= 6
    for m in forms:
        assert refused_on_card(m, cuda) == {"refused": True, "intact": True}, m.case.name


def test_kernelcheck_seeded_defect_kernels_are_caught(cuda):
    from repro_torch.analysis.kernelcheck.mutants import kernel_mutants, verify_kernel_mutant

    for km in kernel_mutants():
        kinds = {p.kind for p in verify_kernel_mutant(km, cuda)}
        assert (km.expect in kinds) if km.expect else not kinds, (km.name, kinds)


# ---------------------------------------------------------------------------
# the product kernels' tile lattice (minplus tiles and split k, row_close
# knobs, the split-k combine, the tuners and the tuned dispatch)
# ---------------------------------------------------------------------------

def _tile_cases():
    from repro_torch.analysis.kernelcheck import autotune_cases

    return {c.name: c for c in autotune_cases() if c.kernel != "fw_round"}


@pytest.mark.parametrize("name", sorted(_tile_cases()))
def test_tile_lattice_candidate_against_the_plain_version(cuda, name):
    """Each tile and k split the tuners can propose, in the modes the
    lattice holds, through its CUDA kernel (the combine or merge included),
    the output seeded with the canary: bit-equal to the plain version."""
    from repro_torch.analysis.kernelcheck.verify import verify_case_cuda

    problems, _ = verify_case_cuda(_tile_cases()[name], cuda)
    assert [str(p) for p in problems] == []


@pytest.mark.parametrize("semiring", ["tropical", "bottleneck", "reliability", "boolean"])
def test_minplus_combine_against_its_plain_version(cuda, semiring):
    sr = get_semiring(semiring)
    rng = np.random.default_rng(7)
    x = _dev(rng.integers(1, 4, (2, 37, 300)).astype(np.float32), cuda)
    y = _dev(rng.integers(1, 4, (2, 300, 70)).astype(np.float32), cuda)
    a = _dev(rng.integers(2, 9, (2, 37, 70)).astype(np.float32), cuda)
    px = torch.randint(-1, 300, (2, 37, 300), dtype=torch.int32, device=cuda)
    py = torch.randint(-1, 70, (2, 300, 70), dtype=torch.int32, device=cuda)
    pa = torch.randint(-1, 70, (2, 37, 70), dtype=torch.int32, device=cuda)
    pz, pk = mp.minplus_partials_torch(x, y, 64, track=True, semiring=sr)
    before = mp.launches["minplus_combine"]
    for mode in mp.MODES:
        extra = dict(px=px, py=py, pa=pa, k_offset=3) if mode == "minplus_pred" else {}
        kk = None if mode == "minplus" else pk
        gz, go = mp.minplus_combine_cuda(pz, kk, a, mode=mode, semiring=sr, **extra)
        wz, wo = mp.minplus_combine_torch(pz, kk, a, mode=mode, semiring=sr, **extra)
        assert _same(gz, wz) and (go is None or torch.equal(go, wo)), mode
    assert mp.launches["minplus_combine"] == before + 3


def _dev(a, cuda):
    return torch.from_numpy(a).to(cuda)


def test_non_lattice_product_plans_are_refused(cuda):
    x = torch.rand(70, 300, device=cuda)
    y = torch.rand(300, 130, device=cuda)
    plan = mp.launch_plan(1, 70, 300, 130, tile_rows=32, chunks=3)
    for bad in (plan._replace(rows=48), plan._replace(chunk=plan.chunk + 16),
                plan._replace(chunks=plan.chunks - 1), plan._replace(depth=8),
                plan._replace(grid=plan.grid[:2] + (1,))):
        with pytest.raises(RuntimeError, match="launch failed"):
            mp._launch("minplus", 0, x, y, None, "tropical", plan=bad)
    assert _same(mp._launch("minplus", 0, x, y, None, "tropical", plan=plan)[0],
                 mp.minplus_torch(x, y))


def test_tune_on_the_card_and_the_dispatch_launches_the_winner(cuda, tmp_path, monkeypatch):
    from repro_torch.kernels import autotune
    from repro_torch.roofline import op_cost

    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    e = autotune.tune(16, 4096, 2048, device=cuda)
    assert e["source"] == "measured" and e["lattice"] == len(
        autotune.candidates("cuda", 16, 4096, 2048))
    assert autotune.tune(16, 4096, 2048, device=cuda)["source"] == "cache"
    h = torch.from_numpy(generate_np(np.random.default_rng(3), 4096).h).to(cuda)
    x, y = h[:16].contiguous(), h[:, :2048].contiguous()
    mp.launches.update(dict.fromkeys(mp.launches, 0))
    with op_cost.KernelLog() as log:
        z = ops.minplus(x, y, x[:, :2048].contiguous())
    torch.cuda.synchronize()
    plan = log.launches[0][2]
    assert plan == mp.launch_plan(1, 16, 4096, 2048, ny=2048, **e["params"])
    assert mp.launches["minplus"] == 1 and mp.launches["minplus_combine"] == int(plan.chunks > 1)
    assert _same(z, mp.minplus_torch(x, y, x[:, :2048].contiguous()))
    r = autotune.tune_row_close(16, 4096, device=cuda)
    assert r["source"] == "measured" and set(r["params"]) == {"tile_rows", "chunks"}
