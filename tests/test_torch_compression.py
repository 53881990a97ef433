"""``repro_torch.optim.compression`` and ``train.make_compressed_train_step``
against ``repro.optim.compression`` on the CPU.

``quantize_int8``'s q is bit-equal to JAX's and its scale within one ulp
(the same float32 max, clamp and division); ``dequantize_int8`` equal.
The compressed step runs on four spawned gloo ranks on a (2, 2, 1)
(``pod``, ``data``, ``model``) mesh with the reference test's config
(``tests/test_distributed_and_driver.py::test_compressed_train_step_tracks_plain``:
2 layers, d_model 32, 4 / 2 heads, d_ff 64, vocab 61, AdamW, a batch of
8 x 16) for 4 steps beside the port's plain step: the totals within 0.05
of each other, the reference's own bound (int8 gradients with error
feedback are not the plain gradients), and the parameters bit-equal
across the four ranks after every step.  Each rank's residual of a
``compressed_psum`` is exactly ``x - dequant(q)``, and its reduced
gradient exactly ``sum(q) * mean(scale) / n_pods`` (both from the ranks'
own q and scales, gathered).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jc

from repro_torch.launch.apsp_run import run_ranks
from repro_torch.optim import compression as tc

RANK_TIMEOUT = 240


@pytest.mark.parametrize("shape,scale", [((7,), 1.0), ((33, 17), 1e-3), ((4, 5, 6), 50.0),
                                         ((3,), 0.0)])
def test_quantize_int8_matches_jax(shape, scale):
    x = (np.random.default_rng(0).normal(size=shape) * scale).astype(np.float32)
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(int(np.float32(ts).view(np.int32)) - int(np.asarray(js).view(np.int32))) <= 1
    np.testing.assert_array_equal(tc.dequantize_int8(tq, torch.tensor(float(js))).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))


def test_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, 63.5], dtype=torch.float32)
    q, s = tc.quantize_int8(x)
    assert float(s) == 1.0
    assert q.tolist() == [127, -127, 0, 2, 2, 0, 64]
    jq, _ = jc.quantize_int8(jnp.asarray(x.numpy()))
    assert q.tolist() == np.asarray(jq).tolist()


def test_compressed_psum_on_one_process_is_plain_error_feedback():
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(np.zeros((1, 1, 1), np.int64), ("pod", "data", "model"), "cpu")
    g = torch.randn(6, 4, generator=torch.Generator().manual_seed(1))
    e = torch.randn(6, 4, generator=torch.Generator().manual_seed(2)) * 1e-3
    r, e2 = tc.compressed_psum(g, e, mesh)
    q, s = tc.quantize_int8(g + e)
    assert torch.equal(r, q.float() * s) and torch.equal(e2, (g + e) - q.float() * s)
    assert torch.equal(tc.init_error_state({"a": g})["a"], torch.zeros_like(g))


def compressed_ranks(steps, *, device):
    """One rank of the (2, 2, 1) run: the compressed step beside the plain
    step, then one ``compressed_psum`` of pod-dependent tensors checked
    against the ranks' own gathered q and scales."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import LMConfig, init_lm, loss_fn
    from repro_torch.optim import make_optimizer, warmup_cosine
    from repro_torch.sharding import P
    from repro_torch.train import (init_train_state, make_compressed_train_step,
                                   make_train_step, pod_rows)
    from repro_torch.tree import flatten_with_path, tree_map

    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device=device)
    cfg = LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                   vocab=61, param_dtype=torch.float32, compute_dtype=torch.float32,
                   attn_chunk=8)
    params, _ = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    twin = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 10, 100))
    step_c = make_compressed_train_step(lambda p, b: loss_fn(p, b, cfg), opt, mesh,
                                        lambda b: {"tokens": P("pod"), "labels": P("pod")})
    step_p = make_train_step(lambda p, b: loss_fn(p, b, cfg), opt)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 61, (8, 16))).to(device)
    batch = {"tokens": toks, "labels": toks}
    s1 = init_train_state(params, opt, n_pods=2)
    global_err_shapes = [tuple(e.shape) for _, e in flatten_with_path(s1.err)]
    s1.err = pod_rows(s1.err, mesh)
    s2 = init_train_state(twin, opt)
    totals, snapshots = [], []
    for _ in range(steps):
        s1, m1 = step_c(s1, batch)
        s2, m2 = step_p(s2, batch)
        totals.append((float(m1["total"]), float(m2["total"])))
        snapshots.append({"/".join(p): v.detach().cpu().numpy().copy()
                          for p, v in flatten_with_path(s1.params)})

    pod = mesh.axis_index("pod")
    gen = torch.Generator().manual_seed(100 + pod)
    g = torch.randn(5, 7, generator=gen).to(device)
    e = (torch.randn(5, 7, generator=gen) * 1e-2).to(device)
    r, e_new = tc.compressed_psum(g, e, mesh)
    q, s = tc.quantize_int8(g + e)
    group = mesh.group("pod")
    qs = [torch.empty_like(q) for _ in range(2)]
    ss = [torch.empty_like(s) for _ in range(2)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, s, group=group)
    want_r = (qs[0].to(torch.int32) + qs[1].to(torch.int32)).float() * ((ss[0] + ss[1]) / 2) / 2
    return {"totals": totals, "params": snapshots, "err_shapes": global_err_shapes,
            "local_err_shapes": [tuple(v.shape) for _, v in flatten_with_path(s1.err)],
            "residual_exact": bool(torch.equal(e_new, (g + e) - q.float() * s)),
            "reduced_exact": bool(torch.equal(r, want_r)), "step": int(s1.step)}


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(compressed_ranks, 4, (4,), device="cpu", backend="gloo",
                     timeout=RANK_TIMEOUT)


def test_compressed_step_tracks_the_plain_step_on_every_rank(ranks):
    for out in ranks:
        assert len(out["totals"]) == 4 and out["step"] == 4
        for total_c, total_p in out["totals"]:
            assert np.isfinite(total_c) and abs(total_c - total_p) < 0.05


def test_parameters_are_bit_equal_across_ranks_after_every_step(ranks):
    for i in range(4):
        first = ranks[0]["params"][i]
        for out in ranks[1:]:
            assert all(np.array_equal(out["params"][i][k], v) for k, v in first.items())
    assert not all(np.array_equal(ranks[0]["params"][0][k], ranks[0]["params"][3][k])
                   for k in ranks[0]["params"][0])


def test_residuals_keep_the_pod_dimension_and_each_rank_its_row(ranks):
    for out in ranks:
        assert all(s[0] == 2 for s in out["err_shapes"])
        assert all(s[0] == 1 and s[1:] == g[1:]
                   for s, g in zip(out["local_err_shapes"], out["err_shapes"]))


def test_each_ranks_residual_is_x_minus_dequant_q(ranks):
    assert all(out["residual_exact"] and out["reduced_exact"] for out in ranks)
