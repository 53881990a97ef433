"""``repro_torch.models.mind`` and the ``recsys`` trainer against
``repro.models.mind`` on the CPU, at MIND's smoke config and a small
variant, float32, with the JAX parameters carried across
(``core.convert.mind_params_from_jax``) and batches from the shared
``mind_batch_stream``.

Tolerances: interests rtol 1e-5 (atol 1e-6; the same float32 formulas,
three routing rounds summed in other orders by two compilers);
``embedding_bag`` rtol 1e-6; the loss rtol 1e-5 and each gradient leaf
within 1e-4 of its largest magnitude; retrieval ids equal (scores drawn
without ties: a 512-item table of normal draws); three train steps loss
rtol 1e-5, parameters within 1e-4 of each leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mind as jm
from repro.optim import optimizers as jopt
from repro.train import init_train_state as jax_init_state
from repro.train import make_train_step as jax_make_step

from repro_torch.configs import get_arch
from repro_torch.core.convert import mind_params_from_jax, mind_params_to_jax
from repro_torch.data import mind_batch_stream
from repro_torch.launch import train as ttrain
from repro_torch.models import mind as tm
from repro_torch.optim import optimizers as topt
from repro_torch.sharding import PartitionSpec
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import tree_map

SMALL = dict(name="mind-t", n_items=512, embed_dim=16, n_interests=4, capsule_iters=3,
             hist_len=8, n_profile_feats=64, profile_bag_len=4, n_negatives=15)
INTERESTS = dict(rtol=1e-5, atol=1e-6)


def _models(**over):
    kw = {**SMALL, **over}
    jcfg, tcfg = jm.MINDConfig(**kw), tm.MINDConfig(**kw)
    jp, js = jm.init_mind(jax.random.PRNGKey(0), jcfg)
    tp = tree_map(lambda t: t.requires_grad_(), mind_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, tcfg, jp, js, tp


def _batch(cfg, batch=16, seed=0, step=0):
    b = next(mind_batch_stream(batch=batch, n_items=cfg.n_items, hist_len=cfg.hist_len,
                               n_profile_feats=cfg.n_profile_feats,
                               profile_bag_len=cfg.profile_bag_len,
                               n_interests=cfg.n_interests, n_negatives=cfg.n_negatives,
                               seed=seed, start_step=step))
    b.pop("step")
    # ragged profile bags too (the stream's are full)
    b["profile_mask"][::3, 1:] = False
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


@pytest.fixture(scope="module")
def small():
    return _models()


@pytest.mark.parametrize("batch", [1, 16, 64])
def test_user_interests_match_jax(small, batch):
    jcfg, tcfg, jp, _, tp = small
    jb, tb = _batch(jcfg, batch)
    want = jax.jit(jm.user_interests, static_argnums=2)(jp, jb, jcfg)
    with torch.no_grad():
        got = tm.serve_user(tp, tb, tcfg)
    assert got.shape == (batch, jcfg.n_interests, jcfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INTERESTS)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_jax(mode):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(30, 8)).astype(np.float32)
    ids = rng.integers(0, 30, (5, 6)).astype(np.int32)
    mask = rng.uniform(size=(5, 6)) < 0.6
    mask[2] = False                                        # an empty bag
    want = jm.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask), mode=mode)
    got = tm.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(mask), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not got[2].any()


def test_squash_matches_jax_and_keeps_zero_finite():
    x = np.random.default_rng(2).normal(size=(3, 4, 5)).astype(np.float32)
    x[0, 0] = 0.0
    got = tm.squash(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.squash(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)
    assert torch.isfinite(got).all() and not got[0, 0].any()


def test_squash_takes_the_jax_axis_keyword():
    """``squash(x, axis=...)``, JAX's signature: capsules along axis 1."""
    x = np.random.default_rng(3).normal(size=(3, 4, 5)).astype(np.float32)
    got = tm.squash(torch.from_numpy(x), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.squash(jnp.asarray(x), axis=1)),
                               rtol=1e-6, atol=1e-7)
    assert not torch.allclose(got, tm.squash(torch.from_numpy(x)))


def test_mind_loss_and_gradients_match_jax(small):
    jcfg, tcfg, jp, _, tp = small
    jb, tb = _batch(jcfg, 32, seed=3)
    (jl, jmet), jg = jax.value_and_grad(jm.mind_loss, has_aux=True)(jp, jb, jcfg)
    tl, tmet = tm.mind_loss(tp, tb, tcfg)
    names = sorted(tp)
    tg = dict(zip(names, torch.autograd.grad(tl, [tp[k] for k in names])))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["acc"]), float(jmet["acc"]), rtol=0, atol=1e-7)
    for k in names:
        want = np.asarray(jg[k])
        np.testing.assert_allclose(tg[k].numpy(), want, rtol=0,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-30), err_msg=k)


@pytest.mark.parametrize("top_k", [1, 10, 100])
def test_retrieval_ids_match_jax(small, top_k):
    jcfg, tcfg, jp, _, tp = small
    jb, tb = _batch(jcfg, 1, seed=4)
    jb["cand_ids"] = jnp.arange(jcfg.n_items, dtype=jnp.int32)
    tb["cand_ids"] = torch.arange(tcfg.n_items, dtype=torch.int32)
    jv, jids = jm.retrieval_scores(jp, jb, jcfg, top_k=top_k)
    with torch.no_grad():
        tv, tids = tm.retrieval_scores(tp, tb, tcfg, top_k=top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    # a shuffled candidate subset returns the candidates' own ids
    sub = np.random.default_rng(5).permutation(jcfg.n_items)[:200].astype(np.int32)
    jb["cand_ids"], tb["cand_ids"] = jnp.asarray(sub), torch.from_numpy(sub)
    _, jids = jm.retrieval_scores(jp, jb, jcfg, top_k=min(top_k, 50))
    with torch.no_grad():
        _, tids = tm.retrieval_scores(tp, tb, tcfg, top_k=min(top_k, 50))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_init_mind_layout_and_params_cross_both_ways(small):
    jcfg, tcfg, jp, js, _ = small
    tp, ts = tm.init_mind(torch.Generator().manual_seed(0), tcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tp.items()} == \
        {k: (v.shape, torch.float32) for k, v in jp.items()}
    assert all(v.requires_grad for v in tp.values())
    assert {k: tuple(s) for k, s in ts.items()} == {k: tuple(s) for k, s in js.items()}
    assert all(isinstance(s, PartitionSpec) for s in ts.values())
    back = mind_params_to_jax(mind_params_from_jax(jax.tree.map(np.asarray, jp)))
    assert all(np.array_equal(back[k], np.asarray(jp[k])) for k in jp)


def test_three_train_steps_match_jax():
    jcfg, tcfg, jp, _, tp = _models()
    jo = jopt.make_optimizer("adamw", jopt.warmup_cosine(1e-2, 2, 100))
    to = topt.make_optimizer("adamw", topt.warmup_cosine(1e-2, 2, 100))
    jstep = jax.jit(jax_make_step(lambda p, b: jm.mind_loss(p, b, jcfg), jo))
    tstep = make_train_step(lambda p, b: tm.mind_loss(p, b, tcfg), to)
    js, ts = jax_init_state(jp, jo), init_train_state(tp, to)
    for i in range(3):
        jb, tb = _batch(jcfg, 32, seed=6, step=i)
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
    for k, want in js.params.items():
        want = np.asarray(want)
        np.testing.assert_allclose(ts.params[k].detach().numpy(), want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=k)


def test_published_config_and_smoke_trainer():
    cfg = get_arch("mind").make_config()
    assert (cfg.n_items, cfg.embed_dim, cfg.n_interests, cfg.capsule_iters, cfg.hist_len,
            cfg.n_profile_feats, cfg.n_negatives) == (1_000_000, 64, 4, 3, 50, 100_000, 1279)
    step_fn, state, batches = ttrain.build_smoke_trainer("mind", device="cpu")
    for _ in range(2):
        state, metrics = step_fn(state, next(batches))
    assert int(state.step) == 2 and np.isfinite(float(metrics["loss"]))
