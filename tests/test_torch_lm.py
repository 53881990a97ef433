"""The port's LM substrate (``repro_torch.models.{layers, kvcache, moe, mla,
transformer}``) against ``repro.models`` on the CPU, for the six variants
of ``tests/test_models_lm.py`` (an own copy), float32, with the JAX
parameters carried across (``core.convert.lm_params_from_jax``).

Tolerances: logits atol 1e-4 and caches atol 1e-5 (the same float32
formulas, the einsums summed in other orders by two compilers); each
gradient leaf within 1e-4 of its largest magnitude; ``moe_ffn``'s output
atol 1e-5 and aux loss rtol 1e-6 (float32 router and means, the routing
decisions themselves equal: inputs are drawn without ties, where
``torch.topk`` and ``lax.top_k`` may order differently); the bf16 case
within 3e-2 of the largest logit (bf16 rounding of every activation, in
two orders).  Three train steps: loss rtol 1e-5, each parameter leaf
within 1e-4 of its largest magnitude (AdamW normalises each element's
update: an element whose gradient is at float32 noise level in both
frameworks moves by a different fraction of the learning rate in each, so
an element-wise rtol fails on a few of 65536 expert weights by 6e-4 while
the leaf agrees to 1e-5 of its scale).  JAX functions are jitted once a
variant (module-scoped fixtures).
"""

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as jkv
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.optim import optimizers as jopt
from repro.train import init_train_state as jax_init_state
from repro.train import make_train_step as jax_make_step

from repro_torch.core.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.optim import optimizers as topt
from repro_torch.sharding import PartitionSpec
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import flatten_with_path, tree_map

BASE = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=97, attn_chunk=8)
VARIANTS = {
    "dense-gqa": dict(),
    "qwen-like": dict(qkv_bias=True, tie_embeddings=True),
    "moe-shared-prefix": dict(moe=True, n_experts=8, moe_top_k=2, moe_d_ff=64,
                              n_shared_experts=1, first_k_dense=1, moe_group=16),
    "arctic-like": dict(moe=True, n_experts=4, moe_top_k=2, moe_d_ff=64, residual_dense=True,
                        moe_group=16),
    "mla": dict(mla=True, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, n_kv_heads=4),
    "deepseek-like": dict(mla=True, q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16, moe=True, n_experts=8,
                          moe_top_k=2, moe_d_ff=64, n_shared_experts=2, first_k_dense=1,
                          moe_group=16, n_kv_heads=4),
}
B, S, MAX_LEN = 2, 16, 32
LOGITS, CACHE = dict(rtol=0, atol=1e-4), dict(rtol=0, atol=1e-5)


def _cfgs(name, **over):
    kw = {**BASE, **VARIANTS[name], **over}
    return (jt.LMConfig(name=name, param_dtype=jnp.float32, compute_dtype=jnp.float32, **kw),
            tt.LMConfig(name=name, param_dtype=torch.float32, compute_dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=None)
def _jax_init(name, param_dtype="float32"):
    """(JAX params, specs) of a variant, drawn once a module (the
    parameters do not depend on the execution fields the tests vary,
    loss_chunk and compute_dtype)."""
    jcfg = dataclasses.replace(_cfgs(name)[0], param_dtype=jnp.dtype(param_dtype))
    box = {}

    def init(key):                  # under jit: faster here than eager
        p, box["specs"] = jt.init_lm(key, jcfg)
        return p

    return jax.jit(init)(jax.random.PRNGKey(0)), box["specs"]


def _tokens(seed=1, s=S):
    return np.random.default_rng(seed).integers(0, BASE["vocab"], (B, s)).astype(np.int32)


def _flat_jax(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {"/".join(p): v.detach().numpy() for p, v in flatten_with_path(tree)}


def _close_to_scale(got: dict, want: dict, rel: float):
    """Each leaf within ``rel`` times its largest magnitude."""
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=rel * scale, err_msg=k)


@pytest.fixture(params=sorted(VARIANTS), scope="module")
def variant(request):
    name = request.param
    jcfg, tcfg = _cfgs(name)
    jp, js = _jax_init(name)
    tp = tree_map(lambda t: t.requires_grad_(), lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    return name, jcfg, tcfg, jp, js, tp


def test_forward_logits_match_jax(variant):
    name, jcfg, tcfg, jp, _, tp = variant
    toks = _tokens()
    jlog, jaux = jax.jit(jt.forward, static_argnums=2)(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tlog, taux = tt.forward(tp, torch.from_numpy(toks), tcfg)
        hidden, _ = tt.forward(tp, torch.from_numpy(toks), tcfg, return_hidden=True)
    assert tlog.dtype == torch.float32 and tlog.shape == (B, S, BASE["vocab"])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGITS)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5, atol=1e-7)
    assert hidden.shape == (B, S, BASE["d_model"])


def _loss_and_grads(jcfg, tcfg, jp, tp, toks, labels):
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jl_, jm), jg = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                            static_argnums=2)(jp, jbatch, jcfg)
    tl_, tm = tt.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)}, tcfg)
    leaves = [v for _, v in flatten_with_path(tp)]
    tg = dict(zip(["/".join(p) for p, _ in flatten_with_path(tp)],
                  (g.numpy() for g in torch.autograd.grad(tl_, leaves))))
    return (jl_, jm, _flat_jax(jg)), (tl_, tm, tg)


def test_loss_and_gradients_match_jax(variant):
    name, jcfg, tcfg, jp, _, tp = variant
    toks = _tokens()
    labels = np.roll(toks, -1, axis=1)
    (jl_, jm, jg), (tl_, tm, tg) = _loss_and_grads(jcfg, tcfg, jp, tp, toks, labels)
    for k in ("loss", "aux", "total"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(tl_.detach()), float(jl_), rtol=1e-5)
    _close_to_scale(tg, jg, 1e-4)
    assert any(np.abs(g).max() > 0 for g in tg.values())


@pytest.mark.parametrize("name,chunk", [("deepseek-like", 5), ("qwen-like", 5),
                                        ("qwen-like", 16)])
def test_loss_chunk_branch_matches_jax(name, chunk):
    """``loss_chunk`` 5 on 16 positions (a ragged tail of 1, labels padded
    with -1) and 16 (one chunk), untied and tied heads, MoE aux included."""
    jcfg, tcfg = _cfgs(name, loss_chunk=chunk)
    jp, _ = _jax_init(name)
    tp = tree_map(lambda t: t.requires_grad_(),
                  lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    toks = _tokens(3)
    labels = np.roll(toks, -1, axis=1)
    (jl_, jm, jg), (tl_, tm, tg) = _loss_and_grads(jcfg, tcfg, jp, tp, toks, labels)
    np.testing.assert_allclose(float(tl_.detach()), float(jl_), rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"].detach()), float(jm["loss"]), rtol=1e-5)
    _close_to_scale(tg, jg, 1e-4)
    # the chunked loss is the whole-sequence loss
    with torch.no_grad():
        whole = tt.loss_fn(tp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)},
                           dataclasses.replace(tcfg, loss_chunk=0))[0]
    np.testing.assert_allclose(float(tl_.detach()), float(whole), rtol=1e-5)


def _caches_close(tc, jc, mla):
    names = ("ckv", "kpe") if mla else ("k", "v")
    for f in names:
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), **CACHE,
                                   err_msg=f)
    assert tc.length.dtype == torch.int32
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_prefill_and_two_decode_steps_match_jax(variant):
    name, jcfg, tcfg, jp, _, tp = variant
    toks = _tokens()
    jprefill = jax.jit(partial(jt.prefill, cfg=jcfg, max_len=MAX_LEN))
    jdecode = jax.jit(partial(jt.decode_step, cfg=jcfg))
    jlast, jcache = jprefill(jp, jnp.asarray(toks))
    with torch.no_grad():
        tlast, tcache = tt.prefill(tp, torch.from_numpy(toks), tcfg, MAX_LEN)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **LOGITS)
    _caches_close(tcache, jcache, tcfg.mla)
    nxt = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    for _ in range(2):
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(nxt))
        with torch.no_grad():
            tlg, tcache = tt.decode_step(tp, tcache, torch.from_numpy(nxt), tcfg)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **LOGITS)
        _caches_close(tcache, jcache, tcfg.mla)
        nxt = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
    assert bool((tcache.length == S + 2).all())


def test_specs_mirror_params(variant):
    """The spec tree has the params' structure, one PartitionSpec a leaf no
    longer than the leaf's rank, each the reference's."""
    name, jcfg, tcfg, jp, js, tp = variant
    _, tspecs = tt.init_lm(torch.Generator().manual_seed(0), tcfg)
    pp = dict(flatten_with_path(tp))
    ss = dict(flatten_with_path(tspecs))
    assert set(pp) == set(ss)
    for path, spec in ss.items():
        assert isinstance(spec, PartitionSpec) and len(spec) <= pp[path].ndim
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(s)
             for path, s in jax.tree_util.tree_flatten_with_path(
                 js, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert {"/".join(p): tuple(s) for p, s in ss.items()} == jflat


def test_init_lm_has_the_jax_layout(variant):
    """Shapes, dtypes and keys equal JAX's; stacked leaves lead with the
    stack's depth; the module's state_dict keys are the tree paths; the
    params cross both ways bit for bit."""
    name, jcfg, tcfg, jp, _, tp = variant
    model = tt.LM(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = {"/".join(p): (tuple(v.shape), v.dtype) for p, v in flatten_with_path(model.tree())}
    want = {k: (v.shape, torch.float32) for k, v in _flat_jax(jp).items()}
    assert got == want
    n_stack = tcfg.n_layers - (tcfg.first_k_dense if tcfg.moe else 0)
    assert all(v.shape[0] == n_stack for _, v in flatten_with_path(model.tree()["layers"]))
    assert set(model.state_dict()) == {k.replace("/", ".") for k in want}
    assert ("lm_head" in model.tree()) == (not tcfg.tie_embeddings)
    back = lm_params_to_jax(tp)
    assert all(np.array_equal(back_v, _flat_jax(jp)[k])
               for k, back_v in _flat_jax(back).items())


def test_params_cross_in_bf16_bit_for_bit():
    jp, _ = _jax_init("deepseek-like", "bfloat16")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    assert all(v.dtype == torch.bfloat16 or "router" in "/".join(p)
               for p, v in flatten_with_path(tp))
    back = _flat_jax(lm_params_to_jax(tp))
    for k, v in _flat_jax(jp).items():
        want = v.view(np.uint16) if v.dtype.name == "bfloat16" else v
        assert np.array_equal(back[k], want), k


def test_bf16_compute_matches_jax_within_bf16():
    jcfg, tcfg = _cfgs("qwen-like")
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    jp, _ = _jax_init("qwen-like")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    toks = _tokens()
    jlog, _ = jax.jit(jt.forward, static_argnums=2)(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tlog, _ = tt.forward(tp, torch.from_numpy(toks), tcfg)
    scale = float(np.abs(np.asarray(jlog)).max())
    assert float(np.abs(tlog.numpy() - np.asarray(jlog)).max()) <= 3e-2 * scale


# -- layers ------------------------------------------------------------------

def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["causal", "causal_offset", "offsets_per_row", "kv_len",
                                  "kv_len_not_causal", "none"])
@pytest.mark.parametrize("chunk", [None, 5])
def test_attention_masks_match_jax(mode, chunk):
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 11, 4, 8), _rand(rng, 2, 13, 2, 8), _rand(rng, 2, 13, 2, 6)
    kw = {"causal": mode.startswith("causal") or mode in ("offsets_per_row", "kv_len"),
          "chunk": chunk}
    if mode == "causal_offset":
        kw["q_offset"] = 2
    if mode == "offsets_per_row":
        kw["q_offset"] = np.array([0, 2], np.int32)
    if mode.startswith("kv_len"):
        kw["kv_len"] = np.array([5, 13], np.int32)
    jkw = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_ for k_, v_ in kw.items()}
    tkw = {k_: torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_ for k_, v_ in kw.items()}
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    got = tl.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    whole = tl.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         **{**tkw, "chunk": None})
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0, atol=1e-6)


def test_fully_masked_row_is_the_mean_of_v():
    """kv_len 0: every score is -1e30, the softmax uniform, as the reference's."""
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 1, 3, 2, 4), _rand(rng, 1, 6, 2, 4), _rand(rng, 1, 6, 2, 4)
    got = tl.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       causal=False, kv_len=torch.tensor([0]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[0, 0], v[0].mean(0), rtol=1e-5, atol=1e-6)


def test_attention_chunks_backward_matches_unchunked():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 9, 4, 8)).requires_grad_(),
               torch.from_numpy(_rand(rng, 2, 9, 2, 8)).requires_grad_(),
               torch.from_numpy(_rand(rng, 2, 9, 2, 8)).requires_grad_())
    grads = []
    for chunk in (None, 4):
        out = tl.attention(q, k, v, causal=True, chunk=chunk)
        grads.append(torch.autograd.grad((out * out).sum(), (q, k, v)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_rope_norms_and_swiglu_match_jax():
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 5, 3, 8)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
            np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), rtol=0, atol=1e-5)
    h = _rand(rng, 3, 4, 16)
    p = {"scale": _rand(rng, 16), "bias": _rand(rng, 16)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(tl.rmsnorm(tp, torch.from_numpy(h)).numpy(),
                               np.asarray(jl.rmsnorm(jp, jnp.asarray(h))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.layernorm(tp, torch.from_numpy(h)).numpy(),
                               np.asarray(jl.layernorm(jp, jnp.asarray(h))), rtol=1e-5, atol=1e-6)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    assert tl.rmsnorm(tp, hb).dtype == torch.bfloat16
    w = {"wg": _rand(rng, 16, 24) / 4, "wu": _rand(rng, 16, 24) / 4, "wd": _rand(rng, 24, 16) / 5}
    np.testing.assert_allclose(
        tl.swiglu({k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(h)).numpy(),
        np.asarray(jl.swiglu({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(h))),
        rtol=0, atol=1e-5)
    tab = _rand(rng, 10, 16)
    ids = np.array([[1, 9, 0]], np.int32)
    np.testing.assert_array_equal(
        tl.embed({"table": torch.from_numpy(tab)}, torch.from_numpy(ids), torch.float32).numpy(),
        np.asarray(jl.embed({"table": jnp.asarray(tab)}, jnp.asarray(ids), jnp.float32)))
    assert tl.constrain(hb, PartitionSpec("data")) is hb


@pytest.mark.parametrize("lengths", [[0, 3], [5, 7], [8, 8], [2, 8]])
def test_cache_updates_match_jax_including_a_full_cache(lengths):
    """Length 8 = T: that sequence writes nothing, in both packages."""
    rng = np.random.default_rng(8)
    lens = np.array(lengths, np.int32)
    layer, new_l = _rand(rng, 2, 8, 3, 4), _rand(rng, 2, 1, 3, 4)
    stack, new_s = _rand(rng, 3, 2, 8, 5), _rand(rng, 3, 2, 1, 5)
    got = tkv.cache_update_layer(torch.from_numpy(layer), torch.from_numpy(new_l),
                                 torch.from_numpy(lens))
    want = jkv.cache_update_layer(jnp.asarray(layer), jnp.asarray(new_l), jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tkv.cache_update_stack(torch.from_numpy(stack), torch.from_numpy(new_s),
                                 torch.from_numpy(lens))
    want = jkv.cache_update_stack(jnp.asarray(stack), jnp.asarray(new_s), jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    buf = torch.from_numpy(layer.copy())
    assert tkv.cache_write_(buf, torch.from_numpy(new_l), torch.from_numpy(lens), 1) is buf
    np.testing.assert_array_equal(buf.numpy(), np.asarray(
        jkv.cache_update_layer(jnp.asarray(layer), jnp.asarray(new_l), jnp.asarray(lens))))


def test_decode_against_a_full_cache_matches_jax():
    """A sequence whose cache is full writes nothing and still attends to
    every slot, in both packages."""
    jcfg, tcfg = _cfgs("dense-gqa")
    jp, _ = _jax_init("dense-gqa")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp))
    toks = _tokens(9)
    jlast, jc = jt.prefill(jp, jnp.asarray(toks), jcfg, S)
    with torch.no_grad():
        _, tc = tt.prefill(tp, torch.from_numpy(toks), tcfg, S)
    nxt = np.asarray(jnp.argmax(jlast, -1))[:, None].astype(np.int32)
    jlg, jc2 = jt.decode_step(jp, jc, jnp.asarray(nxt), jcfg)
    with torch.no_grad():
        tlg, tc2 = tt.decode_step(tp, tc, torch.from_numpy(nxt), tcfg)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **LOGITS)
    _caches_close(tc2, jc2, False)


def test_moe_routing_and_output_match_jax():
    jcfg, tcfg = _cfgs("moe-shared-prefix", moe_capacity_factor=0.5)
    rng = np.random.default_rng(10)
    d, e = BASE["d_model"], 8
    p = {"router": _rand(rng, d, e) / 8, "wg": _rand(rng, e, d, 64) / 8,
         "wu": _rand(rng, e, d, 64) / 8, "wd": _rand(rng, e, 64, d) / 8}
    x = _rand(rng, 2, 24, d)                       # 48 tokens: groups of 16, capacity 4
    jout, jaux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tout, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    g, tg, cap = tmoe.moe_shape(48, tcfg)
    assert (g, tg, cap) == (3, 16, 4)
    # the reference's decisions (moe.py's router, top_k and cumsum ranks)
    xg = jnp.asarray(x).reshape(g, tg, d)
    probs = jax.nn.softmax(xg @ jnp.asarray(p["router"]), axis=-1)
    _, top_i = jax.lax.top_k(probs, 2)
    ohf = jax.nn.one_hot(top_i, e).reshape(g, tg * 2, e)
    pos = jnp.einsum("gse,gse->gs", jnp.cumsum(ohf, axis=1) - ohf, ohf).reshape(g, tg, 2)
    r = tmoe.moe_route(tp["router"], torch.from_numpy(x).reshape(g, tg, d), 2, cap)
    np.testing.assert_array_equal(r["top_i"].numpy(), np.asarray(top_i))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(pos < cap))
    assert not bool(r["keep"].all())               # some slots are dropped
    with tmoe.record_routing() as log:
        tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    assert [(int(a), int(b)) for a, b in log] == [(int(r["keep"].sum()), 96)]


@pytest.mark.parametrize("t,want", [(48, (3, 16, 8)), (7, (1, 7, 4)), (30, (2, 15, 4)),
                                    (1024, (64, 16, 8))])
def test_moe_group_and_capacity(t, want):
    _, tcfg = _cfgs("moe-shared-prefix")
    assert tmoe.moe_shape(t, tcfg) == want
    assert tmoe.moe_shape(4096, dataclasses.replace(
        tcfg, n_experts=160, moe_top_k=6, moe_group=1024)) == (4, 1024, 48)


# -- train steps ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_three_train_steps_match_jax(kind):
    """deepseek-like (MLA, MoE, the dense prefix list, stacked leaves that
    Adafactor factors and clips whole)."""
    jcfg, tcfg = _cfgs("deepseek-like")
    jp, _ = _jax_init("deepseek-like")
    tp = tree_map(lambda t: t.requires_grad_(), lm_params_from_jax(jax.tree.map(np.asarray, jp)))
    jo = jopt.make_optimizer(kind, jopt.warmup_cosine(2e-3, 2, 100))
    to = topt.make_optimizer(kind, topt.warmup_cosine(2e-3, 2, 100))
    jstep = jax.jit(jax_make_step(lambda p, b: jt.loss_fn(p, b, jcfg), jo))
    tstep = make_train_step(lambda p, b: tt.loss_fn(p, b, tcfg), to)
    js, ts = jax_init_state(jp, jo), init_train_state(tp, to)
    for i in range(3):
        toks = _tokens(20 + i)
        labels = np.roll(toks, -1, axis=1)
        js, jm = jstep(js, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close_to_scale(_flat_port(ts.params), _flat_jax(js.params), 1e-4)
    assert set(_flat_port(ts.opt_state)) == set(_flat_jax(js.opt_state))
