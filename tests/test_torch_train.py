"""The port's training path (``repro_torch.optim``, ``repro_torch.train``,
``repro_torch.configs``, ``repro_torch.launch.train``) against the JAX
package's on the CPU.

Tolerances: the schedule, clipping and five optimizer steps on the same
grads rtol 1e-6 (atol 1e-9 for entries near 0): the same float32 formulas,
evaluated in other orders by two compilers.  Three train steps rtol 1e-4
(atol 1e-6): the gradients come from two autodiff systems, and AdamW's
first steps divide by sqrt(nu) ~ |g|, which lifts their last-bit
differences.  Checkpoints cross the packages exactly.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.launch import train as jtrain
from repro.models import gnn as jgnn
from repro.optim import optimizers as jopt
from repro.train import init_train_state as jax_init_state
from repro.train import make_train_step as jax_make_step

from repro_torch.checkpoint import load_checkpoint, restore_onto_mesh, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.convert import gnn_params_from_jax
from repro_torch.data import synthetic_graph
from repro_torch.launch import train as ttrain
from repro_torch.models import gnn as tgnn
from repro_torch.optim import optimizers as topt
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import flatten_with_path, tree_map

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(rtol=1e-6, atol=1e-9)
STEP = dict(rtol=1e-4, atol=1e-6)


def _np_tree(rng):
    """A parameter-shaped tree: matrices, vectors and a scalar (GIN's eps)."""
    return {"layers": [{"w": rng.normal(size=(6, 4)).astype(np.float32),
                        "b": rng.normal(size=(4,)).astype(np.float32)},
                       {"eps": np.float32(rng.normal())}],
            "out": {"w": rng.normal(size=(4, 3)).astype(np.float32)}}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _assert_tree_close(got, want, tol):
    got = {k: np.asarray(v) for k, v in _flat(got).items()}
    want = {k: np.asarray(v) for k, v in _flat(want).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


def _flat(tree):
    """{key path: leaf} of a port tree (tensors) or a JAX tree (arrays)."""
    if any(isinstance(v, torch.Tensor) for _, v in flatten_with_path(tree)):
        return {"/".join(p): v.detach() for p, v in flatten_with_path(tree)}
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("peak,warmup,total", [(1e-2, 20, 10_000), (3e-4, 0, 100), (1.0, 5, 5)])
def test_warmup_cosine_matches_jax(peak, warmup, total):
    jlr, tlr = jopt.warmup_cosine(peak, warmup, total), topt.warmup_cosine(peak, warmup, total)
    steps = [0, 1, 4, 5, 19, 20, 21, 57, 99, 100, 5000, 10_000, 20_000]
    got = [float(tlr(torch.tensor(s, dtype=torch.int32))) for s in steps]
    want = [float(jlr(jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, **OPT)
    np.testing.assert_allclose(float(tlr(57)), want[steps.index(57)], **OPT)  # an int step


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _np_tree(np.random.default_rng(0))
    jg, jn = jopt.clip_by_global_norm(_to_jax(g), max_norm)
    tg, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **OPT)
    _assert_tree_close(tg, jg, OPT)


def test_clip_of_zero_grads_is_zero():
    g = tree_map(torch.zeros_like, _to_torch(_np_tree(np.random.default_rng(0))))
    out, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == 0.0 and all(not bool(v.any()) for _, v in flatten_with_path(out))


@pytest.mark.parametrize("kind,kw", [
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.0, "b1": 0.8}),
    ("adafactor", {}),
    ("adafactor", {"weight_decay": 0.01}),
    ("sgd", {}),
    ("sgd", {"nesterov": True}),
])
def test_five_optimizer_steps_match_jax(kind, kw):
    """Five updates on the same grads; params moved by each, state compared
    leaf for leaf (the same tree layout)."""
    rng = np.random.default_rng(1)
    p = _np_tree(rng)
    jo = jopt.make_optimizer(kind, jopt.warmup_cosine(1e-2, 2, 50), **kw)
    to = topt.make_optimizer(kind, topt.warmup_cosine(1e-2, 2, 50), **kw)
    jp, tp = _to_jax(p), _to_torch(p)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = jax.tree.map(lambda a: rng.normal(size=np.shape(a)).astype(np.float32), p)
        ju, js = jo.update(_to_jax(g), js, jp, jnp.int32(step))
        tu, ts = to.update(_to_torch(g), ts, tp, torch.tensor(step, dtype=torch.int32))
        jp = jax.tree.map(lambda a, u: a + u, jp, ju)
        tp = tree_map(lambda a, u: a + u, tp, tu)
        _assert_tree_close(tu, ju, OPT)
    _assert_tree_close(tp, jp, OPT)
    _assert_tree_close(ts, js, OPT)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lion", topt.warmup_cosine(1e-3, 1, 10))


# -- the train step ----------------------------------------------------------

def _mlp_losses():
    """The same two-layer regression loss in both frameworks."""
    def jloss(p, b):
        h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
        err = h @ p["w2"] - b["y"]
        loss = jnp.mean(err * err)
        return loss, {"loss": loss, "err_max": jnp.max(jnp.abs(err))}

    def tloss(p, b):
        h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
        err = h @ p["w2"] - b["y"]
        loss = torch.mean(err * err)
        return loss, {"loss": loss, "err_max": torch.max(torch.abs(err))}

    rng = np.random.default_rng(2)
    p = {"w1": rng.normal(size=(5, 7)).astype(np.float32) * 0.5,
         "b1": np.zeros(7, np.float32),
         "w2": rng.normal(size=(7, 2)).astype(np.float32) * 0.5}
    batches = [{"x": rng.normal(size=(8, 5)).astype(np.float32),
                "y": rng.normal(size=(8, 2)).astype(np.float32)} for _ in range(3)]
    return jloss, tloss, p, batches


def _gnn_losses():
    kw = dict(name="gcn-t", kind="gcn", n_layers=2, d_hidden=8, d_feat=8, n_classes=3)
    jcfg, tcfg = jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)
    jp, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    model = tgnn.GNN(tcfg, device="cpu")
    model.load_state_dict(gnn_params_from_jax(jax.tree.map(np.asarray, jp)))
    g = synthetic_graph(n_nodes=40, n_edges=160, d_feat=8, n_classes=3, seed=3)
    return (lambda p, b: jgnn.loss_gnn(p, b, jcfg), lambda p, b: tgnn.loss_gnn(p, b, tcfg),
            jax.tree.map(np.asarray, jp), [g] * 3)


@pytest.mark.parametrize("model,microbatches", [("mlp", 1), ("mlp", 2), ("mlp", 4), ("gcn", 1)])
def test_three_train_steps_match_jax(model, microbatches):
    jloss, tloss, p, batches = (_mlp_losses if model == "mlp" else _gnn_losses)()
    jo = jopt.make_optimizer("adamw", jopt.warmup_cosine(1e-2, 2, 100))
    to = topt.make_optimizer("adamw", topt.warmup_cosine(1e-2, 2, 100))
    jstep = jax.jit(jax_make_step(jloss, jo, microbatches=microbatches))
    tstep = make_train_step(tloss, to, microbatches=microbatches)
    js = jax_init_state(_to_jax(p), jo)
    ts = init_train_state(tree_map(lambda a: torch.tensor(a).requires_grad_(), p), to)
    for b in batches:
        js, jm = jstep(js, _to_jax(b))
        ts, tm = tstep(ts, {k: torch.as_tensor(v) for k, v in b.items()})
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **STEP, err_msg=k)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    _assert_tree_close(ts.params, js.params, STEP)
    _assert_tree_close(ts.opt_state, js.opt_state, STEP)


def test_train_step_updates_the_parameters_in_place():
    _, tloss, p, batches = _mlp_losses()
    to = topt.make_optimizer("adamw", topt.warmup_cosine(1e-2, 2, 100))
    params = tree_map(lambda a: torch.tensor(a).requires_grad_(), p)
    before = {k: v.detach().clone() for k, v in params.items()}
    state, metrics = make_train_step(tloss, to)(init_train_state(params, to),
                                               {k: torch.as_tensor(v) for k, v in batches[0].items()})
    assert state.params is params and all(state.params[k] is params[k] for k in params)
    assert all(not torch.equal(params[k].detach(), before[k]) for k in params)
    assert float(metrics["grad_norm"]) > 0 and not metrics["loss"].requires_grad


def test_microbatches_must_divide_the_batch():
    _, tloss, p, batches = _mlp_losses()
    to = topt.make_optimizer("sgd", topt.warmup_cosine(1e-2, 2, 100))
    step = make_train_step(tloss, to, microbatches=3)
    with pytest.raises(ValueError, match="not a multiple"):
        step(init_train_state(tree_map(lambda a: torch.tensor(a).requires_grad_(), p), to),
             {k: torch.as_tensor(v) for k, v in batches[0].items()})


# -- configs and the smoke trainer --------------------------------------------

@pytest.mark.parametrize("arch_id", ["gcn-cora", "gin-tu", "pna", "nequip", "yi-9b",
                                     "qwen2-1.5b", "llama3-405b", "deepseek-v2-236b",
                                     "arctic-480b", "mind"])
def test_smoke_trainer_one_step(arch_id):
    """The counterpart of ``tests/test_configs_and_smoke.py::test_arch_smoke_one_train_step``."""
    step_fn, state, batches = ttrain.build_smoke_trainer(arch_id, seed=0, device="cpu")
    before = {k: v.detach().clone() for k, v in _flat(state.params).items()}
    state2, metrics = step_fn(state, next(iter(batches)))
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2.step) == 1
    after = _flat(state2.params)
    moved = sum(float((after[k] - before[k]).abs().sum()) for k in before)
    assert np.isfinite(moved) and moved > 0
    assert not any(bool(torch.isnan(v).any()) for v in after.values())


@pytest.mark.parametrize("arch_id", ["gcn-cora", "gin-tu", "pna"])
def test_published_and_smoke_configs_match_jax(arch_id):
    from repro.configs import get_arch as jax_get_arch

    ja, ta = jax_get_arch(arch_id), get_arch(arch_id)
    for make in ("make_config", "smoke_config"):
        jc, tc = getattr(ja, make)(), getattr(ta, make)()
        for f in ("name", "kind", "n_layers", "d_hidden", "d_feat", "n_classes", "aggregator",
                  "learnable_eps", "avg_degree", "dropout", "batch_axes"):
            assert getattr(tc, f) == getattr(jc, f), (make, f)
        assert tc.param_dtype == tc.compute_dtype == torch.float32
    assert (ta.family, ta.source, ta.optimizer, ta.learning_rate, ta.microbatches) == \
        (ja.family, ja.source, ja.optimizer, ja.learning_rate, ja.microbatches)
    assert {k: (c.kind, c.settings) for k, c in ta.cells.items()} == \
        {k: (c.kind, c.settings) for k, c in ja.cells.items()}
    assert ta.make_config(d_feat=1441).d_feat == 1441


def _jax_dtype_name(dt):
    return dt.dtype.name if hasattr(dt, "dtype") else str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch_id", ["yi-9b", "qwen2-1.5b", "llama3-405b", "deepseek-v2-236b",
                                     "arctic-480b", "mind"])
def test_lm_and_mind_configs_match_jax_field_by_field(arch_id):
    """The five LMs' and MIND's ArchDefs letter for letter: every field of
    the published and smoke configs (dtypes by name), family, source,
    optimizer, learning rate, microbatches, notes and cells."""
    import dataclasses

    from repro.configs import get_arch as jax_get_arch

    ja, ta = jax_get_arch(arch_id), get_arch(arch_id)
    for make in ("make_config", "smoke_config"):
        jc, tc = getattr(ja, make)(), getattr(ta, make)()
        assert type(tc).__name__ == type(jc).__name__
        assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
        for f in dataclasses.fields(jc):
            want, got = getattr(jc, f.name), getattr(tc, f.name)
            if f.name.endswith("dtype"):
                assert str(got) == f"torch.{_jax_dtype_name(want)}", (make, f.name)
            else:
                assert got == want, (make, f.name)
    assert (ta.family, ta.source, ta.optimizer, ta.learning_rate, ta.microbatches, ta.notes) == \
        (ja.family, ja.source, ja.optimizer, ja.learning_rate, ja.microbatches, ja.notes)
    assert {k: (c.shape_id, c.kind, c.settings, c.skip_reason) for k, c in ta.cells.items()} == \
        {k: (c.shape_id, c.kind, c.settings, c.skip_reason) for k, c in ja.cells.items()}


def test_unknown_arch_raises_key_error_and_apsp_has_no_trainer():
    from repro.configs import ARCH_IDS as JAX_IDS
    from repro.configs import ASSIGNED_IDS as JAX_ASSIGNED
    from repro_torch.configs import ASSIGNED_IDS

    with pytest.raises(KeyError):
        get_arch("gpt-5")
    assert set(ARCH_IDS) == set(JAX_IDS) and ARCH_IDS == list(JAX_IDS)
    assert ASSIGNED_IDS == JAX_ASSIGNED
    assert get_arch("apsp").make_config().n == 16384
    with pytest.raises(ValueError, match="no smoke trainer for family apsp"):
        ttrain.build_smoke_trainer("apsp", device="cpu")


# -- checkpoints across the packages ---------------------------------------

def _args(d, steps):
    return ["--arch", "gcn-cora", "--steps", str(steps), "--ckpt-dir", str(d),
            "--ckpt-every", "3", "--log-every", "3"]


def _params_at(d, step):
    flat, _ = load_checkpoint(str(d), step)
    return {k: v for k, v in flat.items() if k.startswith("params/")}


def test_train_state_checkpoint_keys_are_jax_keys(tmp_path):
    _, jstate, _ = jtrain.build_smoke_trainer("gcn-cora")
    _, tstate, _ = ttrain.build_smoke_trainer("gcn-cora", device="cpu")
    from repro.checkpoint import save_checkpoint as jax_save

    jax_save(str(tmp_path / "j"), 1, jstate)
    save_checkpoint(str(tmp_path / "t"), 1, tstate)
    jflat, jman = jax_load_checkpoint(str(tmp_path / "j"), 1)
    tflat, tman = load_checkpoint(str(tmp_path / "t"), 1)
    assert jman["keys"] == tman["keys"] and "step" in tman["keys"]
    assert not any(k.startswith("err") for k in tman["keys"])
    assert all(jflat[k].dtype == tflat[k].dtype and jflat[k].shape == tflat[k].shape
               for k in jflat)
    back = restore_onto_mesh(jflat, tstate, device="cpu")
    assert all(np.array_equal(v.detach().numpy(), jflat["/".join(p)])
               for p, v in flatten_with_path(back))
    assert all(v.requires_grad for _, v in flatten_with_path(back.params))
    with pytest.raises(ValueError, match="sharding tree does not match"):
        restore_onto_mesh(jflat, tstate, shardings={}, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        restore_onto_mesh({k: v for k, v in jflat.items() if k != "step"}, tstate, device="cpu")


def test_jax_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """JAX trains 6 steps; the port resumes at step 6 with JAX's params and
    trains to 9, where it lands on what JAX itself reaches at 9."""
    d, twin = tmp_path / "run", tmp_path / "jax_twin"
    assert jtrain.main(_args(d, 6)) == 0
    shutil.copytree(d, twin)
    flat, _ = load_checkpoint(str(d), 6)
    _, state, _ = ttrain.build_smoke_trainer("gcn-cora", device="cpu")
    restored = restore_onto_mesh(flat, state, device="cpu")
    assert all(np.array_equal(v.detach().numpy(), flat["params/" + "/".join(p)])
               for p, v in flatten_with_path(restored.params))
    capsys.readouterr()
    assert ttrain.main(_args(d, 9) + ["--device", "cpu"]) == 0
    assert "[resume] restored step 6" in capsys.readouterr().out
    assert jtrain.main(_args(twin, 9)) == 0
    got, want = _params_at(d, 9), _params_at(twin, 9)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP, err_msg=k)


def test_port_checkpoint_resumes_in_jax(tmp_path, capsys):
    d, twin = tmp_path / "run", tmp_path / "port_twin"
    assert ttrain.main(_args(d, 6) + ["--device", "cpu"]) == 0
    shutil.copytree(d, twin)
    capsys.readouterr()
    assert jtrain.main(_args(d, 9)) == 0
    assert "[resume] restored step 6" in capsys.readouterr().out
    assert ttrain.main(_args(twin, 9) + ["--device", "cpu"]) == 0
    got, want = _params_at(d, 9), _params_at(twin, 9)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **STEP, err_msg=k)


def test_train_driver_checkpoint_resume(tmp_path):
    """The counterpart of ``tests/test_distributed_and_driver.py::
    test_train_driver_checkpoint_resume``, on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for steps in (6, 9):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                           + _args(tmp_path, steps) + ["--device", "cpu"],
                           capture_output=True, text=True, timeout=300, env=env)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    assert "[resume]" not in outs[0] and "[done] 6 steps" in outs[0]
    assert "[resume] restored step 6" in outs[1] and "[done] 9 steps" in outs[1]


def test_watchdog_straggler_exits_75_after_checkpointing(tmp_path, capsys, monkeypatch):
    real = ttrain.build_smoke_trainer

    def slow(*a, **kw):
        step_fn, state, batches = real(*a, **kw)

        def stalled(s, b):
            import time
            time.sleep(0.5)
            return step_fn(s, b)

        return stalled, state, batches

    monkeypatch.setattr(ttrain, "build_smoke_trainer", slow)
    rc = ttrain.main(_args(tmp_path, 4) + ["--device", "cpu", "--step-timeout", "0.1"])
    assert rc == 75 and "[straggler]" in capsys.readouterr().out
    flat, man = load_checkpoint(str(tmp_path))
    assert man["extra"]["data_step"] == 0 and int(flat["step"]) == 0
