"""``repro_torch.models.nequip`` and the ``nequip`` trainer against
``repro.models.nequip`` on the CPU.

Tolerances: energy and forces rtol 1e-5 (atol 1e-6): the same float32
formulas with the JAX parameters carried across, the einsums and scatters
summed in other orders by two compilers.  Three train steps rtol 1e-4
(atol 1e-6), the ``STEP`` tolerance of ``tests/test_torch_train.py``: the
gradients come from two autodiff systems, AdamW's first steps divide by
sqrt(nu) ~ |g|, and the port evaluates the batch as one disjoint graph
where JAX ``vmap``s the molecules.  Rotation and translation leave the
energy unchanged within 1e-3 and the forces rotate with the positions, as
``tests/test_models_graph.py`` holds the reference.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models import nequip as jnq

from repro_torch.configs import get_arch
from repro_torch.core.convert import nequip_params_from_jax, nequip_params_to_jax
from repro_torch.launch import train as ttrain
from repro_torch.models import nequip as tnq
from repro_torch.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
ENERGY = dict(rtol=1e-5, atol=1e-6)
STEP = dict(rtol=1e-4, atol=1e-6)
SMALL = dict(name="nq", n_layers=3, d_hidden=8, n_rbf=4, n_species=4)


def _models(**kw):
    """(JAX cfg, JAX params, port cfg, port NequIP holding JAX's params)."""
    jcfg, tcfg = jnq.NequIPConfig(**kw), tnq.NequIPConfig(**kw)
    jp, _ = jnq.init_nequip(jax.random.PRNGKey(0), jcfg)
    model = tnq.NequIP(tcfg, device="cpu")
    model.load_state_dict(nequip_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, tcfg, model


def _molecule(rng, n=12, e=40, n_species=4, n_pad_edges=0, n_pad_atoms=0):
    """The reference test's shape; the last ``n_pad_edges`` edges and
    ``n_pad_atoms`` atoms masked out."""
    edge_mask = np.ones(e, bool)
    edge_mask[e - n_pad_edges:] = False
    node_mask = np.ones(n, bool)
    node_mask[n - n_pad_atoms:] = False
    return dict(positions=(rng.normal(size=(n, 3)) * 2).astype(np.float32),
                species=rng.integers(0, n_species, n).astype(np.int32),
                edge_index=rng.integers(0, n, (2, e)).astype(np.int32),
                edge_mask=edge_mask, node_mask=node_mask)


_jax_energy_forces = jax.jit(jnq.nequip_energy_forces, static_argnums=2)


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("pad_edges,pad_atoms", [(0, 0), (8, 0), (6, 3)])
def test_energy_and_forces_match_jax(pad_edges, pad_atoms):
    jcfg, jp, tcfg, model = _models(**SMALL)
    b = _molecule(np.random.default_rng(0), n_pad_edges=pad_edges, n_pad_atoms=pad_atoms)
    je, jf = _jax_energy_forces(jp, _jax(b), jcfg)
    te, tf = tnq.nequip_energy_forces(model.tree(), _torch(b), tcfg)
    np.testing.assert_allclose(float(te), float(je), **ENERGY)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **ENERGY)
    assert float(model(_torch(b)).detach()) == pytest.approx(float(te), rel=1e-6)


def test_params_cross_both_ways():
    _, jp, tcfg, model = _models(**SMALL)
    want = {"/".join(p): v for p, v in flatten_with_path(jax.tree.map(np.asarray, jp))}
    back = {"/".join(p): v for p, v in flatten_with_path(nequip_params_to_jax(model.state_dict()))}
    assert set(back) == set(want) and all(np.array_equal(back[k], want[k]) for k in want)
    fresh = tnq.NequIP(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh.state_dict()) == {k.replace("/", ".") for k in want}
    assert all(fresh.state_dict()[k.replace("/", ".")].shape == want[k].shape for k in want)


def test_se3_invariance_and_force_equivariance():
    """The counterpart of ``tests/test_models_graph.py::
    test_nequip_se3_invariance_and_force_equivariance``."""
    rng = np.random.default_rng(0)
    cfg = tnq.NequIPConfig(**SMALL)
    params = tnq.init_nequip(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _torch(_molecule(rng))
    pos = batch["positions"]
    e0 = tnq.nequip_energy(params, batch, cfg)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    t = rng.normal(size=(1, 3)) * 5
    pos2 = torch.from_numpy((pos.numpy() @ q.T + t).astype(np.float32))
    e1 = tnq.nequip_energy(params, {**batch, "positions": pos2}, cfg)
    assert abs(float(e0 - e1)) < 1e-3

    _, f = tnq.nequip_energy_forces(params, batch, cfg)
    _, f2 = tnq.nequip_energy_forces(params, {**batch, "positions": pos2}, cfg)
    err = np.abs(f2.numpy() - f.numpy() @ q.T).max()
    assert err < 0.1 * (np.abs(f.numpy()).max() + 1.0)


def test_padded_edges_are_inert():
    """The counterpart of ``tests/test_models_graph.py::test_nequip_padded_edges_inert``:
    rewiring masked edges changes nothing, and their self-edge gradients
    stay finite."""
    cfg = tnq.NequIPConfig(name="nq", n_layers=2, d_hidden=4, n_rbf=4, n_species=4)
    params = tnq.init_nequip(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _torch(_molecule(np.random.default_rng(1), n=8, e=20, n_pad_edges=6))
    e0 = tnq.nequip_energy(params, batch, cfg)
    b2 = dict(batch)
    b2["edge_index"] = batch["edge_index"].clone()
    b2["edge_index"][:, -6:] = 0
    e1, f1 = tnq.nequip_energy_forces(params, b2, cfg)
    assert abs(float(e0 - e1)) < 1e-5
    assert bool(torch.isfinite(f1).all())


def test_batch_energy_is_the_per_molecule_energy():
    """The disjoint-union batch equals each molecule alone (the reference's
    ``vmap``), on the trainer's stream."""
    from repro_torch.data import molecule_batch_stream

    cfg = get_arch("nequip").smoke_config()
    params = tnq.init_nequip(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = _torch({k: v for k, v in next(molecule_batch_stream(
        batch=4, n_atoms=8, n_edges=16, n_species=cfg.n_species, seed=2)).items() if k != "step"})
    got = tnq.nequip_energy_batch(params, b, cfg)
    want = torch.stack([tnq.nequip_energy(params, {k: b[k][i] for k in (
        "positions", "species", "edge_index", "edge_mask", "node_mask")}, cfg) for i in range(4)])
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **ENERGY)


def test_three_train_steps_match_jax():
    """The smoke trainers of both packages from JAX's initial parameters:
    loss, grad norm, parameters and AdamW's moments after three steps."""
    jstep, jstate, jbatches = jtrain.build_smoke_trainer("nequip")
    tstep, tstate, tbatches = ttrain.build_smoke_trainer("nequip", device="cpu")
    jp = {"/".join(p): np.asarray(v) for p, v in flatten_with_path(
        jax.tree.map(np.asarray, jstate.params))}
    with torch.no_grad():
        for p, v in flatten_with_path(tstate.params):
            v.copy_(torch.from_numpy(np.array(jp["/".join(p)])))
    jstep = jax.jit(jstep)
    for _ in range(3):
        jstate, jm = jstep(jstate, next(jbatches))
        tstate, tm = tstep(tstate, next(tbatches))
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **STEP, err_msg=k)
    for tree_t, tree_j in ((tstate.params, jstate.params), (tstate.opt_state, jstate.opt_state)):
        want = {"/".join(p): np.asarray(v) for p, v in flatten_with_path(
            jax.tree.map(np.asarray, tree_j))}
        got = {"/".join(p): v.detach().numpy() for p, v in flatten_with_path(tree_t)}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **STEP, err_msg=k)


def test_config_matches_jax():
    from repro.configs import get_arch as jax_get_arch

    ja, ta = jax_get_arch("nequip"), get_arch("nequip")
    for make in ("make_config", "smoke_config"):
        jc, tc = getattr(ja, make)(), getattr(ta, make)()
        for f in ("name", "n_layers", "d_hidden", "l_max", "n_rbf", "cutoff", "n_species",
                  "radial_hidden", "batch_axes"):
            assert getattr(tc, f) == getattr(jc, f), (make, f)
        assert tc.param_dtype == tc.compute_dtype == torch.float32
    assert (ta.family, ta.source, ta.optimizer, ta.learning_rate, ta.notes) == \
        (ja.family, ja.source, ja.optimizer, ja.learning_rate, ja.notes)
    assert {k: (c.kind, c.settings) for k, c in ta.cells.items()} == \
        {k: (c.kind, c.settings) for k, c in ja.cells.items()}
    assert ta.make_config().with_batch_axes(("pod", "data")).batch_axes == ("pod", "data")


def test_train_driver_trains_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for steps in (6, 9):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch", "nequip",
                            "--steps", str(steps), "--ckpt-dir", str(tmp_path),
                            "--ckpt-every", "3", "--log-every", "3", "--device", "cpu"],
                           capture_output=True, text=True, timeout=300, env=env)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    assert "[resume]" not in outs[0] and "[done] 6 steps" in outs[0]
    assert "[resume] restored step 6" in outs[1] and "[done] 9 steps" in outs[1]
