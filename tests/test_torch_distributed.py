"""``repro_torch.core.distributed`` (SUMMA, distributed FW, R-Kleene on a
device mesh), ``launch.mesh``, ``sharding``, ``launch.apsp_run`` and
``restore_onto_mesh``'s mesh case on the CPU, four spawned ranks under
gloo, against ``repro.core.distributed`` and ``tests/oracle.py``.

The JAX package's solvers run in one subprocess on four fake XLA host
devices, as the reference's own tests run them (the device-count flag
must precede JAX's start).  Tolerance: exact (``np.array_equal``) under
tropical on integer weights, where every sum is exact and every min
selective; under reliability (products of probabilities, inexact) the
reference's ``allclose`` (rtol 1e-5).  Launch counts are read by counting
``kernels.ops.minplus`` and ``ops.fw_block`` calls on each rank: on the
card each is one kernel launch (``chip_smoke.py`` phase 10b holds that
with the launch counters).
"""

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from oracle import np_closure
from repro_torch.core import generate_np
from repro_torch.launch.apsp_run import run_ranks
from repro_torch.launch.serve import _recast_graph

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model"), False),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"), True)}
METHODS = ("squaring", "fw", "rkleene")
N, BLOCK, LEAF = 48, 4, 24
RANK_TIMEOUT = 240


def _graph(semiring="tropical"):
    """The reference test's graph (``generate_np(default_rng(3), 48)``)."""
    return _recast_graph(generate_np(np.random.default_rng(3), N).h, semiring)


def _summa_operand():
    rng = np.random.default_rng(0)
    return np.where(rng.uniform(size=(32, 32)) < .3, np.inf,
                    rng.uniform(1, 9, (32, 32))).astype(np.float32)


def _plan(method, n, nr, nc, block=BLOCK, leaf=4096):
    """(minplus, fw_block) calls a rank makes: squaring ceil(log2 n) SUMMA
    products of lcm(nr, nc) panels; blocked FW per pivot one closure, the
    update, and a panel product for each panel the rank owns (n / nr / B
    row pivots and n / nc / B column pivots); R-Kleene six products a level
    above the leaf."""
    if method == "squaring":
        return max(1, math.ceil(math.log2(n))) * math.lcm(nr, nc), 0
    if n > leaf and method == "rkleene":
        mp1, fb1 = _plan(method, n // 2, nr, nc, block, leaf)
        return 6 * math.lcm(nr, nc) + 2 * mp1, 2 * fb1
    b = min(block, n // nr, n // nc)
    return n // b + n // nr // b + n // nc // b, n // b


def mesh_jobs(ckpt_dir, *, device):
    """Every job on both meshes, on one rank of a 4-rank group."""
    import torch.distributed as dist

    from repro_torch.checkpoint import load_checkpoint, restore_onto_mesh
    from repro_torch.core import distributed as D
    from repro_torch.core.semiring import get_semiring
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import P, batch_axes_for, make_shardings

    calls = {"minplus": 0, "fw_block": 0}

    def counted(name):
        real = getattr(ops, name)

        def fn(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return fn

    ops.minplus, ops.fw_block = counted("minplus"), counted("fw_block")
    out = {"rank": dist.get_rank()}
    for label, (shape, axes, multi_pod) in MESHES.items():
        mesh = make_mesh(shape, axes, device=device)
        rows = batch_axes_for(mesh)
        spec = D.dist_spec(multi_pod)
        grid = dict(mesh=mesh, row_axes=rows, col_axes=("model",))
        for sr in ("tropical", "reliability"):
            h = torch.from_numpy(_graph(sr))
            for method in METHODS:
                calls.update(minplus=0, fw_block=0)
                got = D.apsp_distributed(h, mesh=mesh, method=method, multi_pod=multi_pod,
                                         block_size=BLOCK, semiring=sr)
                out[(label, sr, method)] = got.numpy()
                out[(label, sr, method, "calls")] = dict(calls)
        # R-Kleene with a recursion level (leaf 24 of 48).
        d = D.shard_matrix(torch.from_numpy(_graph()), mesh, spec)
        calls.update(minplus=0, fw_block=0)
        z = D.rkleene_distributed(d, leaf=LEAF, block_size=BLOCK, semiring=get_semiring(),
                                  **grid)
        out[(label, "rkleene leaf")] = D.gather_matrix(z, mesh, spec).numpy()
        out[(label, "rkleene leaf", "calls")] = dict(calls)
        # SUMMA with and without acc on local blocks.
        x = D.shard_matrix(torch.from_numpy(_summa_operand()), mesh, spec)
        for name, acc in (("summa", None), ("summa acc", x + 1.0)):
            z = D.summa_minplus(x, x.T.contiguous().T, acc, **grid)
            out[(label, name)] = D.gather_matrix(z, mesh, spec).numpy()
        # restore_onto_mesh: each rank's block of a checkpointed leaf.
        flat, _ = load_checkpoint(ckpt_dir)
        example = {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
        sh = make_shardings(mesh, {"w": P(("pod", "data"), "model"), "b": P(None)})
        got = restore_onto_mesh(flat, example, sh)
        out[(label, "restore")] = ({k: v.numpy() for k, v in got.items()}, mesh.coords,
                                   sh["w"].spec)
    return out


JAX_REF = """
import sys
import jax, numpy as np, jax.numpy as jnp
from repro.core.distributed import apsp_distributed, rkleene_distributed, summa_minplus
from repro.core.graphgen import generate_np
from repro.launch.serve import _recast_graph

h = generate_np(np.random.default_rng(3), {n}).h
out = {{}}
for label, shape, axes, mp in (("2x2", (2, 2), ("data", "model"), False),
                              ("2x1x2", (2, 1, 2), ("pod", "data", "model"), True)):
    mesh = jax.make_mesh(shape, axes)
    rows = ("pod", "data") if mp else ("data",)
    for sr in ("tropical", "reliability"):
        for method in ("squaring", "fw", "rkleene"):
            out[f"{{label}} {{sr}} {{method}}"] = np.asarray(apsp_distributed(
                jnp.asarray(_recast_graph(h, sr)), mesh=mesh, method=method, multi_pod=mp,
                block_size={block}, semiring=sr))
    out[f"{{label}} rkleene leaf"] = np.asarray(rkleene_distributed(
        jnp.asarray(h), mesh=mesh, row_axes=rows, leaf={leaf}, block_size={block}))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both meshes' results from one 4-rank gloo group, by rank."""
    from repro_torch.checkpoint import save_checkpoint

    ckpt = tmp_path_factory.mktemp("ckpt")
    save_checkpoint(str(ckpt), 1, {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
                                   "b": np.arange(8, dtype=np.float32)})
    return run_ranks(mesh_jobs, 4, (str(ckpt),), device="cpu", timeout=RANK_TIMEOUT)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "ref.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_REF.format(
        n=N, block=BLOCK, leaf=LEAF)), str(path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("method", METHODS)
def test_tropical_equals_jax_and_oracle(ranks, jax_ref, mesh, method):
    want = np_closure(_graph())
    for out in ranks:
        got = out[(mesh, "tropical", method)]
        assert np.array_equal(got, jax_ref[f"{mesh} tropical {method}"]), (out["rank"], method)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("method", METHODS)
def test_reliability_within_the_reference_tolerance(ranks, jax_ref, mesh, method):
    h = _graph("reliability")
    got = ranks[0][(mesh, "reliability", method)]
    assert np.allclose(got, jax_ref[f"{mesh} reliability {method}"], rtol=1e-5)
    assert np.allclose(got, np_closure(h, "reliability"), rtol=1e-5)
    assert all(np.array_equal(o[(mesh, "reliability", method)], got) for o in ranks)


@pytest.mark.parametrize("mesh", MESHES)
def test_rkleene_recursion_equals_jax(ranks, jax_ref, mesh):
    """Leaf 24 of 48: one level of quadrants re-laid over the mesh."""
    got = ranks[0][(mesh, "rkleene leaf")]
    assert np.array_equal(got, jax_ref[f"{mesh} rkleene leaf"])
    assert np.array_equal(got, np_closure(_graph()))


@pytest.mark.parametrize("mesh", MESHES)
def test_calls_per_rank_equal_the_plan(ranks, mesh):
    shape, axes, multi_pod = MESHES[mesh]
    nr, nc = math.prod(shape[:-1]), shape[-1]
    pads = {"squaring": math.lcm(nr, nc), "fw": BLOCK * math.lcm(nr, nc)}
    for out in ranks:
        for method in METHODS:
            n = -(-N // pads.get(method, pads["fw"])) * pads.get(method, pads["fw"])
            mp, fb = _plan(method, n, nr, nc)
            assert out[(mesh, "tropical", method, "calls")] == {"minplus": mp, "fw_block": fb}
        mp, fb = _plan("rkleene", N, nr, nc, leaf=LEAF)
        assert out[(mesh, "rkleene leaf", "calls")] == {"minplus": mp, "fw_block": fb}


@pytest.mark.parametrize("mesh", MESHES)
def test_summa_matches_local_minplus(ranks, mesh):
    """The counterpart of ``tests/test_distributed_and_driver.py::
    test_summa_minplus_matches_local``, with and without ``acc``."""
    from repro_torch.kernels import ops

    x = torch.from_numpy(_summa_operand())
    assert np.array_equal(ranks[0][(mesh, "summa")], ops.minplus(x, x).numpy())
    assert np.array_equal(ranks[0][(mesh, "summa acc")], ops.minplus(x, x, x + 1.0).numpy())


@pytest.mark.parametrize("mesh", MESHES)
def test_restore_onto_mesh_gives_each_rank_its_block(ranks, mesh):
    """The counterpart of ``tests/test_distributed_and_driver.py::
    test_elastic_restore_onto_different_mesh``."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    seen = set()
    for out in ranks:
        got, coords, spec = out[(mesh, "restore")]
        r, c = int(np.ravel_multi_index(coords[:-1], MESHES[mesh][0][:-1])), coords[-1]
        assert np.array_equal(got["w"], w[4 * r:4 * r + 4, 4 * c:4 * c + 4])
        assert np.array_equal(got["b"], np.arange(8, dtype=np.float32))
        assert tuple(spec) == (("pod", "data") if mesh == "2x1x2" else ("data",), "model")
        seen.add((r, c))
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_apsp_run_verifies_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.apsp_run", "--mesh", "2x2",
                        "--verify", "--device", "cpu", "--method", "rkleene", "--n", "64",
                        "--timeout", str(RANK_TIMEOUT)],
                       capture_output=True, text=True, timeout=RANK_TIMEOUT + 60, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "backend gloo" in r.stdout and "[verify] vs numpy FW oracle: OK" in r.stdout


def test_host_mesh_solves_without_a_process_group():
    """``make_host_mesh`` is one process's 1x1 mesh: no process group, its
    broadcasts no-ops, the same answers."""
    from repro_torch.core.distributed import apsp_distributed
    from repro_torch.launch.mesh import make_host_mesh, make_mesh

    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.groups is None
    h = torch.from_numpy(_graph())
    for method in METHODS:
        got = apsp_distributed(h, mesh=mesh, method=method, block_size=BLOCK)
        assert np.array_equal(got.numpy(), np_closure(_graph()))
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh((1, 1), ("data", "model"), device="cpu")


def test_partition_spec_and_filter():
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import P, filter_spec_for_mesh, make_shardings
    from repro_torch.tree import leaves

    mesh = make_host_mesh(device="cpu")
    spec = P(("pod", "data"), "model", None)
    assert filter_spec_for_mesh(spec, mesh) == P(("data",), "model", None)
    assert filter_spec_for_mesh(P("pod"), mesh) == P(None)
    assert len(spec) == 3 and spec[0] == ("pod", "data") and hash(spec) == hash(P(*spec))
    with pytest.raises(AttributeError):
        spec.x = 1
    tree = make_shardings(mesh, {"a": P("data"), "b": [P(None, "model")]})
    assert [s.spec for s in leaves(tree)] == [P("data"), P(None, "model")]
