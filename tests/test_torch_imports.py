"""The port's package boundary: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro``, and the port
imports and solves on the CPU in a process where ``jax`` cannot load."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    assert len(PORT_FILES) > 10 and all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("module", [
    "repro_torch.core.floyd_warshall",
    "repro_torch.core.paths",
    "repro_torch.kernels.minplus",
    "repro_torch.kernels.fw_block",
    "repro_torch.kernels.row_close",
    "repro_torch.core.dynamic",
    "repro_torch.core.rkleene",
    "repro_torch.core.apsp",
    "repro_torch.core.semiring",
    "repro_torch.core.graphgen",
    "repro_torch.launch",
    "repro_torch.launch.stats",
    "repro_torch.launch.faults",
    "repro_torch.launch.executor",
    "repro_torch.launch.pool",
    "repro_torch.launch.serve",
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpoint",
    "repro_torch.kernels.autotune",
    "repro_torch.kernels._counts",
    "repro_torch.tree",
    "repro_torch.models",
    "repro_torch.models.gnn",
    "repro_torch.models.layers",
    "repro_torch.optim",
    "repro_torch.optim.optimizers",
    "repro_torch.train",
    "repro_torch.train.steps",
    "repro_torch.data",
    "repro_torch.data.pipeline",
    "repro_torch.data.sampler",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.configs.gnn_archs",
    "repro_torch.configs.apsp_arch",
    "repro_torch.launch.train",
    "repro_torch.models.nequip",
    "repro_torch.core.distributed",
    "repro_torch.core.convert",
    "repro_torch.launch.mesh",
    "repro_torch.launch.apsp_run",
    "repro_torch.sharding",
    "repro_torch.analysis",
    "repro_torch.analysis.__main__",
    "repro_torch.analysis.base",
    "repro_torch.analysis.pragmas",
    "repro_torch.analysis.astutil",
    "repro_torch.analysis.dispatch",
    "repro_torch.analysis.semiring_hardcode",
    "repro_torch.analysis.purity",
    "repro_torch.analysis.autotune_key",
    "repro_torch.analysis.except_swallow",
    "repro_torch.analysis.donation",
    "repro_torch.analysis.kernelcheck",
    "repro_torch.analysis.kernelcheck.intercept",
    "repro_torch.analysis.kernelcheck.simulate",
    "repro_torch.analysis.kernelcheck.verify",
    "repro_torch.analysis.kernelcheck.lattice",
    "repro_torch.analysis.kernelcheck.mutants",
    "repro_torch.analysis.kernelcheck.checker",
    "repro_torch.models.transformer",
    "repro_torch.models.kvcache",
    "repro_torch.models.moe",
    "repro_torch.models.mla",
    "repro_torch.models.mind",
    "repro_torch.optim.compression",
    "repro_torch.configs.lm_archs",
    "repro_torch.configs.recsys_archs",
    "repro_torch.roofline",
    "repro_torch.roofline.analysis",
    "repro_torch.roofline.op_cost",
    "repro_torch.roofline.floors",
    "repro_torch.roofline.kernels",
    "repro_torch.launch.builders",
    "repro_torch.launch.dryrun",
])
def test_new_modules_are_scanned_and_import(module):
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert path in PORT_FILES
    assert not [m for m in _imported_modules(path) if _forbidden(m)]
    importlib.import_module(module)


def test_kernel_sources_ship_with_the_port():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    names = {p.name for p in csrc.iterdir()}
    assert {"fw_round.cu", "minplus.cu", "fw_block.cu", "row_close.cu", "fw_closure.cuh",
            "minplus_tile.cuh", "semiring.cuh"} <= names


def test_port_imports_neither_jax_nor_repro():
    bad = [
        f"{p.relative_to(ROOT)}: {m}"
        for p in PORT_FILES
        for m in _imported_modules(p)
        if _forbidden(m)
    ]
    assert not bad, bad


def test_analysis_imports_neither_jax_nor_repro():
    """The port's checkers keep their own copies of what they need of
    ``repro.analysis`` (``astutil``, ``pragmas``), which import no JAX, and
    import no JAX themselves; nor do the kernel modules that now carry the
    launch plans, at any depth of an import inside a function."""
    files = sorted((ROOT / "src" / "repro_torch" / "analysis").rglob("*.py"))
    files += [ROOT / "src" / "repro_torch" / "kernels" / f"{m}.py"
              for m in ("minplus", "fw_round", "_build")]
    files += [ROOT / "src" / "repro_torch" / "roofline" / "op_cost.py"]
    assert len(files) >= 20 and all(p in PORT_FILES for p in files)
    for p in files:
        relative = [n for n in ast.walk(ast.parse(p.read_text())) if isinstance(n, ast.ImportFrom)
                    and n.level and (n.module or "").split(".")[0] in ("jax", "repro")]
        assert not relative and not [m for m in _imported_modules(p) if _forbidden(m)], p
    assert (ROOT / "src" / "repro_torch" / "analysis" / "kernelcheck" / "csrc"
            / "mutants.cu").is_file()


def test_analysis_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.analysis`` in a process where ``jax`` and
    ``repro`` cannot load: it imports every check (``--list``) and runs the
    AST checks and the donation check's solvers over the port's tree, exit
    0.  (The kernel grid verifier runs in ``test_torch_kernelcheck.py``;
    the AST scan above covers its imports, inside functions too.)"""
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, _Block())\n")
    env = dict(os.environ, PYTHONPATH=f"{blocker}{os.pathsep}{ROOT / 'src'}",
               OMP_NUM_THREADS="1")
    listed = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--list"], cwd=ROOT,
                            env=env, capture_output=True, text=True, timeout=120)
    assert listed.returncode == 0 and len(listed.stdout.splitlines()) == 7, listed.stderr
    checks = "unfused-dispatch,semiring-hardcode,host-sync,autotune-key,except-swallow,donation"
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--checks", checks],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "6 check(s)" in out.stdout and "clean" in out.stdout


def test_the_scan_catches_forbidden_imports():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.semiring")
    assert _forbidden("repro") and not _forbidden("repro_torch.core")


@pytest.mark.parametrize("options", [
    "",
    ", with_pred=True",
    ", round_mode='split'",
    ", round_mode='split', with_pred=True",
])
def test_port_solves_with_jax_blocked(options):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "g = repro_torch.generate_np(np.random.default_rng(0), 40)\n"
        f"r = repro_torch.solve(g.h, block_size=16, device='cpu'{options})\n"
        "d = r.dist\n"
        "assert d.shape == (40, 40) and bool((d.diagonal() == 0).all())\n"
        "assert r.pred is None or repro_torch.validate_tree(g.h, d, r.pred)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_dynamic_engine_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "rng = np.random.default_rng(0)\n"
        "g = repro_torch.generate_np(rng, 40, rho=30.0)\n"
        "eng = repro_torch.DynamicAPSP(g.h, with_pred=True, block_size=16, device='cpu',\n"
        "                              resolve_threshold=1.0)\n"
        "for wf in (0.0, 1.0):\n"
        "    eng.update(*repro_torch.generate_edge_updates(rng, eng.h, 6, worsen_frac=wf))\n"
        "ref = repro_torch.solve(eng.h, block_size=16, device='cpu').dist\n"
        "assert bool((eng.dist == ref).all()) and eng.stats['row_resolve'] == 1\n"
        "assert repro_torch.validate_tree(eng.h, eng.dist, eng.pred)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr



@pytest.mark.parametrize("method", ["squaring", "squaring_3d", "classic", "rkleene"])
def test_port_solve_batch_without_jax(method):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "import repro_torch\n"
        "hs = [g.h for g in repro_torch.paper_corpus(seed=0, n_graphs=4, v_max=24)]\n"
        f"res = repro_torch.solve_batch(hs, method={method!r}, with_pred=True, base=8,\n"
        "                               bucket_by_size=True, device='cpu')\n"
        "for i, h in enumerate(hs):\n"
        "    u = res.unpadded(i)\n"
        "    assert torch.equal(u.dist, repro_torch.solve(h, device='cpu').dist)\n"
        "    assert repro_torch.validate_tree(h, u.dist, u.pred)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("name,exported", [
    ("launch.pool", "SlotState EngineSlot EnginePool QueryResult"),
    ("launch.faults", "FaultSpec FaultInjector InjectedCrash NULL_INJECTOR"),
    ("launch.executor", "UpdateExecutor"),
    ("launch.stats", "Counters"),
])
def test_launch_exports_what_the_jax_modules_export(name, exported):
    import repro_torch.launch

    mod = importlib.import_module(f"repro_torch.{name}")
    assert set(mod.__all__) == set(exported.split())
    assert set(exported.split()) <= set(repro_torch.launch.__all__)


def test_checkpoint_exports_all_but_the_mesh_restore():
    """Every name of ``repro.checkpoint``, ``restore_onto_mesh`` with its
    mesh case too: a sharding tree that does not match the state raises,
    and on the one-process host mesh each leaf lands whole."""
    import numpy as np
    import torch

    import repro_torch.checkpoint
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import P, make_shardings

    want = {"CheckpointManager", "load_checkpoint", "load_engine_checkpoint",
            "save_checkpoint", "save_engine_checkpoint", "restore_onto_mesh"}
    assert want <= set(repro_torch.checkpoint.__all__)
    with pytest.raises(ValueError, match="sharding tree does not match"):
        repro_torch.checkpoint.restore_onto_mesh({}, {"w": torch.zeros(2)}, shardings={})
    sh = make_shardings(make_host_mesh(device="cpu"), {"w": P("data", "model")})
    got = repro_torch.checkpoint.restore_onto_mesh(
        {"w": np.arange(4, dtype=np.float32).reshape(2, 2)}, {"w": torch.zeros(2, 2)}, sh)
    assert torch.equal(got["w"], torch.arange(4.0).reshape(2, 2))


def test_port_serving_tier_without_jax(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "from repro_torch.launch.serve import serve_apsp, serve_apsp_dynamic\n"
        "assert serve_apsp(4, batch=4, n_max=12, method='blocked_fw', device='cpu') == 0\n"
        "assert serve_apsp_dynamic(12, n_max=12, graphs=2, verify_every=4,\n"
        "                          durability_dir='auto', checkpoint_every=2,\n"
        "                          fault_spec='crash:0.2:2,crash_restore:0.3',\n"
        "                          device='cpu') == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


@pytest.mark.parametrize("arch", ["gcn-cora", "gin-tu", "pna"])
def test_port_training_path_without_jax(arch):
    """``spd_features``, two train steps and ``launch.train.main``, in a
    process where ``jax`` and ``repro`` cannot load."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np, torch\n"
        "import repro_torch\n"
        "from repro_torch.launch import train\n"
        "g = repro_torch.generate_np(np.random.default_rng(0), 24)\n"
        "f = repro_torch.spd_features(torch.from_numpy(g.h), [0, 5], cap=50.0)\n"
        "assert f.shape == (24, 2) and float(f.max()) <= 50.0\n"
        f"step, state, batches = train.build_smoke_trainer({arch!r}, device='cpu')\n"
        "for _ in range(2):\n"
        "    state, m = step(state, next(batches))\n"
        "assert int(state.step) == 2 and np.isfinite(float(m['loss']))\n"
        f"assert train.main(['--arch', {arch!r}, '--steps', '2', '--device', 'cpu']) == 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "qwen2-1.5b", "mind"])
def test_port_lm_and_mind_paths_without_jax(arch):
    """The serving loop and two smoke train steps of an LM or MIND, in a
    process where ``jax`` and ``repro`` cannot load."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.launch import serve, train\n"
        f"arch = {arch!r}\n"
        "rc = (serve.serve_mind(4, device='cpu') if arch == 'mind'\n"
        "      else serve.serve_lm(arch, 2, 4, device='cpu'))\n"
        "assert rc == 0\n"
        "step, state, batches = train.build_smoke_trainer(arch, device='cpu')\n"
        "for _ in range(2):\n"
        "    state, m = step(state, next(batches))\n"
        "assert int(state.step) == 2 and np.isfinite(float(m['loss']))\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
