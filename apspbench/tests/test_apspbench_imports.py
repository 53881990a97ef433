"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.

Module names are compared by their top-level name (the part before the
first dot) as a whole: ``repro_torch``, the program, starts with
``repro``, the JAX package's name.
"""

import ast
import subprocess
import sys

import pytest

from apspbench import run, spec

FORBIDDEN = set(run.FORBIDDEN)
FILES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.relative_to(spec.HERE).parts)


def imported(path):
    """(top-level name, relative level) of every import in a file."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            name = arg.value if isinstance(arg, ast.Constant) else ""
            if isinstance(arg, ast.JoinedStr):
                name = "".join(v.value for v in arg.values if isinstance(v, ast.Constant))
            out.append((str(name).split(".")[0], 0))
    return out


def test_the_check_compares_whole_names():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_anywhere(path):
    names = {n for n, level in imported(path) if level == 0}
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name, level in imported(path):
        assert level <= 1, f"{path} reaches outside reference/"
        assert name not in FORBIDDEN | {"repro_torch", "apspbench"}, f"{path} imports {name}"


def test_a_run_process_loads_no_jax():
    """What a run imports before it needs the card: the harness, torch and
    the program.  The run's own check reads ``sys.modules`` after its
    window; this holds the imports to the same rule on the CPU."""
    code = ("import sys; sys.path.insert(0, 'src'); import apspbench.run, apspbench.kinds, "
            "apspbench.trace, apspbench.reference, repro_torch, repro_torch.kernels; "
            "from apspbench import run; print(run.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
