"""The port's public surface against the JAX package's.

For every module of ``src/repro`` with a counterpart path under
``src/repro_torch``, one case asserts that every name in the module's
``__all__`` resolves on the counterpart, and that every keyword parameter
of a public function, or of a public class's ``__init__`` (a dataclass's
fields) or public method, exists on the counterpart, or that the
counterpart takes ``**kwargs``.  The JAX modules are read with ``ast``
only, never imported (``repro.launch.dryrun`` sets ``XLA_FLAGS`` on
import); the port's modules are imported.  :data:`EXEMPT` is the one
table of what the port leaves out by design, each entry with its reason,
and an entry that no longer matches a gap fails its module's case.
"""

import ast
import importlib
import inspect
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_SRC = ROOT / "src" / "repro"
PORT_SRC = ROOT / "src" / "repro_torch"

# Files of the JAX package with no counterpart in the port, and why.
NO_COUNTERPART = {
    "compat.py": "shims over JAX API versions; the port imports no JAX",
    "kernels/minplus_xla.py": "the Pallas product's XLA fallback; the port's plain version "
                              "of each kernel lives beside its CUDA wrapper",
    "roofline/hlo_cost.py": "costs a compiled program's HLO; the port's dry run counts ops "
                            "as they run (roofline/op_cost.py)",
}

_PALLAS = "a Pallas builder (or their registry), with no counterpart on the CUDA route"
_BLOCKS = ("the Pallas product's block default; the CUDA kernel's knobs are tile_rows and "
           "chunks (autotune.candidates)")
_KERNELCHECK = ("the Pallas-call interceptor and block simulator; the port's verifier "
                "interprets the CUDA kernels' launch plans (kernelcheck.verify)")
_KEY = ("JAX's PRNG key is a torch.Generator (`generator`) in the port; ROADMAP §3, "
        "'Initialisers draw from a torch.Generator'")

# (JAX module, gap) -> why the port leaves it out.  A gap is a name of the
# module's __all__ or a public callable ("name", "Class.method"), or a
# keyword ("f(kw)", "Class(kw)" for __init__, "Class.method(kw)").
EXEMPT = {
    ("repro.kernels.minplus", "minplus_pallas"): _PALLAS,
    ("repro.kernels.minplus", "minplus_argmin_pallas"): _PALLAS,
    ("repro.kernels.minplus", "PALLAS_BUILDERS"): _PALLAS,
    ("repro.kernels.minplus", "DEFAULT_BM"): _BLOCKS,
    ("repro.kernels.minplus", "DEFAULT_BN"): _BLOCKS,
    ("repro.kernels.minplus", "DEFAULT_BK"): _BLOCKS,
    ("repro.kernels.minplus", "DEFAULT_KC"): _BLOCKS,
    ("repro.kernels.fw_round", "fw_round_pallas"): _PALLAS,
    ("repro.kernels.fw_round", "PALLAS_BUILDERS"): _PALLAS,
    ("repro.kernels.fw_block", "fw_block_pallas"): _PALLAS,
    ("repro.kernels.fw_block", "fw_block_pred_pallas"): _PALLAS,
    ("repro.kernels.fw_block", "PALLAS_BUILDERS"): _PALLAS,
    ("repro.kernels.row_close", "row_close_pallas"): _PALLAS,
    ("repro.kernels.row_close", "PALLAS_BUILDERS"): _PALLAS,
    ("repro.analysis.kernelcheck", "intercept_pallas_calls"): _KERNELCHECK,
    ("repro.analysis.kernelcheck", "KernelCall"): _KERNELCHECK,
    ("repro.analysis.kernelcheck", "check_call"): _KERNELCHECK,
    ("repro.analysis.kernelcheck.intercept", "intercept_pallas_calls"): _KERNELCHECK,
    ("repro.analysis.kernelcheck.intercept", "KernelCall"): _KERNELCHECK,
    ("repro.analysis.kernelcheck.simulate", "simulate"): _KERNELCHECK,
    ("repro.analysis.kernelcheck.simulate", "block_index"): _KERNELCHECK,
    ("repro.analysis.kernelcheck.simulate", "tile_slices"): _KERNELCHECK,
    ("repro.analysis.kernelcheck.verify", "check_call"): _KERNELCHECK,
    **{("repro.analysis.kernelcheck.lattice", f"Case({f})"):
       "the JAX case names a Pallas builder of PALLAS_BUILDERS and an oracle; the port's "
       "names the CUDA wrapper and its inputs, and the plain version is the oracle"
       for f in ("builder", "run", "expected", "atol", "builder_fn")},
    ("repro.analysis.donation", "parse_input_output_alias"):
        "reads a compiled HLO's input/output aliases; torch compiles no alias",
    **{("repro.analysis.donation", f"DonationSpec({f})"):
       "the JAX spec names a jitted function, its donated argnums and the aliased output, "
       "proved from the compiled HLO; the port's spec runs the entry point and compares "
       "storages (`run`, `alias`; ROADMAP §3, 'Buffers')"
       for f in ("make", "donated", "alias_out")},
    ("repro.analysis.purity", "TraceImpurityChecker"):
        "checks code under jax.jit tracing; the port's counterpart is the host-sync check",
    ("repro.roofline", "analyze_compiled"):
        "costs a compiled XLA program; the port's dry run uses the op counter",
    ("repro.roofline.analysis", "analyze_compiled"):
        "costs a compiled XLA program; the port's dry run uses the op counter",
    ("repro.roofline.analysis", "collective_bytes(hlo_text)"):
        "the port reads recorded (kind, bytes) pairs, not HLO text; ROADMAP §3",
    ("repro.core.graphgen", "generate(key)"): _KEY,
    ("repro.core.graphgen", "generate_batch(key)"): _KEY,
    ("repro.launch.builders", "abstract_init(key)"): _KEY,
    ("repro.models.gnn", "init_gnn(key)"): _KEY,
    ("repro.models.layers", "dense_init(key)"): _KEY,
    ("repro.models.layers", "embed_init(key)"): _KEY,
    ("repro.models.layers", "init_gqa(key)"): _KEY,
    ("repro.models.layers", "init_swiglu(key)"): _KEY,
    ("repro.models.layers", "init_embed(key)"): _KEY,
    ("repro.models.mind", "init_mind(key)"): _KEY,
    ("repro.models.mla", "init_mla(key)"): _KEY,
    ("repro.models.moe", "init_moe(key)"): _KEY,
    ("repro.models.nequip", "init_nequip(key)"): _KEY,
    ("repro.models.transformer", "init_lm(key)"): _KEY,
}


def _module_name(package: str, rel: Path) -> str:
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([package] + parts)


def _jax_files():
    return sorted(p.relative_to(JAX_SRC) for p in JAX_SRC.rglob("*.py"))


# JAX module -> its file, relative to src/repro, for each file the port has.
SOURCES = {_module_name("repro", rel): rel for rel in _jax_files() if (PORT_SRC / rel).exists()}
MODULES = sorted(SOURCES)


def _keywords(fn: ast.AST):
    a = fn.args
    return [p.arg for p in a.args + a.kwonlyargs if p.arg not in ("self", "cls")]


def jax_surface(tree: ast.Module):
    """(``__all__`` or None, {callable: keywords}) of a module's source;
    callables are ``f``, ``Class`` (its ``__init__``) and ``Class.method``."""
    exported = None
    calls = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                exported = list(ast.literal_eval(node.value))
        elif isinstance(node, ast.FunctionDef):
            if not node.name.startswith("_"):
                calls[node.name] = _keywords(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            init = None
            for item in node.body:
                if not isinstance(item, ast.FunctionDef) or any(
                        ast.unparse(d) == "property" for d in item.decorator_list):
                    continue
                if item.name == "__init__":
                    init = _keywords(item)
                elif not item.name.startswith("_"):
                    calls[f"{node.name}.{item.name}"] = _keywords(item)
            if init is None and any("dataclass" in ast.unparse(d) for d in node.decorator_list):
                # a dataclass: its annotated fields are __init__'s keywords
                init = [s.target.id for s in node.body if isinstance(s, ast.AnnAssign)
                        and isinstance(s.target, ast.Name)
                        and "ClassVar" not in ast.unparse(s.annotation)]
            calls[node.name] = init or []
    return exported, calls


def surface_gaps(tree: ast.Module, port: types.ModuleType) -> set:
    """What the JAX module's source exposes that ``port`` does not."""
    exported, calls = jax_surface(tree)
    gaps = {name for name in exported or () if not hasattr(port, name)}
    for call, keywords in calls.items():
        obj, parts = port, call.split(".")
        for i, part in enumerate(parts):
            obj = getattr(obj, part, None)
            if obj is None:
                gaps.add(".".join(parts[:i + 1]))     # a missing class, not each method
                break
        if obj is None or not keywords:
            continue
        params = inspect.signature(obj).parameters.values()
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            names = {p.name for p in params if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
            gaps.update(f"{call}({k})" for k in keywords if k not in names)
    return gaps


def test_files_without_a_counterpart_are_the_listed_ones():
    missing = {str(rel) for rel in _jax_files() if not (PORT_SRC / rel).exists()}
    assert missing == set(NO_COUNTERPART)
    assert len(MODULES) + len(NO_COUNTERPART) == len(_jax_files()) and len(MODULES) > 70


def test_every_exemption_names_a_module_and_a_reason():
    assert all(mod in MODULES and reason.strip() for (mod, _), reason in EXEMPT.items())
    assert all(reason.strip() for reason in NO_COUNTERPART.values())


def test_the_reader_finds_each_kind_of_gap():
    """A JAX module's missing name, callable and keyword are found; a
    counterpart with ``**kwargs`` takes every keyword; keywords of a
    dataclass are its fields."""
    tree = ast.parse(
        "__all__ = ['f', 'g', 'h', 'C', 'gone']\n"
        "def f(x, *, key=None, axis=-1): ...\n"
        "def g(x, backend=None): ...\n"
        "def h(x, y): ...\n"
        "def _private(z): ...\n"
        "@dataclass\n"
        "class C:\n"
        "    a: int\n"
        "    b: int = 0\n"
        "    def m(self, k): ...\n"
        "    @property\n"
        "    def p(self): ...\n"
        "class D:\n"
        "    def __init__(self, q): ...\n")
    port = types.ModuleType("port")
    exec("from dataclasses import dataclass\n"
         "def f(x, *, generator=None, axis=-1): ...\n"
         "def g(x, **kw): ...\n"
         "def h(x, /, y): ...\n"
         "@dataclass\n"
         "class C:\n"
         "    a: int\n"
         "    def m(self): ...\n", port.__dict__)
    assert surface_gaps(tree, port) == {"gone", "f(key)", "h(x)", "C(b)", "C.m(k)", "D"}


@pytest.mark.parametrize("module", MODULES)
def test_port_exposes_the_jax_module_surface(module):
    path = JAX_SRC / SOURCES[module]
    port = importlib.import_module(_module_name("repro_torch", SOURCES[module]))
    gaps = surface_gaps(ast.parse(path.read_text(), filename=str(path)), port)
    exempt = {gap for (mod, gap) in EXEMPT if mod == module}
    assert sorted(gaps - exempt) == [], f"{module}: the port lacks these"
    assert sorted(exempt - gaps) == [], f"{module}: stale exemptions"
