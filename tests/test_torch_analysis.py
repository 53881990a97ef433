"""The port's invariant checkers (``repro_torch.analysis``) on the CPU.

Each tier-A checker fires on a small bad tree written into ``tmp_path``
from the strings below (the port's layout, ``src/repro_torch/...``) and
stays quiet on the port's own tree, which is parsed once for the module
(a module-scoped ``Project``); the pragmas give the JAX package's answers
on the same seeded line lists; ``except-swallow`` and ``autotune-key``,
pointed at the JAX package's fixture files (read only), flag the same
(check, line) set as the JAX package's checkers; the donation check's
runtime half holds the port's solvers to their aliasing claims at
N <= 32; the CLI keeps ``tools/analyze.py``'s flags, JSON schema and exit
codes.  The kernel grid verifier has its own file,
``tests/test_torch_kernelcheck.py``.
"""

import json
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import CHECKERS as REF_CHECKERS
from repro.analysis import Project as RefProject
from repro.analysis import pragmas as ref_pragmas
from repro.analysis import run_checks as ref_run_checks
from repro_torch.analysis import (CHECKERS, DonationSpec, Finding, Project, pragmas,
                                  run_checks, run_donation_checks)
from repro_torch.analysis.__main__ import main as cli
from repro_torch.analysis.donation import default_specs
from repro_torch.analysis.purity import SEEDS, missing_seeds

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURE = REPO / "tests" / "analysis_fixtures" / "badrepo"
ALL = ("unfused-dispatch", "semiring-hardcode", "host-sync", "autotune-key", "donation",
       "except-swallow", "kernel-grid")


def write_tree(root: Path, files: dict) -> Project:
    for rel, text in files.items():
        p = root / "src" / "repro_torch" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text).lstrip("\n"))
    return Project(root)


def flagged(findings, tail):
    return sorted(f.line for f in findings if f.path.endswith(tail))


@pytest.fixture(scope="module")
def real():
    """The port's own tree, parsed once for every real-tree check."""
    return Project(REPO)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_has_the_seven_checks():
    assert set(CHECKERS) == set(ALL)
    for c in CHECKERS.values():
        assert c.name and c.description
    assert {n for n, c in CHECKERS.items() if c.advisory} == {"except-swallow"}


def test_unknown_check_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown check"):
        run_checks(Project(tmp_path, []), ["no-such-check"])


# ---------------------------------------------------------------------------
# each checker on a bad tree
# ---------------------------------------------------------------------------

DISPATCH = {
    "core/baddispatch.py": '''
        import numpy as np
        import torch
        from .semiring import minplus, pad_to_multiple           # line 3: unfused import
        from repro_torch.kernels import ops


        def solver(d, h):
            z = minplus(d, d)                                      # line 8: bare product
            z = torch.minimum(z, h)                                # line 9: accumulate sweep
            z = ops.minplus(z, z, z)                               # fused: fine
            w = z.clone()                                          # line 11: matrix copy
            v = torch.tensor(h)                                    # line 12: matrix copy
            u = np.ones(3).copy()                                  # line 13: matrix copy
            t = torch.clone(z)                                     # line 14: matrix copy
            s = z.clone()  # lint: allow-copy  host-side, outside a round
            r = torch.maximum(z, h)  # lint: allow-unfused  a clamp, not an accumulate
            return minplus_3d(w, v) if s is None else r            # different name: fine
    ''',
    "core/semiring.py": '''
        import torch


        def minplus(x, y):
            return torch.minimum(x, y).clone()                     # the host: exempt
    ''',
    "core/convert.py": '''
        def to_jax(t):
            return t.clone()                                       # exempt
    ''',
}


def test_unfused_dispatch_fires_on_bad_tree(tmp_path):
    fs = run_checks(write_tree(tmp_path, DISPATCH), ["unfused-dispatch"])
    assert flagged(fs, "core/baddispatch.py") == [3, 8, 9, 11, 12, 13, 14]
    assert not flagged(fs, "core/semiring.py") and not flagged(fs, "core/convert.py")


HARDCODE = {
    "core/badsolver.py": '''
        import torch


        def relax(d, x, y):
            z = torch.minimum(d, x)                                # line 5
            z = torch.add(z, y)                                    # line 6
            m = torch.amin(z, dim=0)                               # line 7
            k = torch.argmin(z, dim=0)                             # line 8
            ref = torch.minimum                                    # a reference: no call
            c = torch.clamp(k, min=0)                              # not a semiring op
            return z.min() if ref else (m, k, c)                   # a method: not flagged
    ''',
    "kernels/badkernel.py": '''
        import torch


        def fold(x):
            return torch.sum(x, dim=0), torch.max(x)               # line 5, twice
    ''',
    "core/semiring.py": '''
        import torch

        TROPICAL_ADD = torch.minimum(torch.zeros(1), torch.ones(1))  # exempt
    ''',
    "launch/other.py": '''
        import torch

        x = torch.minimum(torch.zeros(1), torch.ones(1))           # out of scope
    ''',
}


def test_semiring_hardcode_fires_on_bad_tree(tmp_path):
    fs = run_checks(write_tree(tmp_path, HARDCODE), ["semiring-hardcode"])
    assert flagged(fs, "core/badsolver.py") == [5, 6, 7, 8]
    assert flagged(fs, "kernels/badkernel.py") == [5, 5]
    assert not flagged(fs, "core/semiring.py") and not flagged(fs, "launch/other.py")


HOST_SYNC = {
    "core/blocked_fw.py": '''
        import time

        import numpy as np
        import torch

        from . import helper


        def blocked_fw(h: torch.Tensor, block_size: int = 8):
            b = int(block_size)                                    # an int: fine
            if h.shape[0] > b and h.is_cuda:                       # metadata: fine
                pass
            t0 = time.perf_counter()                               # line 13: clock
            s = h.sum()
            if s > 0:                                              # line 15: if on a tensor
                h = h + 1
            v = s.item()                                           # line 17
            a = np.asarray(h)                                      # line 18
            torch.cuda.synchronize()                               # line 19
            ok = bool((h < 0).any())                               # line 20
            w = helper.count(h)
            n = helper.size(h)
            if n > 2:                                              # an int result: fine
                pass
            return h, t0, v, a, ok, w
    ''',
    "core/helper.py": '''
        import torch


        def count(h: torch.Tensor):
            return h.cpu()                                         # line 5: transitive


        def size(h: torch.Tensor) -> int:
            return h.shape[0]


        def unreached(h: torch.Tensor):
            return h.item()                                        # not on the path
    ''',
}


def test_host_sync_fires_on_bad_tree(tmp_path):
    fs = run_checks(write_tree(tmp_path, HOST_SYNC), ["host-sync"])
    assert flagged(fs, "core/blocked_fw.py") == [13, 15, 17, 18, 19, 20]
    assert flagged(fs, "core/helper.py") == [5]


def test_host_sync_pragma_and_seeds(tmp_path):
    files = dict(HOST_SYNC)
    files["core/blocked_fw.py"] = files["core/blocked_fw.py"].replace(
        "ok = bool((h < 0).any())  ", "ok = bool((h < 0).any())  # repro: allow-host-sync  why")
    proj = write_tree(tmp_path, files)
    assert 20 not in flagged(run_checks(proj, ["host-sync"]), "core/blocked_fw.py")
    missing = missing_seeds(proj)
    assert "core/blocked_fw.py::blocked_fw" not in missing
    assert "core/paths.py::spd_features" in missing and "kernels/ops.py::*" in missing


def test_every_host_sync_seed_exists(real):
    """A rename of a seed would empty the check silently."""
    assert len(SEEDS) >= 20 and missing_seeds(real) == []


AUTOTUNE = {
    "kernels/autotune.py": '''
        def key_for(backend, dtype, m, k, n, g=0, semiring="tropical"):
            return f"{backend}|{dtype}|{m}|{k}|{n}|{g}|{semiring}"


        def lookup(backend, dtype, m, k, n, g=0, semiring="tropical", accumulate=False):
            return {}                                              # lookup at line 5


        def key_for_fw_round(backend, dtype, n, g=0, semiring="tropical"):
            return ""


        def lookup_fw_round(backend, dtype, n, g=0, semiring="tropical"):
            return {}
    ''',
    "core/site.py": '''
        from repro_torch.kernels import autotune
        from repro_torch.kernels.autotune import lookup_fw_round as lfr


        def dispatch(x):
            a = autotune.lookup("cuda", x.dtype, 1, 2, 3, g=0, semiring="tropical",
                                accumulate=True)                   # every axis: fine
            b = autotune.lookup("cuda", x.dtype, 1, 2, 3)         # line 8: defaults
            c = lfr("cuda", x.dtype, 8)                            # line 9: defaults
            d = lfr(*("cuda", x.dtype, 8))                         # forwarding: skipped
            return a, b, c, d
    ''',
}


def test_autotune_key_fires_on_bad_tree(tmp_path):
    fs = run_checks(write_tree(tmp_path, AUTOTUNE), ["autotune-key"])
    assert flagged(fs, "kernels/autotune.py") == [5]
    assert flagged(fs, "core/site.py") == [8, 9]


EXCEPT = {
    "launch/badpool.py": '''
        def serve(slot, stats, deferred, log):
            try:
                slot.run()
            except RuntimeError:                                   # line 4: swallowed
                pass
            try:
                slot.run()
            except ValueError:
                slot.quarantine()                                  # handled
            try:
                slot.run()
            except KeyError:
                stats.inc("errors")                                # counted
            try:
                slot.run()
            except OSError:
                deferred.append(slot)                              # deferred
            try:
                slot.run()
            except TypeError:                                      # line 20: printed only
                log("oops")
            try:
                slot.run()
            except IndexError:  # repro: allow-except-swallow  best effort
                pass
    ''',
    "core/dynamic.py": '''
        def rollback(eng):
            try:
                eng.step()
            except RuntimeError:                                   # line 4
                return None
    ''',
    "core/other.py": '''
        def f():
            try:
                pass
            except Exception:                                      # out of scope
                pass
    ''',
}


def test_except_swallow_fires_on_bad_tree_and_is_advisory(tmp_path):
    fs = run_checks(write_tree(tmp_path, EXCEPT), ["except-swallow"])
    assert flagged(fs, "launch/badpool.py") == [4, 20]
    assert flagged(fs, "core/dynamic.py") == [4]
    assert not flagged(fs, "core/other.py") and all(f.advisory for f in fs)


DONATION = {
    "core/baddonate.py": '''
        def solve(h, donate=False):
            return h


        def donating(h, donate=True):
            return h


        class Engine:
            def __init__(self, h, donate=True):
                self.h = h


        def caller(h, g, k):
            d = solve(h, donate=True)
            x = h + 1                                              # line 16: read
            h = d                                                  # rebound
            h = solve(h, donate=True)                              # donates the new h
            y = d + 1
            e = donating(g)
            if g is None:                                          # line 21: read
                pass
            eng = Engine(k, donate=True)                           # a class: no donation
            z = k + 1
            for g in range(3):                                     # rebinding g
                y = g
            return d, x, y, e, eng, z
    ''',
}


def test_donation_read_after_donate_fires_on_bad_tree(tmp_path, capsys):
    fs = run_checks(write_tree(tmp_path, DONATION), ["donation"])
    assert flagged(fs, "core/baddonate.py") == [16, 21]
    assert "tier B skipped" in capsys.readouterr().err


def test_kernel_grid_skips_a_tree_without_the_kernels(tmp_path, capsys):
    assert run_checks(write_tree(tmp_path, EXCEPT), ["kernel-grid"]) == []
    assert "tier B skipped" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", ALL)
def test_real_tree_clean(real, check):
    assert [f.format() for f in run_checks(real, [check])] == []


def test_real_tree_pragmas_name_their_reason(real):
    """Every pragma comment the port carries says why (the settled
    findings): words beside its ``allow-...`` tags."""
    import io
    import re
    import tokenize

    tag = re.compile(r"#\s*(?:repro|lint):\s*|allow-[\w-]+|[,#\s]")
    bare = []
    for rel in real.files():
        for tok in tokenize.generate_tokens(io.StringIO(real.source(rel)).readline):
            if tok.type == tokenize.COMMENT and re.search(r"(repro|lint):\s*allow-", tok.string) \
                    and not tag.sub("", tok.string):
                bare.append(f"{rel}:{tok.start[0]}")
    assert not bare, bare


def test_blocked_fw_donation_returns_the_callers_storage():
    """donate=True leaves the result in the caller's tensor on every round
    mode, with and without preds, on the CPU too; donate=False leaves the
    caller's tensor as it was."""
    from repro_torch.core.blocked_fw import blocked_fw

    rng = np.random.default_rng(3)
    a = rng.integers(1, 9, (24, 24)).astype(np.float32)
    np.fill_diagonal(a, 0)
    want = blocked_fw(torch.from_numpy(a.copy()), block_size=8)[0]
    for mode in ("fused", "split"):
        for pred in (False, True):
            h = torch.from_numpy(a.copy())
            dist, _ = blocked_fw(h, block_size=8, round_mode=mode, with_pred=pred, donate=True)
            assert dist.untyped_storage().data_ptr() == h.untyped_storage().data_ptr()
            assert torch.equal(dist, want) and torch.equal(h, want)
            h = torch.from_numpy(a.copy())
            dist, _ = blocked_fw(h, block_size=8, round_mode=mode, with_pred=pred)
            assert torch.equal(h, torch.from_numpy(a)) and torch.equal(dist, want)


def test_solve_never_overwrites_a_callers_numpy_array():
    """solve's default donation overwrites only a copy it made: a float32
    numpy array shares its memory with ``torch.as_tensor`` on the CPU."""
    from repro_torch import solve, solve_batch

    rng = np.random.default_rng(4)
    a = rng.integers(1, 9, (16, 16)).astype(np.float32)
    np.fill_diagonal(a, 0)
    keep = a.copy()
    for kw in ({}, {"round_mode": "split"}, {"with_pred": True}):
        solve(a, device="cpu", block_size=8, **kw)
        assert np.array_equal(a, keep)
    stack = np.stack([a, a])
    solve_batch(stack, device="cpu", block_size=8)
    assert np.array_equal(stack[0], keep) and np.array_equal(stack[1], keep)


def test_default_donation_specs_hold():
    specs = default_specs()
    assert len(specs) == 12 and [s for s in specs if not s.alias][0].name == "rkleene"
    assert run_donation_checks(specs) == []


def test_donation_spec_catches_a_broken_claim():
    def copies():
        h = torch.zeros(4, 4)
        ptr = h.untyped_storage().data_ptr()
        return (ptr,), ((h.clone(),),)

    def aliases():
        h = torch.zeros(4, 4)
        return (h.untyped_storage().data_ptr(),), ((h,),)

    got = run_donation_checks([DonationSpec("copies", "src/x.py", copies),
                               DonationSpec("aliases", "src/y.py", aliases, alias=False),
                               DonationSpec("fine", "src/z.py", aliases)])
    assert [(f.path, f.check) for f in got] == [("src/x.py", "donation"),
                                                ("src/y.py", "donation")]


# ---------------------------------------------------------------------------
# pragmas: the JAX package's answers
# ---------------------------------------------------------------------------

_FRAGMENTS = [
    "x = f(y)", "    x = f(y)", "@jit", "    @partial(jit, static_argnames=('a',))",
    "def g(a):", "    def h(b):", "class C:", "async def k():", "# a comment",
    "# repro: allow-host-sync  why", "# repro: allow-unfused-dispatch,allow-donation  two",
    "#repro:allow-x", "   # repro: allow-semiring-hardcode  indented file scope",
    "x = 1  # repro: allow-host-sync  per line", "y = 2  # repro: allow-a # repro: allow-b",
    "﻿# repro: allow-host-sync  BOM", "z = 3  # repro: allow-host-sync  crlf\r",
    "# x = 1  # repro: allow-host-sync  commented-out code", "s = '# repro: allow-q'",
    "w = 1  # lint: allow-unfused", "", "@decorator  # repro: allow-host-sync  on the stack",
]
_CHECKS = ["host-sync", "unfused-dispatch", "donation", "semiring-hardcode", "a", "b", "x",
           "q"]


@pytest.mark.parametrize("seed", range(4))
def test_pragmas_agree_with_the_jax_package(seed):
    rnd = random.Random(seed)
    for _ in range(60):
        lines = [rnd.choice(_FRAGMENTS) for _ in range(rnd.randint(1, 8))]
        for line in lines:
            assert pragmas.pragmas_on_line(line) == ref_pragmas.pragmas_on_line(line)
        for check in _CHECKS:
            assert pragmas.file_allows(lines, check) == ref_pragmas.file_allows(lines, check)
            for no in range(0, len(lines) + 2):
                assert (pragmas.line_allows_at(lines, no, check)
                        == ref_pragmas.line_allows_at(lines, no, check))


def test_pragma_suppresses_at_line_file_and_decorator(tmp_path):
    files = {"core/bad.py": '''
        import torch


        @torch.no_grad()  # repro: allow-semiring-hardcode  on the decorator
        def a(x): return torch.minimum(x, x)


        def b(x):
            return torch.minimum(x, x)  # repro: allow-semiring-hardcode  on the line


        def c(x):
            return torch.minimum(x, x)
    '''}
    assert flagged(run_checks(write_tree(tmp_path, files), ["semiring-hardcode"]),
                   "core/bad.py") == [13]
    files["core/bad.py"] += "# repro: allow-semiring-hardcode  file scope\n"
    assert run_checks(write_tree(tmp_path, files), ["semiring-hardcode"]) == []


# ---------------------------------------------------------------------------
# parity with the JAX package's checkers on its own fixture files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check,rels", [
    ("except-swallow", ["src/repro/launch/badexcept.py"]),
    ("autotune-key", ["src/repro/kernels/autotune.py", "src/repro/core/badsolver.py",
                      "src/repro/core/baddispatch.py", "src/repro/core/badpurity.py",
                      "src/repro/core/dynamic.py", "src/repro/launch/badexcept.py"]),
])
def test_checkers_flag_what_the_jax_package_flags(check, rels):
    ours = run_checks(Project(REF_FIXTURE, rels), [check])
    ref = ref_run_checks(RefProject(REF_FIXTURE, rels), [check])
    assert ref and {(f.check, f.path, f.line) for f in ours} == {
        (f.check, f.path, f.line) for f in ref}
    assert set(REF_CHECKERS) - {"trace-impurity"} == set(CHECKERS) - {"host-sync"}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_exit_codes_and_json(tmp_path, capsys):
    write_tree(tmp_path, {**HARDCODE, **EXCEPT})
    root = str(tmp_path)
    assert cli(["--root", root, "--only", "autotune-key"]) == 0
    assert "clean" in capsys.readouterr().out
    assert cli(["--root", root, "--checks", "semiring-hardcode", "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert set(report) == {"schema", "checks", "findings"} and report["schema"] == 1
    assert report["checks"] == ["semiring-hardcode"]
    assert set(report["findings"][0]) == set(Finding("a", "b", 1, "c").to_json())
    assert cli(["--root", root, "--only", "except-swallow"]) == 0      # advisory only
    assert "advisory" in capsys.readouterr().out
    assert cli(["--root", root, "--checks", "host-sync", "--only", "except-swallow",
                "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["checks"] == ["host-sync", "except-swallow"]
    assert cli(["--root", root, "--only", "no-such-check"]) == 2
    assert cli(["--list"]) == 0
    listed = capsys.readouterr().out
    assert all(name in listed for name in ALL)
    assert cli(["--root", root, "--only", "kernel-grid", "--require-cuda"]) == 0  # no kernels


def test_cli_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--list"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and "kernel-grid" in out.stdout
