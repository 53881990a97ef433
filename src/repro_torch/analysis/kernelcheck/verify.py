"""The grid theorems of the port's CUDA kernels, checked per launch plan.

The counterpart of ``repro.analysis.kernelcheck.verify``, with its six
problem kinds (:data:`KINDS`).

**Static** (:func:`check_plan`), decided from the plan and the operands'
shapes and strides alone:

* **race** — no two CTAs write one output element (the product tiles of
  each k chunk, the closure's rows and columns); split-k chunks
  (``row_close``'s and the product's) fold each k once, and the combine
  folds each chunk's partials once;
* **coverage** — the tiles cover the output exactly (no hole), the ring's
  column limit ``ny`` reaches N, the grids cover their scratch and the
  combine's grid its outputs;
* **bounds** — grid y and z <= 65535, shared bytes <= 227 KB a CTA,
  threads whole warps, scratch pitches as the C entry points require
  (16-byte rows, X^T's pitch >= M, ``ny`` a multiple of 4 within the row
  pitch and the storage, the closure's slots and lines, the partials).

:func:`check_static` runs only these (the ``kernel-grid`` check's static
tier).

**Dynamic** (:func:`verify_case`), by running the plan on the CPU
(``simulate``) and comparing with ``repro_torch.kernels.ref`` and the
plain version: the interpreter's own **bounds** (every index checked
before the read, gather ids included), **race** (a CTA reading what
another CTA of its grid writes) and **uninit** (a partial plane read
before any CTA wrote it) findings; a surviving canary (**uninit**); a
value that differs (**padding** on a case that exercises padding, else
**mismatch**).  Static problems suppress the dynamic half.

:func:`verify_case_cuda` runs the same case through the CUDA wrapper on
the card: the output is seeded with a canary (a block of the caching
allocator filled and freed just before the call, which the wrapper's first
``torch.empty`` of that size receives), and the result must equal the
plain version bit for bit.
"""

from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from repro_torch.core.semiring import get_semiring
from repro_torch.kernels import ref

from .intercept import capture
from .simulate import (INT_CANARY, Machine, closure_owners, run_closure, run_fw_round,
                       run_minplus, run_row_close)

__all__ = ["Problem", "KINDS", "check_plan", "check_static", "plan_of", "verify_case",
           "verify_case_cuda",
           "FAMILY", "SHARED_BYTES", "recording_empty", "to_device", "canary_block"]

KINDS = ("race", "bounds", "coverage", "padding", "uninit", "mismatch")
SHARED_BYTES = 232448            # the H100's 227 KB of shared memory a CTA
GRID_YZ = 65535


@dataclass(frozen=True)
class Problem:
    """One refuted theorem: ``kind`` is drawn from :data:`KINDS`."""

    kind: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.where}: {self.message}"


def _mod(name: str):
    return importlib.import_module(f"repro_torch.kernels.{name}")


# ---------------------------------------------------------------------------
# the families: wrapper, plain version, oracle, interpreter, static checks
# ---------------------------------------------------------------------------

def _g_loop(fn, *ts):
    """Apply a 2-D oracle to each graph of batched operands."""
    if ts[0].ndim == 2:
        return fn(*ts)
    outs = [fn(*(t[i] for t in ts)) for i in range(ts[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


class _Minplus:
    @staticmethod
    def cuda(kernel, i, params=None):
        m = _mod("minplus")
        sr = i["semiring"]
        kw = dict(params or {})
        if kernel == "minplus":
            return (m.minplus_cuda(i["x"], i["y"], i.get("a"), semiring=sr, **kw),)
        if kernel == "minplus_argmin":
            return m.minplus_argmin_cuda(i["x"], i["y"], i.get("a"), semiring=sr, **kw)
        return m.minplus_pred_cuda(i["x"], i["y"], i["px"], i["py"], i.get("a"), i.get("pa"),
                                   k_offset=i["k_offset"], j_offset=i["j_offset"], semiring=sr,
                                   **kw)

    @staticmethod
    def plain(kernel, i):
        m = _mod("minplus")
        sr = i["semiring"]
        if kernel == "minplus":
            return (m.minplus_torch(i["x"], i["y"], i.get("a"), semiring=sr),)
        if kernel == "minplus_argmin":
            return m.minplus_argmin_torch(i["x"], i["y"], i.get("a"), semiring=sr)
        return m.minplus_pred_torch(i["x"], i["y"], i["px"], i["py"], i.get("a"), i.get("pa"),
                                    k_offset=i["k_offset"], j_offset=i["j_offset"],
                                    semiring=sr)

    @staticmethod
    def oracle(kernel, i):
        sr = get_semiring(i["semiring"])
        x, y, a = i["x"], i["y"], i.get("a")
        if kernel == "minplus":
            if a is None:
                return (_g_loop(lambda xx, yy: ref.minplus_ref(xx, yy, sr), x, y),)
            return (_g_loop(lambda aa, xx, yy: ref.minplus_acc_ref(aa, xx, yy, sr), a, x, y),)
        if a is None:
            z, ks = _g_loop(lambda xx, yy: ref.minplus_argmin_ref(xx, yy, sr), x, y)
        else:
            z, ks = _g_loop(lambda aa, xx, yy: ref.minplus_acc_argmin_ref(aa, xx, yy, sr),
                            a, x, y)
        if kernel == "minplus_argmin":
            return z, ks
        p = _mod("minplus").pred_from_kstar(ks, i["px"], i["py"], k_offset=i["k_offset"],
                                            j_offset=i["j_offset"], fallback=i.get("pa"))
        return z, p

    @staticmethod
    def simulate(mc, kernel, plan, i, **opts):
        ring_rows = _mod("minplus").ring_rows
        k = i["x"].shape[-1]
        y = ring_rows(i["y"]) if k else i["y"]
        z, out = run_minplus(mc, plan, i["x"], y, i.get("a"), i.get("px"), i.get("py"),
                             i.get("pa"), mode=kernel, semiring=i["semiring"],
                             k_offset=i.get("k_offset", 0), j_offset=i.get("j_offset", 0),
                             **opts)
        return (z,) if out is None else (z, out)

    @staticmethod
    def static(kernel, plan, i, col_tile=None, k_ranges=None, combine_planes=None, **_):
        out: List[Tuple[str, str]] = []
        x = i["x"]
        y = _mod("minplus").ring_rows(i["y"]) if x.shape[-1] else i["y"]
        g = x.shape[0] if x.ndim == 3 else 1
        m, k = x.shape[-2:]
        n = y.shape[-1]
        tn = 4 if kernel != "minplus" else 8
        chunks = plan.chunks
        _limits(out, kernel, plan.grid, plan.shared_bytes, plan.threads)
        if plan.threads != (plan.rows // 8) * (plan.cols // tn):
            out.append(("bounds", f"{plan.threads} threads do not hold a {plan.rows} x "
                                  f"{plan.cols} tile of 8 x {tn} outputs a thread"))
        # each k chunk's product tiles partition (g, m, n): CTAs counted a
        # tile of the output (a CTA's tile starts at a multiple of the tile
        # shape; grid z is G x chunks)
        if not out:
            cover = torch.zeros(chunks, g, -(-m // plan.rows), -(-n // plan.cols),
                                dtype=torch.int32)
            for bz in range(min(plan.grid[2], g * chunks)):
                for by in range(min(plan.grid[1], cover.shape[2])):
                    for bx in range(plan.grid[0]):
                        col = bx if col_tile is None else col_tile(bx)
                        if col < cover.shape[3]:
                            cover[bz // g, bz % g, by, col] += 1
            _partition(out, kernel, cover,
                       "output tile (k chunk, graph, row tile, column tile)")
        if plan.grid[2] != g * chunks:
            out.append(("coverage", f"grid z {plan.grid[2]} is not G x chunks = {g} x {chunks}"))
        # the k chunks fold each k once; the combine folds each chunk's
        # partials once, over every output
        ranges = (k_ranges if k_ranges is not None
                  else [plan.k_of(c, k) for c in range(chunks)] if chunks > 1 else [range(k)])
        if len(ranges) != chunks:
            out.append(("coverage", f"{len(ranges)} k chunks for a plan of {chunks}"))
        if k:
            folded = torch.zeros(k, dtype=torch.int32)
            for c, kr in enumerate(ranges):
                if not len(kr):
                    out.append(("coverage", f"k chunk {c} folds nothing"))
                folded[kr.start:kr.stop] += 1
            _partition(out, kernel, folded, "k of the fold")
        if chunks > 1:
            planes = torch.zeros(chunks, dtype=torch.int32)
            for c in (range(chunks) if combine_planes is None else combine_planes):
                if 0 <= c < chunks:
                    planes[c] += 1
            _partition(out, "minplus_combine", planes, "partial plane")
            cx, cy, cz = plan.combine_grid
            _limits(out, "minplus_combine", plan.combine_grid, 0, 256)
            if cx * 256 < n or cy < 1 or cz != 1:
                out.append(("coverage", f"the combine's grid {plan.combine_grid} does not cover "
                                        f"the ({g} x {m}, {n}) outputs"))
            need = chunks * g * m * n * (8 if kernel != "minplus" else 4)
            if plan.partial_bytes < need:
                out.append(("bounds", f"the plan's {plan.partial_bytes} partial bytes hold less "
                                      f"than the {need} its chunks write"))
        elif plan.combine_grid != (0, 0, 0):
            out.append(("coverage", f"an unsplit plan with a combine grid {plan.combine_grid}"))
        # the k-major copy and the ring's limits
        if plan.xt_pitch < m or plan.xt_pitch % 32:
            out.append(("bounds", f"X^T's pitch {plan.xt_pitch} is not M = {m} rounded up to "
                                  "32 floats"))
        if k:
            kx, ky, kz = plan.kmajor_grid
            _limits(out, "kmajor", plan.kmajor_grid, 0, 256)
            if kx * 32 != plan.xt_pitch or ky * 32 < k or kz != g:
                out.append(("coverage", f"kmajor's grid {plan.kmajor_grid} does not cover X^T "
                                        f"({g}, {k}, {plan.xt_pitch})"))
        if plan.ny < n:
            out.append(("coverage", f"the ring reads y up to column ny = {plan.ny} < N = {n}: "
                                    f"columns [{plan.ny}, {n}) are never folded"))
        if plan.ny % 4:
            out.append(("bounds", f"ny = {plan.ny} is no multiple of 4 (16-byte copies)"))
        if k > 1 and plan.ny > y.stride(-2):
            out.append(("bounds", f"ny = {plan.ny} runs past y's row pitch {y.stride(-2)}"))
        if k:
            end = (y.storage_offset() + (g - 1) * (y.stride(0) if y.ndim == 3 else 0)
                   + (k - 1) * y.stride(-2) + plan.ny)
            if end > y.untyped_storage().nbytes() // y.element_size():
                out.append(("bounds", f"the ring reads y's storage up to element {end}, past "
                                      "its end"))
        return out


class _FwBlock:
    @staticmethod
    def cuda(kernel, i, params=None):
        m = _mod("fw_block")
        if kernel == "fw_block":
            return (m.fw_block_cuda(i["d"], semiring=i["semiring"]),)
        return m.fw_block_pred_cuda(i["d"], i["p"], semiring=i["semiring"])

    @staticmethod
    def plain(kernel, i):
        m = _mod("fw_block")
        if kernel == "fw_block":
            return (m.fw_block_torch(i["d"], semiring=i["semiring"]),)
        return m.fw_block_pred_torch(i["d"], i["p"], semiring=i["semiring"])

    @staticmethod
    def oracle(kernel, i):
        if kernel == "fw_block":
            return (ref.fw_block_ref(i["d"], i["semiring"]),)
        return ref.fw_block_pred_ref(i["d"], i["p"], i["semiring"])

    @staticmethod
    def simulate(mc, kernel, plan, i, **opts):
        z, p = run_closure(mc, plan, i["d"], i.get("p"), semiring=i["semiring"], name=kernel,
                           **opts)
        return (z,) if p is None else (z, p)

    @staticmethod
    def static(kernel, plan, i, **_):
        d = i["d"]
        tiles = d.shape[0] if d.ndim == 3 else 1
        return _closure_static(kernel, plan, d.shape[-1], tiles, kernel == "fw_block_pred")


def _closure_static(label, plan, b, tiles, pred) -> List[Tuple[str, str]]:
    fb = _mod("fw_block")
    out: List[Tuple[str, str]] = []
    rows, cols = closure_owners(plan, b, tiles)
    _partition(out, label, rows, "tile row")
    _partition(out, label, cols, "tile column")
    if plan.threads % 32 or not 32 <= plan.threads <= 1024:
        out.append(("bounds", f"{plan.threads} threads a CTA are not whole warps within 1024"))
    if plan.cluster:
        slots = 4 * (3 * fb.STEP * fb.MAX_ROWS + fb.STEP * fb.STEP
                     + 2 * fb.STEP * b * (2 if pred else 1))
        if plan.cluster > fb.CLUSTER:
            out.append(("bounds", f"a cluster of {plan.cluster} CTAs exceeds the portable "
                                  f"{fb.CLUSTER}"))
        if plan.rows % fb.STEP or plan.rows > fb.MAX_ROWS:
            out.append(("bounds", f"{plan.rows} rows a CTA are not whole groups of "
                                  f"{fb.STEP} pivots within {fb.MAX_ROWS} registers"))
        if plan.shared_bytes < slots:
            out.append(("bounds", f"{plan.shared_bytes} shared bytes hold less than the "
                                  f"closure's {slots} bytes of slots"))
        if plan.shared_bytes > SHARED_BYTES:
            out.append(("bounds", f"{plan.shared_bytes} shared bytes exceed a CTA's "
                                  f"{SHARED_BYTES}"))
    else:
        if b <= fb.MAX_BLOCK or plan.threads != fb.GRID_THREADS or plan.rows or \
                plan.shared_bytes:
            out.append(("bounds", f"the grid closure's plan {tuple(plan)} is not (0, 0, "
                                  f"{fb.GRID_THREADS}, 0) above B = {fb.MAX_BLOCK}"))
        if fb.grid_lines_words(b, tiles, pred) < 4 + 2 * tiles * b * (3 if pred else 2):
            out.append(("bounds", "the grid closure's lines hold less than its rows and "
                                  "columns"))
    return out


class _FwRound:
    @staticmethod
    def cuda(kernel, i, params=None):
        m = _mod("fw_round")
        return (m.fw_round_cuda(i["d"], i["o"], block_size=i["block_size"],
                                semiring=i["semiring"]),)          # in place, on a copy

    @staticmethod
    def plain(kernel, i):
        m = _mod("fw_round")
        return (m.fw_round_torch(i["d"], i["o"], block_size=i["block_size"],
                                 semiring=i["semiring"]),)

    @staticmethod
    def oracle(kernel, i):
        """The round composed from the oracles (pivot closure, col' = col ⊗
        A*, stripe ⊕ col' ⊗ rowpanel), as the JAX package's lattice does."""
        sr = get_semiring(i["semiring"])
        d, o, b = i["d"], i["o"], i["block_size"]
        dd = d if d.ndim == 3 else d[None]
        outs = []
        for D in dd:
            piv = ref.fw_block_ref(D[o:o + b, o:o + b], sr)
            colp = ref.minplus_ref(D[:, o:o + b], piv, sr)
            outs.append(ref.minplus_acc_ref(D, colp, D[o:o + b, :], sr))
        out = torch.stack(outs)
        return (out if d.ndim == 3 else out[0],)

    @staticmethod
    def simulate(mc, kernel, plan, i, **opts):
        return (run_fw_round(mc, plan, i["d"], i["o"], block_size=i["block_size"],
                             semiring=i["semiring"], **opts),)

    @staticmethod
    def static(kernel, plan, i, **_):
        d, b = i["d"], i["block_size"]
        g = d.shape[0] if d.ndim == 3 else 1
        n = d.shape[-1]
        out = _closure_static("fw_closure", plan.closure, b, g, False)
        for grid in (plan.panels_grid, plan.colpanel_grid, plan.update_grid):
            _limits(out, "fw_round", grid, plan.shared_bytes, plan.threads)
        if plan.threads != (plan.rows // 8) * (plan.cols // 8):
            out.append(("bounds", f"{plan.threads} threads do not hold a {plan.rows} x "
                                  f"{plan.cols} ring tile"))
        for name, p, need in (("np", plan.np, n), ("bp", plan.bp, b)):
            if p < need or p % 32:
                out.append(("bounds", f"scratch pitch {name} = {p} is not >= {need} and a "
                                      "multiple of 32 floats"))
        for name, grid, (rows, cols), (th, tw) in (
                ("fw_panels", plan.panels_grid, (b, n), (32, 32)),
                ("fw_colpanel", plan.colpanel_grid, (b, n), (plan.rows, plan.cols)),
                ("fw_update", plan.update_grid, (n, n), (plan.rows, plan.cols))):
            if name == "fw_panels":
                ok = grid[0] * 32 >= n and grid[1] * 32 >= b
            else:
                ok = grid[0] * tw >= cols and grid[1] * th >= rows
            if not ok or grid[2] != g:
                out.append(("coverage", f"{name}'s grid {grid} does not cover its "
                                        f"({g}, {rows}, {cols}) output"))
        want = {"apiv": (g, b, b), "colt": (g, b, plan.np), "rowp": (g, b, plan.np),
                "coln": (g, b, plan.np), "apv": (g, b, plan.bp)}
        for name, shape in want.items():
            have = plan.scratch.get(name)
            if have is None or any(h < w for h, w in zip(have, shape)):
                out.append(("bounds", f"scratch {name} {have} is smaller than {shape}"))
        return out


class _RowClose:
    @staticmethod
    def cuda(kernel, i, params=None):
        m = _mod("row_close")
        kw = dict(params or {})
        if kernel == "row_close_pred":
            return m.row_close_pred_cuda(i["d"], i["rows"], i["pred"], semiring=i["semiring"],
                                         **kw)
        z, k = m.row_close_cuda(i["d"], i["rows"], track=kernel == "row_close_argmin",
                                semiring=i["semiring"], **kw)
        return (z,) if k is None else (z, k)

    @staticmethod
    def plain(kernel, i):
        m = _mod("row_close")
        if kernel == "row_close_pred":
            return m.row_close_pred_torch(i["d"], i["rows"], i["pred"], semiring=i["semiring"])
        z, k = m.row_close_torch(i["d"], i["rows"], track=kernel == "row_close_argmin",
                                 semiring=i["semiring"])
        return (z,) if k is None else (z, k)

    @staticmethod
    def oracle(kernel, i):
        sr = get_semiring(i["semiring"])
        d, rows = i["d"], i["rows"].long()
        dr = d[rows]
        if kernel == "row_close":
            return (ref.minplus_acc_ref(dr, dr, d, sr),)
        z, ks = ref.minplus_acc_argmin_ref(dr, dr, d, sr)
        if kernel == "row_close_argmin":
            return z, ks
        pr = i["pred"][rows]
        return z, _mod("minplus").pred_from_kstar(ks, pr, i["pred"], fallback=pr)

    @staticmethod
    def simulate(mc, kernel, plan, i, **opts):
        z, out = run_row_close(mc, plan, i["d"], i["rows"], i.get("pred"), mode=kernel,
                               semiring=i["semiring"], **opts)
        return (z,) if out is None else (z, out)

    @staticmethod
    def static(kernel, plan, i, k_ranges=None, planes=None, **_):
        out: List[Tuple[str, str]] = []
        r, n = i["rows"].numel(), i["d"].shape[0]
        grid = (-(-n // plan.cols), -(-r // plan.rows), plan.chunks)
        tn = 4 if kernel != "row_close" else 8
        _limits(out, kernel, grid, 3 * plan.depth * (plan.rows + plan.cols) * 4, 128)
        if (plan.rows // 8) * (plan.cols // tn) != 128:
            out.append(("bounds", f"a {plan.rows} x {plan.cols} tile is not 128 threads of "
                                  f"8 x {tn} outputs"))
        ranges = k_ranges if k_ranges is not None else [plan.k_of(c, n) for c in
                                                         range(plan.chunks)]
        if len(ranges) != plan.chunks:
            out.append(("coverage", f"{len(ranges)} k chunks for a plan of {plan.chunks}"))
        folded = torch.zeros(n, dtype=torch.int32)
        for c, kr in enumerate(ranges):
            if not len(kr):
                out.append(("coverage", f"k chunk {c} folds nothing"))
            folded[kr.start:kr.stop] += 1
        _partition(out, kernel, folded, "k of the fold")
        if plan.pitch < r or plan.pitch % 32:
            out.append(("bounds", f"the k-major copy's pitch {plan.pitch} is not r = {r} "
                                  "rounded up to 32"))
        need = 4 * n * plan.pitch
        if plan.chunks > 1:
            need += plan.chunks * r * n * (8 if kernel != "row_close" else 4)
        if n % 4:
            need += 4 * n * -(-n // 32) * 32
        if plan.scratch_bytes < need:
            out.append(("bounds", f"the plan's {plan.scratch_bytes} scratch bytes hold less "
                                  f"than the {need} its grids address"))
        return out


FAMILY = {
    "minplus": _Minplus, "minplus_argmin": _Minplus, "minplus_pred": _Minplus,
    "fw_block": _FwBlock, "fw_block_pred": _FwBlock,
    "fw_round": _FwRound,
    "row_close": _RowClose, "row_close_argmin": _RowClose, "row_close_pred": _RowClose,
}


def _limits(out, label, grid, shared, threads) -> None:
    gx, gy, gz = grid
    if gy > GRID_YZ or gz > GRID_YZ or gx > 2 ** 31 - 1:
        out.append(("bounds", f"{label}: grid {tuple(grid)} exceeds CUDA's y and z limit of "
                              f"{GRID_YZ}"))
    if shared > SHARED_BYTES:
        out.append(("bounds", f"{label}: {shared} shared bytes exceed a CTA's {SHARED_BYTES}"))
    if threads > 1024 or threads % 32:
        out.append(("bounds", f"{label}: {threads} threads a CTA"))


def _partition(out, label, counts: torch.Tensor, what: str) -> None:
    """Each element of ``counts`` must be 1: more is a race, 0 a hole."""
    over = counts > 1
    if bool(over.any()):
        at = tuple(int(v) for v in torch.nonzero(over)[0])
        out.append(("race", f"{label}: {what} {at} is written by {int(counts[over].max())} "
                            f"CTAs ({int(over.sum())} such)"))
    hole = counts == 0
    if bool(hole.any()):
        at = tuple(int(v) for v in torch.nonzero(hole)[0])
        out.append(("coverage", f"{label}: {what} {at} is never written ({int(hole.sum())} "
                                "such)"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def plan_of(case, inputs: Optional[dict] = None):
    """The launches the case's wrapper reports with the case's knobs,
    captured on ``meta``: its kernel's, and a split product's
    ``minplus_combine``."""
    i = case.inputs() if inputs is None else inputs
    fam = FAMILY[case.kernel]
    return capture(lambda **kw: fam.cuda(case.kernel, kw, case.params), **i)


def _one_plan(case, launches) -> Tuple[Optional[object], List[Problem]]:
    """The case's plan from its reported launches: one launch of its
    kernel, followed by one ``minplus_combine`` exactly when the plan
    splits k."""
    names = [l.kernel for l in launches]
    split = bool(launches) and getattr(launches[0].plan, "chunks", 1) > 1 and \
        case.module == "minplus"
    want = [case.kernel] + (["minplus_combine"] if split else [])
    if names != want:
        return None, [Problem("coverage", case.name,
                              f"the wrapper reported {names}, not {want}")]
    return launches[0].plan, []


def check_static(case, inputs: Optional[dict] = None) -> List[Problem]:
    """The static theorems of the case's captured plan (the ``kernel-grid``
    check's static tier): no interpreter run."""
    i = case.inputs() if inputs is None else inputs
    plan, problems = _one_plan(case, plan_of(case, i))
    if problems:
        return problems
    if case.plan_edit is not None:
        plan = case.plan_edit(plan)
    return [Problem(kind, case.name, msg)
            for kind, msg in check_plan(case.kernel, plan, i, **case.options)]


def check_plan(kernel: str, plan, inputs: dict, **options) -> List[Tuple[str, str]]:
    """Static (kind, message) problems of ``plan`` for the wrapper
    ``kernel`` on ``inputs``."""
    return FAMILY[kernel].static(kernel, plan, inputs, **options)


def _compare(got, want, case, against: str) -> List[Problem]:
    out: List[Problem] = []
    if len(got) != len(want):
        return [Problem("mismatch", case.name, f"{len(got)} outputs, {against} {len(want)}")]
    for li, (g, e) in enumerate(zip(got, want)):
        g, e = g.cpu(), e.cpu()
        if g.shape != e.shape:
            out.append(Problem("mismatch", case.name,
                               f"output {li}: shape {tuple(g.shape)} != {against}'s "
                               f"{tuple(e.shape)}"))
            continue
        if g.dtype.is_floating_point:
            canary = torch.isnan(g) & ~torch.isnan(e.float())
            bad = ~((g.float() == e.float()) | (torch.isnan(g) & torch.isnan(e.float())))
        else:
            canary = (g == INT_CANARY) & (e != INT_CANARY)
            bad = g != e
        if bool(canary.any()):
            at = tuple(int(v) for v in torch.nonzero(canary)[0])
            out.append(Problem("uninit", case.name,
                               f"output {li}: the canary survived at {at} "
                               f"({int(canary.sum())} sites): no CTA wrote it, or a fold read "
                               "an element before it was written"))
            continue
        if bool(bad.any()):
            at = tuple(int(v) for v in torch.nonzero(bad)[0])
            kind = "padding" if case.padded else "mismatch"
            tail = " (padded slices or tiles are not inert)" if case.padded else ""
            out.append(Problem(kind, case.name,
                               f"output {li}: {int(bad.sum())} entries differ from {against} "
                               f"(first at {at}: got {g[at].item()!r}, want "
                               f"{e[at].item()!r}){tail}"))
    return out


def verify_case(case) -> List[Problem]:
    """Capture the case's plan, check it statically, run it on the CPU
    and compare; [] means every theorem holds."""
    i = case.inputs()
    fam = FAMILY[case.kernel]
    plan, problems = _one_plan(case, plan_of(case, i))
    if problems:
        return problems
    if case.plan_edit is not None:
        plan = case.plan_edit(plan)
    static = check_plan(case.kernel, plan, i, **case.options)
    if static:
        return [Problem(kind, case.name, msg) for kind, msg in static]
    mc = Machine(case.name)
    got = fam.simulate(mc, case.kernel, plan, i, **case.options)
    if mc.problems:
        return [Problem(kind, case.name, msg) for kind, msg in mc.problems]
    return (_compare(got, fam.oracle(case.kernel, i), case, "the oracle")
            or _compare(got, fam.plain(case.kernel, i), case, "the plain version"))


@contextlib.contextmanager
def recording_empty(seed_first: bool = False):
    """Record every tensor ``torch.empty`` and ``torch.empty_like`` return
    inside the block (the wrappers allocate their outputs and scratch with
    them), in order; with ``seed_first`` the first is filled with the canary
    (NaN, or INT32_MIN) as it is allocated."""
    made: List[torch.Tensor] = []
    real = (torch.empty, torch.empty_like)

    def wrap(fn):
        def alloc(*args, **kwargs):
            t = fn(*args, **kwargs)
            if seed_first and not made and not t.is_meta:
                t.fill_(float("nan") if t.dtype.is_floating_point else INT_CANARY)
            made.append(t)
            return t
        return alloc

    torch.empty, torch.empty_like = wrap(real[0]), wrap(real[1])
    try:
        yield made
    finally:
        torch.empty, torch.empty_like = real


def to_device(t, device):
    """``t`` on ``device`` with its shape, strides and storage offset (a
    strided view stays a view of a copy of its storage)."""
    if not isinstance(t, torch.Tensor):
        return t
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.to(device).as_strided(t.shape, t.stride(), t.storage_offset())


def canary_block(nbytes: int, device) -> int:
    """Fill a block of ``nbytes`` of the caching allocator with NaN bytes and
    free it; returns its address.  The allocator's free blocks are released
    first, so the block and the rest of its segment merge again when it is
    freed, and the next allocation of at most that size starts at it."""
    torch.cuda.empty_cache()
    block = torch.full((max(1, -(-nbytes // 4)),), float("nan"), dtype=torch.float32,
                       device=device)
    ptr = block.data_ptr()
    del block
    return ptr


def first_allocation_bytes(case, inputs: dict) -> int:
    """Bytes of the wrapper's first allocation (its first output, or
    ``fw_round``'s first scratch), read from a ``meta`` run."""
    from .intercept import to_meta

    fam = FAMILY[case.kernel]
    meta = {k: to_meta(v) for k, v in inputs.items()}
    with recording_empty() as made:
        fam.cuda(case.kernel, meta, case.params)
    return made[0].numel() * made[0].element_size() if made else 0


def verify_case_cuda(case, device="cuda") -> Tuple[List[Problem], bool]:
    """Run the case through the CUDA wrapper on the card; (problems, canary
    hit): the wrapper's first allocation received a block filled with the
    canary just before the call, and the outputs must equal the plain
    version bit for bit."""
    i = case.inputs()
    fam = FAMILY[case.kernel]
    want = fam.plain(case.kernel, i)
    dev_i = {k: to_device(v, device) for k, v in i.items()}
    nbytes = first_allocation_bytes(case, i)
    torch.cuda.synchronize(device)
    ptr = canary_block(nbytes, device)
    with recording_empty() as made:
        got = fam.cuda(case.kernel, dev_i, case.params)
    torch.cuda.synchronize(device)
    hit = bool(made) and made[0].data_ptr() == ptr
    return _compare(tuple(t.cpu() for t in got), want, case, "the plain version"), hit
