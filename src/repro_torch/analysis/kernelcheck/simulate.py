"""A CPU interpreter of the CUDA kernels' launch plans.

The counterpart of ``repro.analysis.kernelcheck.simulate``, which runs a
Pallas body once per grid point.  The port's kernels are CUDA, so this
module runs their *plans*: for every CTA of every grid of a launch it reads
the operand elements that CTA reads (each index checked against its
operand's storage before the read), folds its output tile, k chunk or
closure rows with the plain versions' arithmetic (``minplus_torch``,
``minplus_argmin_torch``, the semiring's ⊕⊗), and writes what that CTA
writes, mirroring the index arithmetic of ``csrc/*.cu``:

* ``kmajor`` / ``rows_kmajor``: 32 x 32 tiles of X^T (or of the gathered
  ``d[rows]``^T, each gather id checked against [0, n)) into the k-major
  scratch;
* the ring fold (``fold_ring`` of ``minplus_tile.cuh``): a CTA's
  ``rows`` x ``cols`` tile over k slices of ``depth``, operands read as
  16-byte chunks of k-major rows below their column limit (the ring's
  ``ny``), k past the end staged as the semiring zero (value folds) or
  skipped (witness folds);
* the epilogues: the pred rule of ``minplus_pred``, ``row_close``'s
  finish, the split-k partial planes and their merge;
* the closures: each row owned by one CTA (``closure_plan.rows_of``, or
  the grid closure's rows c, c + C, ...), each column by one thread, B
  sequential pivot steps;
* ``fw_round``'s four grids in stream order.

Outputs and scratches start as a **canary** (NaN, INT32_MIN): an element
no CTA writes keeps it, and a fold over a canary carries it into the
result, where ``verify`` reports it.  The machine records, per grid, which
CTA wrote and read each element: two CTAs writing one element, or one
reading what another CTA of the same grid writes, is a race.  Partial
planes are read strictly: reading an element no CTA wrote is ``uninit``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.semiring import Semiring, get_semiring
from repro_torch.kernels.minplus import minplus_argmin_torch, minplus_torch

__all__ = ["Machine", "Buffer", "INT_CANARY", "run_minplus", "run_row_close",
           "run_closure", "run_fw_round", "storage_of"]

INT_CANARY = torch.iinfo(torch.int32).min
SMS = 132                 # the H100's SMs: the grid closure's CTA count
MAX_PROBLEMS = 8          # messages kept a kind a grid


def _canary(n: int, dtype) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.full((n,), float("nan"), dtype=dtype)
    return torch.full((n,), INT_CANARY, dtype=dtype)


def storage_of(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(the flat storage ``t`` lies in, as a 1-D tensor of its dtype; its
    element offset): the kernels read operands through base pointer and
    pitches, so an index is checked against the storage, not the view."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat, t.storage_offset()


@dataclass
class Buffer:
    name: str
    data: torch.Tensor            # 1-D
    strict: bool = False          # reads of unwritten elements are uninit
    written: torch.Tensor = None  # bool, 1-D

    def __post_init__(self):
        if self.written is None:
            self.written = torch.zeros(self.data.numel(), dtype=torch.bool)


@dataclass
class Machine:
    """Buffers, the running grid's access record and the problems found."""

    where: str
    problems: List[Tuple[str, str]] = field(default_factory=list)   # (kind, message)
    buffers: Dict[str, Buffer] = field(default_factory=dict)
    grid: str = ""
    _w: Dict[str, torch.Tensor] = field(default_factory=dict)
    _r: Dict[str, torch.Tensor] = field(default_factory=dict)
    _counts: Dict[Tuple[str, str], int] = field(default_factory=dict)

    # -- problems ---------------------------------------------------------

    def problem(self, kind: str, message: str) -> None:
        key = (kind, self.grid)
        self._counts[key] = self._counts.get(key, 0) + 1
        if self._counts[key] <= MAX_PROBLEMS:
            self.problems.append((kind, f"{self.grid}: {message}" if self.grid else message))

    def failed(self) -> bool:
        return bool(self.problems)

    # -- buffers ----------------------------------------------------------

    def input(self, name: str, t: torch.Tensor) -> Tuple[Buffer, int]:
        """An operand as the kernel sees it: its whole storage, initialised,
        and the element offset of its view."""
        flat, off = storage_of(t)
        buf = Buffer(name, flat.clone(), written=torch.ones(flat.numel(), dtype=torch.bool))
        self.buffers[name] = buf
        return buf, off

    def output(self, name: str, numel: int, dtype, strict: bool = False) -> Buffer:
        buf = Buffer(name, _canary(numel, dtype), strict=strict)
        self.buffers[name] = buf
        return buf

    # -- grids ------------------------------------------------------------

    def begin(self, grid: str) -> None:
        self.grid = grid
        self._w, self._r = {}, {}

    def end(self) -> None:
        for name, w in self._w.items():
            r = self._r.get(name)
            if r is None:
                continue
            bad = (w >= 0) & (r != -1) & (r != w)
            if bool(bad.any()):
                e = int(torch.nonzero(bad)[0])
                self.problem("race", f"{name}[{e}] is written by CTA {int(w[e])} and read by "
                                     f"another CTA of the same grid ({int(bad.sum())} elements)")
        self.grid = ""

    def _track(self, table: Dict[str, torch.Tensor], buf: Buffer, idx: torch.Tensor,
               cta: int) -> torch.Tensor:
        t = table.get(buf.name)
        if t is None:
            t = table[buf.name] = torch.full((buf.data.numel(),), -1, dtype=torch.int64)
        cur = t[idx]
        t[idx] = torch.where((cur == -1) | (cur == cta), torch.full_like(cur, cta),
                             torch.full_like(cur, -2))
        return cur

    def _inside(self, buf: Buffer, idx: torch.Tensor, what: str) -> bool:
        if idx.numel() == 0:
            return True
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= buf.data.numel():
            self.problem("bounds", f"{what} reads or writes {buf.name}[{lo if lo < 0 else hi}] "
                                   f"outside its {buf.data.numel()} elements")
            return False
        return True

    def read(self, buf: Buffer, idx: torch.Tensor, cta: int, what: str) -> Optional[torch.Tensor]:
        idx = idx.reshape(-1).long() if idx.ndim != 1 else idx.long()
        if not self._inside(buf, idx, what):
            return None
        if buf.strict and idx.numel() and not bool(buf.written[idx].all()):
            e = int(idx[~buf.written[idx]][0])
            self.problem("uninit", f"{what} reads {buf.name}[{e}], which no CTA wrote")
        self._track(self._r, buf, idx, cta)
        return buf.data[idx]

    def write(self, buf: Buffer, idx: torch.Tensor, values: torch.Tensor, cta: int,
              what: str) -> None:
        idx = idx.reshape(-1).long()
        values = values.reshape(-1).to(buf.data.dtype)
        if not self._inside(buf, idx, what):
            return
        cur = self._track(self._w, buf, idx, cta)
        clash = (cur >= 0) & (cur != cta)
        if bool(clash.any()):
            e = int(idx[clash][0])
            self.problem("race", f"{buf.name}[{e}] is written by CTA {int(cur[clash][0])} and "
                                 f"CTA {cta} ({int(clash.sum())} elements)")
        buf.data[idx] = values
        buf.written[idx] = True


def _ctas(dims: Sequence[int]):
    gx, gy, gz = dims
    cid = 0
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                yield cid, bx, by, bz
                cid += 1


# ---------------------------------------------------------------------------
# the ring fold
# ---------------------------------------------------------------------------

def _ring_tile(mc: Machine, buf: Buffer, base: int, ld: int, limit: int, c0: int, width: int,
               k_rows: int, k_real: int, fill_k: float, cta: int, what: str):
    """A (k_rows, width) slice stack as the ring stages it: rows k < k_real
    of 16-byte chunks at columns c0 + 4q < limit read from ``buf``, columns
    at or past the limit staged as 0, rows k >= k_real as ``fill_k``."""
    out = torch.zeros(k_rows, width, dtype=torch.float32)
    if k_real < k_rows:
        out[k_real:] = fill_k
    starts = torch.arange(0, width, 4)
    ok = starts[c0 + starts < limit]
    if k_real and ok.numel():
        cols = (ok[:, None] + torch.arange(4)[None, :]).reshape(-1)
        idx = base + torch.arange(k_real)[:, None] * ld + (c0 + cols)[None, :]
        vals = mc.read(buf, idx, cta, what)
        if vals is None:
            return None
        out[:k_real, cols] = vals.reshape(k_real, -1).to(torch.float32)
    return out


def _fold(mc: Machine, sr: Semiring, cta: int, xt: Buffer, x_base: int, ldx: int, nx: int,
          y: Buffer, y_base: int, ldy: int, ny: int, m0: int, n0: int, k: int, rows: int,
          cols: int, depth: int, acc: torch.Tensor, track: bool, fill_k: Optional[float],
          what: str):
    """One CTA's ``fold_ring``: (acc, idx) over k = 0..K from ``acc`` (idx
    -1), or None after a bounds problem."""
    kp = k if track else -(-k // depth) * depth
    fill = sr.zero if fill_k is None else fill_k
    xs = _ring_tile(mc, xt, x_base, ldx, nx, m0, rows, kp, k, fill, cta, what + " x")
    ys = _ring_tile(mc, y, y_base, ldy, ny, n0, cols, kp, k, fill, cta, what + " y")
    if xs is None or ys is None:
        return None
    if track:
        return minplus_argmin_torch(xs.T.contiguous(), ys, acc, semiring=sr)
    return minplus_torch(xs.T.contiguous(), ys, acc, semiring=sr), None


def _grid_dims_ok(mc: Machine, name: str, dims: Sequence[int]) -> bool:
    gx, gy, gz = dims
    if min(dims) < 0 or gx > 2 ** 31 - 1 or gy > 65535 or gz > 65535:
        mc.problem("bounds", f"{name}: grid {tuple(dims)} exceeds CUDA's limits")
        return False
    return True


# ---------------------------------------------------------------------------
# minplus.cu
# ---------------------------------------------------------------------------

def run_minplus(mc: Machine, plan, x: torch.Tensor, y: torch.Tensor,
                a: Optional[torch.Tensor] = None, px=None, py=None, pa=None, *,
                mode: str = "minplus", semiring="tropical", k_offset: int = 0,
                j_offset: int = 0, fill_k: Optional[float] = None,
                col_tile: Optional[Callable[[int], int]] = None):
    """Run a ``minplus`` launch plan: (z, out) shaped as the wrapper's
    outputs (out None in value mode).  ``y`` is what the ring reads (the
    wrapper's ``ring_rows(y)``).  ``fill_k`` and ``col_tile`` exist for the
    mutants: the staged value of k past the end, and the column tile a
    CTA's grid x maps to."""
    sr = get_semiring(semiring)
    batched = x.ndim == 3
    g = x.shape[0] if batched else 1
    m, k = x.shape[-2:]
    n = y.shape[-1]
    track = mode != "minplus"
    xb, xo = mc.input("x", x)
    yb, yo = mc.input("y", y)
    xgs, xrs = (x.stride(0) if batched else 0), x.stride(-2)
    ygs, yrs = (y.stride(0) if batched else 0), y.stride(-2)
    mp = plan.xt_pitch
    xt = mc.output("xt", g * k * mp, torch.float32)
    z = mc.output("z", g * m * n, torch.float32)
    out = mc.output("out", g * m * n, torch.int32) if track else None
    ab = ao = None
    if a is not None:
        ab, ao = mc.input("a", a)
        ags, ars = (a.stride(0) if batched else 0), a.stride(-2)
    if mode == "minplus_pred":
        pxb, pxo = mc.input("px", px)
        pyb, pyo = mc.input("py", py)
        pab = pao = None
        if pa is not None:
            pab, pao = mc.input("pa", pa)

    if k:
        mc.begin("kmajor")
        if _grid_dims_ok(mc, "kmajor", plan.kmajor_grid):
            for cid, bx, by, bz in _ctas(plan.kmajor_grid):
                m0, k0 = bx * 32, by * 32
                rr = torch.arange(m0, m0 + 32)
                kk = torch.arange(k0, k0 + 32)
                tile = torch.zeros(32, 32)
                rv, kv = rr[rr < m], kk[kk < k]
                if rv.numel() and kv.numel():
                    vals = mc.read(xb, xo + bz * xgs + rv[:, None] * xrs + kv[None, :], cid,
                                   "kmajor")
                    if vals is None:
                        continue
                    tile[: rv.numel(), : kv.numel()] = vals.reshape(rv.numel(), kv.numel())
                if kv.numel():
                    idx = bz * k * mp + kv[:, None] * mp + rr[None, :]
                    mc.write(xt, idx, tile[:, : kv.numel()].T, cid, "kmajor")
        mc.end()
        if mc.failed():
            return None, None

    mc.begin(mode)
    if _grid_dims_ok(mc, mode, plan.grid):
        for cid, bx, by, bz in _ctas(plan.grid):
            m0 = by * plan.rows
            n0 = (bx if col_tile is None else col_tile(bx)) * plan.cols
            rr = torch.arange(m0, m0 + plan.rows)
            cc = torch.arange(n0, n0 + plan.cols)
            rv, cv = rr[rr < m], cc[cc < n]
            acc = torch.full((plan.rows, plan.cols), sr.zero)
            if a is not None and rv.numel() and cv.numel():
                vals = mc.read(ab, ao + bz * ags + rv[:, None] * ars + cv[None, :], cid,
                               "accumulator")
                if vals is None:
                    continue
                acc[: rv.numel(), : cv.numel()] = vals.reshape(rv.numel(), cv.numel())
            got = _fold(mc, sr, cid, xt, bz * k * mp, mp, mp, yb, yo + bz * ygs, yrs, plan.ny,
                        m0, n0, k, plan.rows, plan.cols, plan.depth, acc, track, fill_k,
                        "ring")
            if got is None:
                continue
            val, kst = got
            if not (rv.numel() and cv.numel()):
                continue
            val = val[: rv.numel(), : cv.numel()]
            e = (bz * m + rv[:, None]) * n + cv[None, :]
            mc.write(z, e, val, cid, "store")
            if mode == "minplus_argmin":
                mc.write(out, e, kst[: rv.numel(), : cv.numel()], cid, "store")
            elif mode == "minplus_pred":
                ks = kst[: rv.numel(), : cv.numel()].long()
                r2, c2 = rv[:, None].expand_as(ks), cv[None, :].expand_as(ks)
                p = torch.full(ks.shape, -1, dtype=torch.int32)
                kept = ks < 0
                if pab is not None and bool(kept.any()):
                    pags, pars = (pa.stride(0) if batched else 0), pa.stride(-2)
                    v = mc.read(pab, pao + bz * pags + r2[kept] * pars + c2[kept], cid, "pa")
                    if v is None:
                        continue
                    p[kept] = v
                own = ~kept & (ks + k_offset == c2 + j_offset)
                via = ~kept & ~own
                if bool(own.any()):
                    pxgs, pxrs = (px.stride(0) if batched else 0), px.stride(-2)
                    v = mc.read(pxb, pxo + bz * pxgs + r2[own] * pxrs + ks[own], cid, "px")
                    if v is None:
                        continue
                    p[own] = v
                if bool(via.any()):
                    pygs, pyrs = (py.stride(0) if batched else 0), py.stride(-2)
                    v = mc.read(pyb, pyo + bz * pygs + ks[via] * pyrs + c2[via], cid, "py")
                    if v is None:
                        continue
                    p[via] = v
                mc.write(out, e, p, cid, "pred epilogue")
    mc.end()
    shape = x.shape[:-1] + (n,)
    zt = z.data.reshape(shape)
    return zt, (out.data.reshape(shape) if out is not None else None)


# ---------------------------------------------------------------------------
# row_close.cu
# ---------------------------------------------------------------------------

def run_row_close(mc: Machine, plan, d: torch.Tensor, rows: torch.Tensor,
                  pred: Optional[torch.Tensor] = None, *, mode: str = "row_close",
                  semiring="tropical", k_ranges: Optional[List[range]] = None,
                  planes: Optional[int] = None, fill_k: Optional[float] = None):
    """Run a ``row_close`` launch plan: (z, out) as the wrapper's outputs.
    ``k_ranges`` (the k each chunk folds; default ``plan.k_of``) and
    ``planes`` (the partial planes the merge folds; default ``plan.chunks``)
    exist for the mutants."""
    sr = get_semiring(semiring)
    r, n = rows.numel(), d.shape[0]
    track = mode != "row_close"
    chunks = plan.chunks
    ranges = k_ranges if k_ranges is not None else [plan.k_of(c, n) for c in range(chunks)]
    nplanes = chunks if planes is None else planes
    db, do = mc.input("d", d)
    rb, ro = mc.input("rows", rows)
    pb = po = None
    if mode == "row_close_pred":
        pb, po = mc.input("pred", pred)
    if n % 4:
        ldy = ny = -(-n // 32) * 32
        yfull = torch.full((n, ldy), float("nan"))
        yfull[:, :n] = d
        yb, yo = mc.input("y", yfull)
    else:
        yb, yo, ldy, ny = db, do, n, n
    rp = plan.pitch
    xt = mc.output("xt", n * rp, torch.float32)
    z = mc.output("z", r * n, torch.float32)
    out = mc.output("out", r * n, torch.int32) if track else None
    split = len(ranges) > 1 or nplanes > 1
    pz = pk = None
    if split:
        pz = mc.output("partial values", nplanes * r * n, torch.float32, strict=True)
        if track:
            pk = mc.output("partial k", nplanes * r * n, torch.int32, strict=True)

    def gathered(i: torch.Tensor, cta: int, what: str) -> Optional[torch.Tensor]:
        ids = mc.read(rb, ro + i, cta, what + " rows")
        if ids is None:
            return None
        bad = (ids < 0) | (ids >= n)
        if bool(bad.any()):
            mc.problem("bounds", f"{what}: gather id {int(ids[bad][0])} outside [0, {n})")
            return None
        return ids.long()

    def finish(cta: int, i: torch.Tensor, j: torch.Tensor, v: torch.Tensor,
               kst: Optional[torch.Tensor]) -> None:
        src = gathered(i, cta, "finish")
        if src is None:
            return
        a = mc.read(db, do + src * n + j, cta, "finish start value")
        if a is None:
            return
        e = i * n + j
        if not track:
            mc.write(z, e, sr.add(a, v), cta, "finish")
            return
        won = sr.better(v, a)
        mc.write(z, e, torch.where(won, v, a), cta, "finish")
        if mode == "row_close_argmin":
            mc.write(out, e, torch.where(won, kst, torch.full_like(kst, -1)), cta, "finish")
            return
        via = won & (kst != j)
        p = mc.read(pb, po + src * n + j, cta, "finish pred")
        if p is None:
            return
        if bool(via.any()):
            pv = mc.read(pb, po + kst[via].long() * n + j[via], cta, "finish pred")
            if pv is None:
                return
            p = p.clone()
            p[via] = pv
        mc.write(out, e, p, cta, "finish")

    mc.begin("rows_kmajor")
    dims = (rp // 32, -(-n // 32), 1)
    if _grid_dims_ok(mc, "rows_kmajor", dims):
        for cid, bx, by, _ in _ctas(dims):
            m0, k0 = bx * 32, by * 32
            rr = torch.arange(m0, m0 + 32)
            kk = torch.arange(k0, k0 + 32)
            rv, kv = rr[rr < r], kk[kk < n]
            tile = torch.zeros(32, 32)
            if rv.numel() and kv.numel():
                src = gathered(rv, cid, "rows_kmajor")
                if src is None:
                    continue
                vals = mc.read(db, do + src[:, None] * n + kv[None, :], cid, "rows_kmajor")
                if vals is None:
                    continue
                tile[: rv.numel(), : kv.numel()] = vals.reshape(rv.numel(), kv.numel())
            if kv.numel():
                mc.write(xt, kv[:, None] * rp + rr[None, :], tile[:, : kv.numel()].T, cid,
                         "rows_kmajor")
    mc.end()
    if mc.failed():
        return None, None

    mc.begin(mode)
    dims = (-(-n // plan.cols), -(-r // plan.rows), len(ranges))
    if _grid_dims_ok(mc, mode, dims):
        for cid, bx, by, c in _ctas(dims):
            m0, n0 = by * plan.rows, bx * plan.cols
            kr = ranges[c]
            k0, kn = kr.start, len(kr)
            acc = torch.full((plan.rows, plan.cols), sr.zero)
            got = _fold(mc, sr, cid, xt, k0 * rp, rp, rp, yb, yo + k0 * ldy, ldy, ny, m0, n0,
                        kn, plan.rows, plan.cols, plan.depth, acc, track, fill_k, "ring")
            if got is None:
                continue
            val, kst = got
            rr = torch.arange(m0, m0 + plan.rows)
            cc = torch.arange(n0, n0 + plan.cols)
            rv, cv = rr[rr < r], cc[cc < n]
            if not (rv.numel() and cv.numel()):
                continue
            val = val[: rv.numel(), : cv.numel()].reshape(-1)
            if track:
                kl = kst[: rv.numel(), : cv.numel()].reshape(-1)
                kst = torch.where(kl < 0, kl, kl + k0)
            i = rv[:, None].expand(rv.numel(), cv.numel()).reshape(-1)
            j = cv[None, :].expand(rv.numel(), cv.numel()).reshape(-1)
            if not split:
                finish(cid, i, j, val, kst)
            else:
                e = (c * r + i) * n + j
                mc.write(pz, e, val, cid, "partial")
                if track:
                    mc.write(pk, e, kst, cid, "partial")
    mc.end()
    if not split or mc.failed():
        return z.data.reshape(r, n), None if out is None else out.data.reshape(r, n)

    mc.begin("row_close_merge")
    dims = (-(-n // 256), min(r, 65535), 1)
    for cid, bx, by, _ in _ctas(dims):
        j = torch.arange(bx * 256, min(n, bx * 256 + 256))
        for i0 in range(by, r, dims[1]):
            v = torch.full((j.numel(),), sr.zero)
            kst = torch.full((j.numel(),), -1, dtype=torch.int32) if track else None
            for c in range(nplanes):
                e = (c * r + i0) * n + j
                pv = mc.read(pz, e, cid, "merge")
                if pv is None:
                    break
                if not track:
                    v = sr.add(v, pv)
                    continue
                pkv = mc.read(pk, e, cid, "merge")
                if pkv is None:
                    break
                won = sr.better(pv, v)
                v = torch.where(won, pv, v)
                kst = torch.where(won, pkv, kst)
            finish(cid, torch.full_like(j, i0), j, v, kst)
    mc.end()
    return z.data.reshape(r, n), None if out is None else out.data.reshape(r, n)


# ---------------------------------------------------------------------------
# fw_closure.cuh: the cluster and grid closures
# ---------------------------------------------------------------------------

def closure_owners(plan, b: int, tiles: int, sms: int = SMS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols): for each (tile, row) the number of CTAs that own it,
    and for each column the number of threads that own it, under ``plan``
    (the cluster plan, or the grid closure's with C = min(sms, tiles * B)
    CTAs of rows c, c + C, ... and threads of columns j, j + threads, ...)."""
    rows = torch.zeros(tiles, b, dtype=torch.int64)
    cols = torch.zeros(b, dtype=torch.int64)
    if plan.cluster:
        for c in range(plan.cluster):
            lo, hi = c * plan.rows, (c + 1) * plan.rows
            if lo < b:
                rows[:, lo:min(hi, b)] += 1
        cols[: min(plan.threads, b)] += 1
    else:
        ctas = min(sms, tiles * b)
        owned = torch.zeros(tiles * b, dtype=torch.int64)
        for c in range(ctas):
            owned[c::ctas] += 1
        rows = owned.reshape(tiles, b)
        for j in range(min(plan.threads, b)):
            cols[j::plan.threads] += 1
    return rows, cols


def run_closure(mc: Machine, plan, d: torch.Tensor, p: Optional[torch.Tensor] = None, *,
                semiring="tropical", sms: int = SMS, name: str = "closure"):
    """Close the (T, B, B) (or (B, B)) tiles ``d`` (any float dtype, f32
    arithmetic, rounded once to ``d``'s dtype) under ``plan``: each element
    is loaded and stepped by the CTA and thread that own it; an element no
    one owns keeps the canary, one owned twice is a race."""
    sr = get_semiring(semiring)
    squeeze = d.ndim == 2
    dd = d[None] if squeeze else d
    tiles, b = dd.shape[0], dd.shape[-1]
    mc.begin(name)
    rows, cols = closure_owners(plan, b, tiles, sms)
    if bool((rows > 1).any()) or bool((cols > 1).any()):
        mc.problem("race", f"a row or column of the tile is owned by two CTAs or threads "
                           f"(rows {rows.max().item()}, columns {cols.max().item()} owners)")
    owned = (rows == 1)[:, :, None] & (cols == 1)[None, None, :]
    cur = torch.full(dd.shape, float("nan"))
    cur[owned] = dd.float()[owned]
    pc = None
    if p is not None:
        pp = p[None] if squeeze else p
        pc = torch.full(pp.shape, INT_CANARY, dtype=torch.int32)
        pc[owned] = pp[owned]
    for k in range(b):
        row, col = cur[:, k:k + 1, :].clone(), cur[:, :, k:k + 1].clone()
        via = sr.mul(col, row)
        if pc is None:
            upd = sr.add(cur, via)
        else:
            better = sr.better(via, cur) & owned
            upd = torch.where(better, via, cur)
            pc = torch.where(better, pc[:, k:k + 1, :].expand_as(pc), pc)
        cur = torch.where(owned, upd, cur)
    mc.end()
    out = cur.to(d.dtype) if d.dtype != torch.float32 else cur
    if squeeze:
        return out[0], None if pc is None else pc[0]
    return out, pc


# ---------------------------------------------------------------------------
# fw_round.cu
# ---------------------------------------------------------------------------

def run_fw_round(mc: Machine, plan, d: torch.Tensor, o: int, *, block_size: int,
                 semiring="tropical", sms: int = SMS):
    """Run a ``fw_round`` launch plan on a copy of ``d`` ((N, N) or
    (G, N, N), f32 or bf16): the closure into ``apiv``, ``fw_panels``,
    ``fw_colpanel``, ``fw_update``; returns the updated copy."""
    sr = get_semiring(semiring)
    dd = d[None] if d.ndim == 2 else d
    g, n, b = dd.shape[0], dd.shape[-1], int(block_size)
    dt = d.dtype
    np_, bp = plan.np, plan.bp
    state, _ = mc.input("d", dd.float().contiguous())

    def rnd(v: torch.Tensor) -> torch.Tensor:
        return v.to(dt).float() if dt != torch.float32 else v

    apiv = mc.output("apiv", g * b * b, torch.float32)
    coln = mc.output("coln", g * b * np_, torch.float32)
    rowp = mc.output("rowp", g * b * np_, torch.float32)
    colt = mc.output("colt", g * b * np_, torch.float32)
    apv = mc.output("apv", g * b * bp, torch.float32)

    # 1. the closure of each graph's pivot block, into apiv
    piv = state.data.reshape(g, n, n)[:, o:o + b, o:o + b]
    closed, _ = run_closure(mc, plan.closure, piv.to(dt), semiring=sr, sms=sms,
                            name="fw_closure" if plan.closure.cluster else "fw_closure_grid")
    mc.begin("apiv store")
    mc.write(apiv, torch.arange(g * b * b), closed.float().reshape(-1), 0, "closure")
    mc.end()

    # 2. fw_panels
    mc.begin("fw_panels")
    if _grid_dims_ok(mc, "fw_panels", plan.panels_grid):
        for cid, bx, by, bz in _ctas(plan.panels_grid):
            i = torch.arange(bx * 32, bx * 32 + 32)
            kk = torch.arange(by * 32, by * 32 + 32)
            iv, kv = i[i < n], kk[kk < b]
            if not (iv.numel() and kv.numel()):
                continue
            base = bz * n * n
            colv = mc.read(state, base + iv[None, :] * n + o + kv[:, None], cid, "column panel")
            rowv = mc.read(state, base + (o + kv[:, None]) * n + iv[None, :], cid, "row panel")
            if colv is None or rowv is None:
                continue
            off = bz * b * np_ + kv[:, None] * np_ + iv[None, :]
            mc.write(coln, off, colv, cid, "coln")
            mc.write(rowp, off, rowv, cid, "rowp")
            ib = iv[iv < b]
            if ib.numel():
                av = mc.read(apiv, (bz * b + kv[:, None]) * b + ib[None, :], cid, "apiv")
                if av is None:
                    continue
                mc.write(apv, (bz * b + kv[:, None]) * bp + ib[None, :], av, cid, "apv")
    mc.end()

    # 3. fw_colpanel: col'^T = A*^T ⊗ colpanel^T into colt
    mc.begin("fw_colpanel")
    if _grid_dims_ok(mc, "fw_colpanel", plan.colpanel_grid):
        for cid, bx, by, bz in _ctas(plan.colpanel_grid):
            m0, n0 = by * plan.rows, bx * plan.cols
            acc = torch.full((plan.rows, plan.cols), sr.zero)
            got = _fold(mc, sr, cid, apv, bz * b * bp, bp, bp, coln, bz * b * np_, np_, np_, m0,
                        n0, b, plan.rows, plan.cols, plan.depth, acc, False, None, "ring")
            if got is None:
                continue
            rr = torch.arange(m0, m0 + plan.rows)
            cc = torch.arange(n0, n0 + plan.cols)
            rv, cv = rr[rr < b], cc[cc < n]
            if rv.numel() and cv.numel():
                mc.write(colt, bz * b * np_ + rv[:, None] * np_ + cv[None, :],
                         rnd(got[0][: rv.numel(), : cv.numel()]), cid, "colt")
    mc.end()

    # 4. fw_update: D = D ⊕ col' ⊗ rowpanel, in place
    mc.begin("fw_update")
    if _grid_dims_ok(mc, "fw_update", plan.update_grid):
        for cid, bx, by, bz in _ctas(plan.update_grid):
            m0, n0 = by * plan.rows, bx * plan.cols
            rr = torch.arange(m0, m0 + plan.rows)
            cc = torch.arange(n0, n0 + plan.cols)
            rv, cv = rr[rr < n], cc[cc < n]
            acc = torch.full((plan.rows, plan.cols), sr.zero)
            e = bz * n * n + rv[:, None] * n + cv[None, :]
            if rv.numel() and cv.numel():
                vals = mc.read(state, e, cid, "accumulator")
                if vals is None:
                    continue
                acc[: rv.numel(), : cv.numel()] = vals.reshape(rv.numel(), cv.numel())
            got = _fold(mc, sr, cid, colt, bz * b * np_, np_, np_, rowp, bz * b * np_, np_, np_,
                        m0, n0, b, plan.rows, plan.cols, plan.depth, acc, False, None, "ring")
            if got is None or not (rv.numel() and cv.numel()):
                continue
            mc.write(state, e, rnd(got[0][: rv.numel(), : cv.numel()]), cid, "store")
    mc.end()
    res = state.data[: g * n * n].reshape(g, n, n).to(dt)
    return res[0] if d.ndim == 2 else res
