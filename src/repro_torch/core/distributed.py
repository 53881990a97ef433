"""Distributed APSP — the paper's future-work item ("use multiple devices"),
ported from ``repro.core.distributed``.

The distance matrix D (N, N) lives as a 2D block grid over a device mesh
(``launch.mesh.Mesh``): rows sharded over ``row_axes`` (single-pod:
``("data",)``; multi-pod: ``("pod", "data")``, the pod axis carrying
row-parallelism), columns over ``col_axes`` (``("model",)``).  Every
function below runs on every rank of the mesh (the body of the
reference's ``shard_map``) and takes and returns the rank's local block
of each global matrix, except :func:`apsp_distributed`, which takes and
returns the global matrix on every rank.

Three solvers:

* ``summa_minplus``      — tropical SUMMA: k-panel loop, each panel broadcast
                           along the orthogonal mesh axis, local min-plus
                           accumulation.  O(N^2 (1/nr + 1/nc)) bytes moved per
                           product, O(panel) live memory.
* ``squaring_distributed`` — paper-faithful FW-GPU at scale: ceil(log2 N)
                           SUMMA squarings.
* ``fw_distributed``     — distributed 3-phase blocked FW: per pivot tile,
                           close on every rank (replicated B^3 — cheaper
                           than a round-trip), broadcast the row panel along
                           the row axes and the col panel along the col axes,
                           then one local fused min-plus-accumulate.

The reference's masked ``psum`` broadcasts are broadcasts from the owning
rank inside the group of the axes they span (``Mesh.broadcast``): exact
under every semiring.  Only the owner computes a panel it broadcasts
(the reference's SPMD body computes it everywhere and masks it), so a
rank launches one product a pivot for the update and one for each panel
it owns.  Every local product is ``kernels.ops.minplus`` (the ``minplus``
kernel on the card) and the pivot closure is ``core.blocked_fw.
closure_block`` (``fw_block``); the slices handed to them are views with
unit column stride, which the product kernel reads through their pitch.

``rkleene_distributed`` runs the R-Kleene recursion over global sharded
matrices, with every quadrant product a ``summa_minplus`` and leaves
closed by ``fw_distributed`` — the "divide the tensor" answer to the
paper's memory wall.  A quadrant is re-laid over the whole mesh, as XLA
reshards the reference's slices: each piece moves by one broadcast from
its owner over the mesh (``_regrid``).

:func:`shard_matrix` and :func:`gather_matrix` move a global matrix to
the ranks' blocks and back.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Tuple

import numpy as np
import torch

from .blocked_fw import closure_block
from .semiring import TROPICAL, Semiring, ceil_log2, get_semiring, pad_to_multiple

if TYPE_CHECKING:
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import PartitionSpec

__all__ = [
    "summa_minplus",
    "squaring_distributed",
    "fw_distributed",
    "rkleene_distributed",
    "apsp_distributed",
    "dist_spec",
    "shard_matrix",
    "gather_matrix",
]


def _ops():
    from repro_torch.kernels import ops  # lazy: the kernels import core

    return ops


def dist_spec(multi_pod: bool = False) -> "PartitionSpec":
    """PartitionSpec of the distributed distance matrix on our meshes."""
    from repro_torch.sharding import PartitionSpec as P

    return P(("pod", "data"), "model") if multi_pod else P("data", "model")


def _panel_coords(p: int, panels_per_shard: int, panel: int) -> Tuple[int, int]:
    """Which shard owns global k-panel ``p``, and the local offset inside it."""
    shard, i = divmod(p, panels_per_shard)
    return shard, i * panel


def _owned(src: torch.Tensor, mine: bool, shape, like: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``src`` on its owner, an empty buffer of
    ``shape`` elsewhere: what a broadcast sends and receives."""
    return src.contiguous() if mine else torch.empty(shape, dtype=like.dtype, device=like.device)


def summa_minplus(
    x: torch.Tensor,
    y: torch.Tensor,
    acc: torch.Tensor | None = None,
    *,
    mesh: "Mesh",
    row_axes: Tuple[str, ...] = ("data",),
    col_axes: Tuple[str, ...] = ("model",),
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """Semiring SUMMA (tropical by default): Z = X (x) Y on the 2D block grid.

    ``x``, ``y`` (and ``acc``) are this rank's blocks of global (m, k),
    (k, n) (and (m, n)) matrices; returns its block of Z.  Panel count =
    lcm(nr, nc), so it works on non-square grids (the multi-pod (32-row,
    16-col) layout).  Per panel: X's (m_l, k/P) column slice is broadcast
    along ``col_axes`` from its owner, Y's (k/P, n_l) row slice along
    ``row_axes``, then a local fused min-plus accumulate.

    ``acc`` fuses Z = acc (+) X (x) Y: it seeds the panel loop's running
    ⊕, so the accumulate costs no second pass over the output blocks.
    """
    sr = get_semiring(semiring)
    nr, nc = mesh.axis_size(row_axes), mesh.axis_size(col_axes)
    m_l, kx = x.shape
    ky, n_l = y.shape
    k = kx * nc
    assert k == ky * nr, (x.shape, y.shape, nr, nc)
    npanels = math.lcm(nr, nc)
    assert k % npanels == 0, (k, npanels)
    panel = k // npanels
    x_pps = npanels // nc   # x k-panels per column shard
    y_pps = npanels // nr   # y k-panels per row shard
    r, c = mesh.axis_index(row_axes), mesh.axis_index(col_axes)

    a = acc if acc is not None else torch.full((m_l, n_l), sr.zero, dtype=x.dtype,
                                                device=x.device)
    for p in range(npanels):
        xc, xoff = _panel_coords(p, x_pps, panel)
        yc, yoff = _panel_coords(p, y_pps, panel)
        xp = _owned(x[:, xoff:xoff + panel], c == xc, (m_l, panel), x)
        yp = _owned(y[yoff:yoff + panel], r == yc, (panel, n_l), y)
        mesh.broadcast(xp, col_axes, xc)
        mesh.broadcast(yp, row_axes, yc)
        a = _ops().minplus(xp, yp, a, semiring=sr)     # fused local accumulate
    return a


def squaring_distributed(
    h: torch.Tensor,
    *,
    mesh: "Mesh",
    row_axes: Tuple[str, ...] = ("data",),
    col_axes: Tuple[str, ...] = ("model",),
    iters: int | None = None,
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """Paper-faithful FW-GPU at scale: D <- D (+) D (x) D, ceil(log2 N) times
    (N the global size)."""
    n = h.shape[0] * mesh.axis_size(row_axes)
    d = h
    for _ in range(ceil_log2(n) if iters is None else iters):
        d = summa_minplus(d, d, d, mesh=mesh, row_axes=row_axes, col_axes=col_axes,
                          semiring=semiring)
    return d


def fw_distributed(
    h: torch.Tensor,
    *,
    mesh: "Mesh",
    row_axes: Tuple[str, ...] = ("data",),
    col_axes: Tuple[str, ...] = ("model",),
    block_size: int = 512,
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """Distributed 3-phase blocked Floyd-Warshall (O(N^3) work total).

    Requires ``block_size`` to divide the local block in both dims.  Per
    pivot t: replicated pivot closure; row panel (B, n_l) broadcast along
    the row axes; col panel (m_l, B) broadcast along the col axes; one local
    min-plus accumulate touches every local element once.
    """
    sr = get_semiring(semiring)
    nr, nc = mesh.axis_size(row_axes), mesh.axis_size(col_axes)
    m_l, n_l = h.shape           # n/nr, n/nc
    n = m_l * nr
    b = block_size
    assert n == n_l * nc and n % (nr * b) == 0 and n % (nc * b) == 0, (n, nr, nc, b)
    bpr, bpc = m_l // b, n_l // b   # pivot blocks per row / col shard
    r, c = mesh.axis_index(row_axes), mesh.axis_index(col_axes)
    everyone = tuple(row_axes) + tuple(col_axes)

    d = h
    for t in range(n // b):
        orow, roff = _panel_coords(t, bpr, b)   # owner row shard, local row offset
        ocol, coff = _panel_coords(t, bpc, b)

        # -- phase 1: the owner's pivot block to every rank, closed everywhere --
        pv = _owned(d[roff:roff + b, coff:coff + b], r == orow and c == ocol, (b, b), d)
        mesh.broadcast(pv, everyone, orow * nc + ocol)
        pv = closure_block(pv, sr)

        # -- phase 2a: row panel (pivot rows x my cols), computed by the owner row
        if r == orow:
            rp = _ops().minplus(pv, d[roff:roff + b], semiring=sr)  # pivot diag one => subsumes old
        else:
            rp = torch.empty((b, n_l), dtype=d.dtype, device=d.device)
        mesh.broadcast(rp, row_axes, orow)

        # -- phase 2b: col panel (my rows x pivot cols), computed by the owner col;
        # owner-row ranks overwrite their pivot rows with the closed pivot so
        # phase 3 re-derives the row/col panels exactly.
        if c == ocol:
            cp = _ops().minplus(d[:, coff:coff + b], pv, semiring=sr)
            if r == orow:
                cp[roff:roff + b] = pv
        else:
            cp = torch.empty((m_l, b), dtype=d.dtype, device=d.device)
        mesh.broadcast(cp, col_axes, ocol)

        # -- phase 3: one fused local update touches all of d once --
        d = _ops().minplus(cp, rp, d, semiring=sr)
    return d


# ---------------------------------------------------------------------------
# moving blocks: global <-> local, and sub-matrices re-laid over the mesh
# ---------------------------------------------------------------------------

def _regrid(sources, dst_off: Tuple[int, int], dst_shape: Tuple[int, int], *,
            mesh: "Mesh", row_axes, col_axes) -> torch.Tensor:
    """This rank's block of the global region ``dst_shape`` at ``dst_off``,
    from ``sources``: (local block, global offset, global shape) of global
    matrices laid over the same grid that together cover the region.  A
    piece that another rank holds moves by one broadcast from its owner
    over the mesh (every rank takes part, in the same order); a piece
    this rank holds is copied."""
    nr, nc = mesh.axis_size(row_axes), mesh.axis_size(col_axes)
    everyone = tuple(row_axes) + tuple(col_axes)
    me = mesh.axis_index(everyone)          # this rank is grid block (me // nc, me % nc)
    bh, bw = dst_shape[0] // nr, dst_shape[1] // nc
    like = sources[0][0]
    out = torch.empty((bh, bw), dtype=like.dtype, device=like.device)
    for dst in range(nr * nc):
        r0, c0 = dst_off[0] + dst // nc * bh, dst_off[1] + dst % nc * bw
        for local, (sr0, sc0), (sh, sw) in sources:
            sbh, sbw = sh // nr, sw // nc
            for src in range(nr * nc):
                # source block src covers rows [s_top, s_top + sbh), cols [s_lft, s_lft + sbw)
                s_top, s_lft = sr0 + src // nc * sbh, sc0 + src % nc * sbw
                top, bot = max(r0, s_top), min(r0 + bh, s_top + sbh)
                lft, rgt = max(c0, s_lft), min(c0 + bw, s_lft + sbw)
                if top >= bot or lft >= rgt:
                    continue
                piece = (slice(top - s_top, bot - s_top), slice(lft - s_lft, rgt - s_lft))
                into = (slice(top - r0, bot - r0), slice(lft - c0, rgt - c0))
                if src != dst:
                    buf = _owned(local[piece], me == src, (bot - top, rgt - lft), local)
                    mesh.broadcast(buf, everyone, src)
                elif me == dst:
                    buf = local[piece]
                if me == dst:
                    out[into] = buf
    return out


def shard_matrix(h: torch.Tensor, mesh: "Mesh", spec: "PartitionSpec") -> torch.Tensor:
    """This rank's block (a contiguous copy on ``mesh.device``) of the global
    ``h``, which every rank holds (the reference's ``device_put`` of a
    global array)."""
    from repro_torch.sharding import Sharding

    return Sharding(mesh, spec).local(h).to(mesh.device).contiguous()


def gather_matrix(local: torch.Tensor, mesh: "Mesh", spec: "PartitionSpec") -> torch.Tensor:
    """The global matrix on every rank from each rank's ``local`` block
    (laid out by ``spec``): one broadcast a block from its owner."""
    from repro_torch.sharding import Sharding

    sh = Sharding(mesh, spec)
    shape = tuple(s * mesh.axis_size(e) if e is not None else s
                  for s, e in zip(local.shape, tuple(spec) + (None,) * local.ndim))
    out = torch.empty(shape, dtype=local.dtype, device=local.device)
    for coords in np.ndindex(mesh.devices.shape):
        buf = local.contiguous() if coords == mesh.coords else torch.empty_like(local)
        mesh.broadcast(buf, mesh.axis_names, mesh.axis_index(mesh.axis_names, coords))
        out[sh.local_slices(shape, coords)] = buf
    return out


def rkleene_distributed(
    h: torch.Tensor,
    *,
    mesh: "Mesh",
    row_axes: Tuple[str, ...] = ("data",),
    col_axes: Tuple[str, ...] = ("model",),
    leaf: int = 4096,
    block_size: int = 512,
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """R-Kleene over the 2D block grid: recursion over global sharded
    matrices, SUMMA products, leaves closed with the distributed blocked FW.

    The paper's §5 asks to "divide the 3D-Tensor L" — this divides the
    *problem* instead (quadrant recursion), with every product streamed
    through SUMMA panels, so nothing N^3-sized ever exists.
    """
    nr, nc = mesh.axis_size(row_axes), mesh.axis_size(col_axes)
    grid = dict(mesh=mesh, row_axes=row_axes, col_axes=col_axes)

    def mp(x, y, acc=None):
        return summa_minplus(x, y, acc, semiring=semiring, **grid)

    def rk(d):
        m = d.shape[0] * nr
        if m <= leaf:
            # pivot tile must divide the leaf's local block in both dims
            b = min(block_size, m // nr, m // nc)
            return fw_distributed(d, block_size=max(b, 1), semiring=semiring, **grid)
        half = m // 2
        whole = [(d, (0, 0), (m, m))]
        a, bq, cq, dd = (_regrid(whole, off, (half, half), **grid)
                         for off in ((0, 0), (0, half), (half, 0), (half, half)))
        a = rk(a)
        bq = mp(a, bq)
        cq = mp(cq, a)
        dd = mp(cq, bq, acc=dd)         # fused quadrant accumulate
        dd = rk(dd)
        bq = mp(bq, dd)
        cq = mp(dd, cq)
        a = mp(bq, cq, acc=a)
        quads = [(a, (0, 0), (half, half)), (bq, (0, half), (half, half)),
                 (cq, (half, 0), (half, half)), (dd, (half, half), (half, half))]
        return _regrid(quads, (0, 0), (m, m), **grid)

    return rk(h)


def apsp_distributed(
    h: torch.Tensor,
    *,
    mesh: "Mesh",
    method: str = "fw",
    multi_pod: bool = False,
    block_size: int = 512,
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """Place a (padded) cost matrix on the mesh and solve.

    ``h`` is the global matrix, the same on every rank.  Pads N up so every
    block divides evenly (phantom unreachable nodes), runs the requested
    distributed solver on each rank's block, gathers the blocks and slices
    back: every rank returns the global result on ``mesh.device``.
    """
    row_axes = ("pod", "data") if multi_pod else ("data",)
    col_axes = ("model",)
    nr, nc = mesh.axis_size(row_axes), mesh.axis_size(col_axes)
    n = h.shape[0]
    if method in ("fw", "rkleene"):
        # blocked solvers: the pivot tile must divide every block evenly
        mult = block_size * math.lcm(nr, nc)
    else:
        # squaring: blocks + SUMMA panels must divide evenly
        mult = math.lcm(nr, nc)
    semiring = get_semiring(semiring)
    d = pad_to_multiple(h.to(mesh.device), mult, semiring)
    spec = dist_spec(multi_pod)
    dl = shard_matrix(d, mesh, spec)
    grid = dict(mesh=mesh, row_axes=row_axes, col_axes=col_axes, semiring=semiring)
    if method == "squaring":
        out = squaring_distributed(dl, **grid)
    elif method == "fw":
        out = fw_distributed(dl, block_size=block_size, **grid)
    elif method == "rkleene":
        out = rkleene_distributed(dl, block_size=block_size, **grid)
    else:
        raise ValueError(f"unknown distributed method {method!r}")
    return gather_matrix(out, mesh, spec)[:n, :n]
