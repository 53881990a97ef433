"""NequIP — E(3)-equivariant interatomic potential (l_max = 2), ported from
``repro.models.nequip``.

Features are O(3) irreps carried per node with multiplicity ``d_hidden``:

    l=0  scalars   (N, m)
    l=1  vectors   (N, m, 3)
    l=2  rank-2    (N, m, 3, 3)  symmetric traceless

The tensor products are the reference's closed-form Cartesian contractions
for l <= 2 (the real-basis Clebsch-Gordan paths), one interaction layer
at a time: a radial Bessel basis -> MLP -> per-path weights on each edge,
neighbour irreps (x) the edge direction's irreps, scattered to the centres
with an out-of-place ``index_add`` (the reference's ``segment_sum``), then
a per-l linear self-interaction and a gated nonlinearity.  The energy is a
linear readout of the final scalars, summed over real atoms; the forces
are ``-dE/dpositions``, one ``torch.autograd.grad``.  No Pallas kernel
stands behind any of it (the reference's message passing is XLA), so none
is written here: gathers, scatters and products are PyTorch's.

Parameters are a tree of dicts and lists with the reference's layout
(``{"embed", "layers": [{"radial": {"w1", "b1", "w2"}, "self0", ...}],
"readout"}``); :class:`NequIP` holds them as an ``nn.Module`` whose
``state_dict`` key is the JAX tree path joined with ``.``, and
``NequIP.tree()`` hands out the same tensors for the functional
:func:`nequip_energy`.

:func:`nequip_energy_batch` evaluates a batch of molecules as one disjoint
graph (edge ids offset by ``b * n_atoms``, energies summed per molecule
with ``index_add``), where the reference ``vmap``s :func:`nequip_energy`:
one set of launches a batch, the same energies up to summation order.

Divergences by design: ``init_nequip`` draws from a ``torch.Generator``
(other numbers than ``jax.random`` for the same seed) and returns the
parameter tree only (no sharding specs); parity tests carry the JAX
parameters across (``core.convert.nequip_params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch import nn

from .layers import dense_init, module_tree

__all__ = ["NequIPConfig", "NequIP", "N_PATHS", "init_nequip", "nequip_energy",
           "nequip_energy_batch", "nequip_energy_forces", "bessel_basis", "safe_norm",
           "edge_irreps", "sym_traceless"]


@dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 32          # multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    radial_hidden: int = 64
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32
    batch_axes: Tuple[str, ...] = ("data",)   # the reference's sharding axes; unused here

    def with_batch_axes(self, axes) -> "NequIPConfig":
        return dataclasses.replace(self, batch_axes=tuple(axes))


# number of weighted tensor-product paths per interaction (see _interact)
N_PATHS = 10


# ---------------------------------------------------------------------------
# geometry: radial basis + "spherical harmonics" (cartesian irrep form)
# ---------------------------------------------------------------------------

def bessel_basis(r: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis with smooth cutoff (NequIP eq. 8)."""
    x = torch.clamp(r / cutoff, 1e-6, 1.0)
    k = torch.arange(1, n + 1, dtype=r.dtype, device=r.device) * math.pi
    basis = (math.sqrt(2.0 / cutoff) * torch.sin(k * x[..., None])
             / torch.clamp_min(r[..., None], 1e-6))
    # polynomial envelope (p=6) for smooth decay at the cutoff
    p = 6.0
    env = (
        1.0
        - (p + 1) * (p + 2) / 2 * x ** p
        + p * (p + 2) * x ** (p + 1)
        - p * (p + 1) / 2 * x ** (p + 2)
    )
    return basis * env[..., None]


def safe_norm(vec: torch.Tensor) -> torch.Tensor:
    """Norm with a NaN-free gradient at vec = 0 (padded/self edges):
    ``clamp_min`` passes no gradient below its floor, as JAX's
    ``maximum(d2, 1e-12)`` passes none to d2 there."""
    d2 = torch.sum(vec * vec, dim=-1)
    return torch.sqrt(torch.clamp_min(d2, 1e-12))


def edge_irreps(vec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit-vector irreps of the edge direction: (1, u, uu^T - I/3)."""
    r = safe_norm(vec)[..., None]
    u = vec / r
    outer = u[..., :, None] * u[..., None, :]
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device)
    y2 = outer - eye / 3.0
    y0 = torch.ones(vec.shape[:-1], dtype=vec.dtype, device=vec.device)
    return y0, u, y2


def sym_traceless(t: torch.Tensor) -> torch.Tensor:
    tt = 0.5 * (t + t.transpose(-1, -2))
    tr = tt.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    return tt - tr * torch.eye(3, dtype=t.dtype, device=t.device) / 3.0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(gen, shape, dtype) -> nn.Parameter:
    return nn.Parameter(dense_init(gen, shape, dtype))


class NequIP(nn.Module):
    """The reference's NequIP parameters as a module.  ``generator`` draws
    the weights on the CPU (a seed-0 generator if None), so one seed gives
    one initial state on every device; the module is then moved to
    ``device``.  Draw order: embed, readout, then each layer's radial
    ``w1``, ``w2``, ``self0``-``self2``, ``gate1``, ``gate2``."""

    def __init__(self, cfg: NequIPConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        m, dt = cfg.d_hidden, cfg.param_dtype
        self.embed = _param(gen, (cfg.n_species, m), dt)
        self.readout = _param(gen, (m, 1), dt)
        self.layers = nn.ModuleList()
        for _ in range(cfg.n_layers):
            layer = nn.Module()
            layer.radial = nn.ParameterDict({
                "w1": _param(gen, (cfg.n_rbf, cfg.radial_hidden), dt),
                "b1": nn.Parameter(torch.zeros(cfg.radial_hidden, dtype=dt)),
                "w2": _param(gen, (cfg.radial_hidden, N_PATHS * m), dt),
            })
            for name in ("self0", "self1", "self2", "gate1", "gate2"):
                setattr(layer, name, _param(gen, (m, m), dt))
            self.layers.append(layer)
        self.to(device)

    def tree(self) -> dict:
        """The parameters (these tensors, not copies) in the JAX layout."""
        return module_tree(self)

    def forward(self, batch: dict) -> torch.Tensor:
        return nequip_energy(self.tree(), batch, self.cfg)


def init_nequip(generator: Optional[torch.Generator], cfg: NequIPConfig, *,
                device="cuda") -> dict:
    """The parameter tree of a new :class:`NequIP` on ``device``."""
    return NequIP(cfg, generator, device).tree()


# ---------------------------------------------------------------------------
# interaction
# ---------------------------------------------------------------------------

def _radial(p, rbf):
    h = torch.nn.functional.silu(rbf @ p["w1"] + p["b1"])
    return h @ p["w2"]                                            # (E, P*m)


def _segment_sum(x: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Row e of ``x`` added into row ``dst[e]`` of n zero rows, out of place
    so that autograd sees it."""
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, dst, x)


def _interact(lp, feats, src, dst, rbf, y1, y2, edge_mask, n):
    """One message-passing layer over irrep features."""
    s, v, t = feats["0"], feats["1"], feats["2"]                  # (N,m) (N,m,3) (N,m,3,3)
    m = s.shape[1]
    w = _radial(lp["radial"], rbf).reshape(-1, N_PATHS, m)        # (E, P, m)
    w = torch.where(edge_mask[:, None, None], w, 0.0)
    ss, sv, st = s[src], v[src], t[src]                           # gathered neighbour feats
    u = y1                                                        # (E, 3)
    uu = y2                                                       # (E, 3, 3)

    # --- tensor-product paths (neighbour irrep x edge irrep -> out irrep) ---
    # to l=0
    m0 = (
        w[:, 0] * ss                                              # 0 x Y0 -> 0
        + w[:, 1] * torch.einsum("emi,ei->em", sv, u)             # 1 x Y1 -> 0
        + w[:, 2] * torch.einsum("emij,eij->em", st, uu)          # 2 x Y2 -> 0
    )
    # to l=1
    cross = torch.linalg.cross(sv, u[:, None, :].expand_as(sv), dim=-1)
    m1 = (
        w[:, 3, :, None] * ss[:, :, None] * u[:, None, :]         # 0 x Y1 -> 1
        + w[:, 4, :, None] * sv                                   # 1 x Y0 -> 1
        + w[:, 5, :, None] * cross                                # 1 x Y1 -> 1
        + w[:, 6, :, None] * torch.einsum("emij,ej->emi", st, u)  # 2 x Y1 -> 1
    )
    # to l=2
    outer_vu = sv[:, :, :, None] * u[:, None, None, :]            # (E,m,3,3)
    m2 = (
        w[:, 7, :, None, None] * ss[:, :, None, None] * uu[:, None]      # 0 x Y2 -> 2
        + w[:, 8, :, None, None] * sym_traceless(outer_vu)                # 1 x Y1 -> 2
        + w[:, 9, :, None, None] * st                                     # 2 x Y0 -> 2
    )

    agg0 = _segment_sum(m0, dst, n)
    agg1 = _segment_sum(m1, dst, n)
    agg2 = _segment_sum(m2, dst, n)

    # self-interaction (per-l linear over multiplicity) + residual
    s_new = s + torch.einsum("nm,mk->nk", agg0, lp["self0"])
    v_new = v + torch.einsum("nmi,mk->nki", agg1, lp["self1"])
    t_new = t + torch.einsum("nmij,mk->nkij", agg2, lp["self2"])

    # gated nonlinearity: scalars through silu; l>0 scaled by sigmoid(gate(s))
    g1 = torch.sigmoid(torch.einsum("nm,mk->nk", s_new, lp["gate1"]))
    g2 = torch.sigmoid(torch.einsum("nm,mk->nk", s_new, lp["gate2"]))
    return {
        "0": torch.nn.functional.silu(s_new),
        "1": v_new * g1[:, :, None],
        "2": t_new * g2[:, :, None, None],
    }


def _atom_energies(params, pos, species, edge_index, edge_mask, node_mask,
                   cfg: NequIPConfig) -> torch.Tensor:
    """Per-atom energies (N,), zero on padded atoms."""
    cd = cfg.compute_dtype
    pos = pos.to(cd)
    src, dst = edge_index.long()
    n = pos.shape[0]
    m = cfg.d_hidden

    vec = pos[src] - pos[dst]
    r = safe_norm(vec)
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)                  # (E, n_rbf)
    rbf = torch.where(edge_mask[:, None], rbf, 0.0)
    _, y1, y2 = edge_irreps(vec)

    feats = {
        "0": params["embed"].to(cd)[species.long()],
        "1": pos.new_zeros((n, m, 3)),
        "2": pos.new_zeros((n, m, 3, 3)),
    }
    for lp in params["layers"]:
        feats = _interact(lp, feats, src, dst, rbf, y1, y2, edge_mask, n)

    e_atom = (feats["0"] @ params["readout"].to(cd))[:, 0]
    return torch.where(node_mask, e_atom, 0.0)


def nequip_energy(params, batch: dict, cfg: NequIPConfig) -> torch.Tensor:
    """batch: positions (N,3), species (N,), edge_index (2,E), node_mask,
    edge_mask -> total energy (a 0-d tensor)."""
    return torch.sum(_atom_energies(params, batch["positions"], batch["species"],
                                    batch["edge_index"], batch["edge_mask"],
                                    batch["node_mask"], cfg))


def nequip_energy_batch(params, batch: dict, cfg: NequIPConfig) -> torch.Tensor:
    """Energies (B,) of a batch of molecules of ``n_atoms`` each: positions
    (B,n,3), species (B,n), edge_index (B,2,E), edge_mask (B,E), node_mask
    (B,n), evaluated as one disjoint graph."""
    pos = batch["positions"]
    b, n = pos.shape[:2]
    offset = torch.arange(b, device=pos.device)[:, None, None] * n
    edges = (batch["edge_index"].long() + offset).permute(1, 0, 2).reshape(2, -1)
    e_atom = _atom_energies(params, pos.reshape(b * n, 3), batch["species"].reshape(-1),
                            edges, batch["edge_mask"].reshape(-1),
                            batch["node_mask"].reshape(-1), cfg)
    mol = torch.arange(b, device=pos.device).repeat_interleave(n)
    return e_atom.new_zeros(b).index_add(0, mol, e_atom)


def nequip_energy_forces(params, batch: dict, cfg: NequIPConfig):
    """(energy, forces (N,3)): the forces are ``-dE/dpositions``, one
    ``torch.autograd.grad`` (no graph kept: nothing differentiates them
    again)."""
    pos = batch["positions"].detach().requires_grad_(True)
    e = nequip_energy(params, {**batch, "positions": pos}, cfg)
    (g,) = torch.autograd.grad(e, pos)
    return e.detach(), -g
