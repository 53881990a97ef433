"""The shape lattice the grid verifier proves each kernel over.

The counterpart of ``repro.analysis.kernelcheck.lattice``.  The first
sixteen cases carry the JAX package's ``default_cases`` names and shapes
(aligned, padded, batched, accumulate, witness, bottleneck and
reliability; ``fw_block`` single, batch and pred; ``fw_round`` first and
last pivot, batched; ``row_close`` gather with row n-1 and duplicates,
witness, unaligned), drawn from the same distributions with the same
seeds.  The rest are the shapes where the CUDA plans change: closures at
B = 8, 64, 256 (one cluster of 8 CTAs) and 512 (the grid closure);
``row_close`` at r = 16, 64 (k split over CTAs) and 129 (a last row tile
that is mostly padding) in its three modes; ``minplus`` with N not a
multiple of 4 (the ring's ``ny``, read from a copy and from the storage
itself), the short-row ``spd_features`` shape, and ``minplus_pred`` at
the pred round's stages 2 and 3.

``case_for_fw_round_params`` builds a case from an autotune candidate, so
the tests can prove every block size the port's tuner may propose
(``autotune._FW_ROUND_BLOCKS``) safe.  ``case_for_row_close_params`` keeps
the JAX package's signature; the port's ``row_close`` has no tuned knob,
so ``params`` only names the case.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.semiring import BOTTLENECK, RELIABILITY, TROPICAL, Semiring

__all__ = [
    "Case",
    "GROUPS",
    "default_cases",
    "case_for_fw_round_params",
    "case_for_row_close_params",
    "autotune_cases",
]

# The kernel table's six rows, by the wrapper names that report to them.
GROUPS = {
    "fw_round": "fw_round",
    "minplus": "minplus",
    "minplus_argmin": "minplus_argmin",
    "minplus_pred": "minplus_argmin",
    "fw_block": "fw_block",
    "fw_block_pred": "fw_block_pred",
    "row_close": "row_close",
    "row_close_argmin": "row_close",
    "row_close_pred": "row_close",
}


@dataclass
class Case:
    """One wrapper call to verify.

    ``kernel`` names the wrapper (a key of :data:`GROUPS`), ``module`` its
    kernel module; ``inputs()`` builds the CPU operands (a dict of the
    wrapper's arguments).  ``padded`` marks a case that exercises padding
    (a mismatch there is reported as ``padding``).  ``plan_edit`` and
    ``options`` exist for the mutants: an edit of the captured plan, and
    keyword options of the interpreter."""

    name: str
    kernel: str
    module: str
    inputs: Callable[[], dict]
    padded: bool = False
    shape: tuple = ()
    plan_edit: Optional[Callable] = None
    options: dict = field(default_factory=dict)


def _mat(rng: np.random.Generator, shape, sr: Semiring) -> torch.Tensor:
    """In-domain random matrix for ``sr`` (~25% "no edge" = semiring zero),
    drawn as the JAX package's lattice draws it."""
    no_edge = rng.uniform(size=shape) < 0.25
    if sr.name == "reliability":
        a = np.where(no_edge, 0.0, rng.uniform(0.05, 0.95, size=shape))
    elif sr.name == "bottleneck":
        a = np.where(no_edge, -np.inf, rng.uniform(1.0, 100.0, size=shape))
    elif sr.name == "boolean":
        a = np.where(no_edge, 0.0, 1.0)
    else:
        a = np.where(no_edge, np.inf, rng.uniform(1.0, 100.0, size=shape))
    return torch.from_numpy(a.astype(np.float32))


def _dist(rng: np.random.Generator, shape, sr: Semiring) -> torch.Tensor:
    """``_mat`` with the semiring's one on the diagonal."""
    d = _mat(rng, shape, sr)
    idx = torch.arange(shape[-1])
    d[..., idx, idx] = sr.one
    return d


def _init_pred(d: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """pred[i, j] = i where an edge exists, else -1 (the textbook init)."""
    b = d.shape[-1]
    src = torch.arange(b, dtype=torch.int32)[:, None].expand(d.shape)
    return torch.where(sr.is_zero(d), torch.full_like(src, -1), src).contiguous()


# ---------------------------------------------------------------------------
# minplus family
# ---------------------------------------------------------------------------

def _minplus_case(name: str, m: int, k: int, n: int, *, g: int = 0, accumulate: bool = False,
                  argmin: bool = False, sr: Semiring = TROPICAL, seed: int = 0,
                  padded: bool = False) -> Case:
    def inputs():
        rng = np.random.default_rng(seed)
        xs = (g, m, k) if g else (m, k)
        ys = (g, k, n) if g else (k, n)
        zs = (g, m, n) if g else (m, n)
        x, y = _mat(rng, xs, sr), _mat(rng, ys, sr)
        a = _mat(rng, zs, sr) if accumulate else None
        return dict(x=x, y=y, a=a, semiring=sr)

    return Case(name=name, kernel="minplus_argmin" if argmin else "minplus", module="minplus",
                inputs=inputs, padded=padded, shape=(g, m, k, n))


def _strided_y_case(name: str, m: int, k: int, n: int, *, seed: int) -> Case:
    """y a column slice of rows whose pitch (n rounded up to 4) the ring
    reads up to as they lie: ``ny`` > N from the storage itself."""
    def inputs():
        rng = np.random.default_rng(seed)
        x = _mat(rng, (m, k), TROPICAL)
        store = _mat(rng, (k, -(-n // 4) * 4), TROPICAL)
        return dict(x=x, y=store[:, :n], a=None, semiring=TROPICAL)

    return Case(name=name, kernel="minplus", module="minplus", inputs=inputs, padded=True,
                shape=(0, m, k, n))


def _spd_case(name: str, lms: int, n: int, *, seed: int) -> Case:
    """One ``spd_features`` hop: the landmark rows (L, N) relaxed through
    the ring's copy of h (``ring_rows``), accumulating into themselves."""
    def inputs():
        from repro_torch.kernels.minplus import ring_rows

        rng = np.random.default_rng(seed)
        h = _dist(rng, (n, n), TROPICAL)
        lm = torch.from_numpy(rng.choice(n, size=lms, replace=False))
        d = h[lm].contiguous()
        return dict(x=d, y=ring_rows(h), a=d, semiring=TROPICAL)

    return Case(name=name, kernel="minplus", module="minplus", inputs=inputs, padded=True,
                shape=(0, lms, n, n))


def _pred_case(name: str, n: int, b: int, *, stage: int, seed: int) -> Case:
    """``minplus_pred`` as the pred round launches it, on strided panels of
    the state: stage 3 (N, B) x (B, N) accumulate into D, stage 2 (N, B) x
    (B, B) accumulate into the column panel."""
    def inputs():
        rng = np.random.default_rng(seed)
        d = _dist(rng, (n, n), TROPICAL)
        p = _init_pred(d, TROPICAL)
        o = b
        piv, ppiv = d[o:o + b, o:o + b].contiguous(), p[o:o + b, o:o + b].contiguous()
        if stage == 3:
            return dict(x=d[:, o:o + b], y=d[o:o + b, :], px=p[:, o:o + b], py=p[o:o + b, :],
                        a=d, pa=p, k_offset=o, j_offset=0, semiring=TROPICAL)
        return dict(x=d[:, o:o + b], y=piv, px=p[:, o:o + b], py=ppiv, a=d[:, o:o + b],
                    pa=p[:, o:o + b], k_offset=o, j_offset=o, semiring=TROPICAL)

    return Case(name=name, kernel="minplus_pred", module="minplus", inputs=inputs, padded=True,
                shape=(0, n, b, n if stage == 3 else b))


# ---------------------------------------------------------------------------
# fw_block family
# ---------------------------------------------------------------------------

def _fw_block_case(name: str, b: int, *, t: int = 0, pred: bool = False, seed: int = 0,
                   sr: Semiring = TROPICAL) -> Case:
    def inputs():
        rng = np.random.default_rng(seed)
        d = _dist(rng, (t, b, b) if t else (b, b), sr)
        if pred:
            return dict(d=d, p=_init_pred(d, sr), semiring=sr)
        return dict(d=d, semiring=sr)

    return Case(name=name, kernel="fw_block_pred" if pred else "fw_block", module="fw_block",
                inputs=inputs, shape=(t, b))


# ---------------------------------------------------------------------------
# fw_round family
# ---------------------------------------------------------------------------

def case_for_fw_round_params(block_size: int, n: int, *, o: Optional[int] = None, g: int = 0,
                             seed: int = 0, sr: Semiring = TROPICAL) -> Case:
    """One ``fwround|…`` block-size candidate (B divides N, as the solver
    pads it to), at the last pivot unless ``o`` is given."""
    assert n % block_size == 0, (n, block_size)
    b = block_size
    oo = (n - b) if o is None else o

    def inputs():
        rng = np.random.default_rng(seed)
        d = _dist(rng, (g, n, n) if g else (n, n), sr)
        return dict(d=d, o=oo, block_size=b, semiring=sr)

    return Case(name=f"fw_round/b{b}@n{n}o{oo}g{g}", kernel="fw_round", module="fw_round",
                inputs=inputs, shape=(g, n, b))


# ---------------------------------------------------------------------------
# row_close family
# ---------------------------------------------------------------------------

def _gather_rows(r: int, n: int) -> torch.Tensor:
    """r row ids spanning [0, n-1], both extremes included, and a duplicate
    where r allows (padded affected-row lists repeat ids)."""
    rows = np.unique(np.linspace(0, n - 1, max(r - 1, 2)).astype(np.int32))
    while len(rows) < r:
        rows = np.append(rows, rows[len(rows) % max(len(rows), 1)])
    return torch.from_numpy(rows[:r].astype(np.int32))


def _row_close_case(name: str, r: int, n: int, *, mode: str = "row_close", seed: int = 0,
                    sr: Semiring = TROPICAL) -> Case:
    def inputs():
        rng = np.random.default_rng(seed)
        d = _dist(rng, (n, n), sr)
        out = dict(d=d, rows=_gather_rows(r, n), semiring=sr)
        if mode == "row_close_pred":
            out["pred"] = _init_pred(d, sr)
        elif mode == "row_close_argmin":
            out["track"] = True
        return out

    return Case(name=name, kernel=mode, module="row_close", inputs=inputs, padded=True,
                shape=(r, n))


def case_for_row_close_params(params: dict, r: int, n: int, *, track: bool = False,
                              seed: int = 0, sr: Semiring = TROPICAL) -> Case:
    """The row pass for r gathered rows of an (n, n) matrix; ``params``
    names it."""
    tag = ",".join(f"{key}={params[key]}" for key in sorted(params))
    return _row_close_case(f"row_close/[{tag}]@r{r}n{n}" + ("+track" if track else ""), r, n,
                           mode="row_close_argmin" if track else "row_close", seed=seed, sr=sr)


# ---------------------------------------------------------------------------
# the default lattice
# ---------------------------------------------------------------------------

def reference_cases() -> List[Case]:
    """The JAX package's ``default_cases``, by name and shape."""
    return [
        _minplus_case("minplus/aligned", 16, 32, 256, seed=1),
        _minplus_case("minplus/padded", 13, 21, 130, seed=2, padded=True),
        _minplus_case("minplus/batched", 16, 32, 256, g=2, seed=3),
        _minplus_case("minplus/accumulate-padded", 13, 21, 130, accumulate=True, seed=4,
                      padded=True),
        _minplus_case("minplus_argmin/aligned", 16, 32, 256, argmin=True, seed=5),
        _minplus_case("minplus_argmin/accumulate-padded", 13, 21, 130, argmin=True,
                      accumulate=True, seed=6, padded=True),
        _minplus_case("minplus/bottleneck-padded", 13, 21, 130, sr=BOTTLENECK, seed=7,
                      padded=True),
        _minplus_case("minplus/reliability-padded", 13, 21, 130, sr=RELIABILITY, seed=8,
                      padded=True),
        _fw_block_case("fw_block/single", 8, seed=9),
        _fw_block_case("fw_block/batch", 8, t=3, seed=10),
        _fw_block_case("fw_block_pred/batch", 8, t=2, pred=True, seed=11),
        case_for_fw_round_params(8, 16, o=0, seed=12),
        case_for_fw_round_params(8, 16, g=2, seed=13),
        case_for_row_close_params(dict(bn=128, bk=8, kc=8), 4, 16, seed=14),
        case_for_row_close_params(dict(bn=128, bk=8, kc=8), 4, 16, track=True, seed=15),
        case_for_row_close_params(dict(bn=128, bk=8, kc=8), 5, 20, seed=16),
    ]


def port_cases() -> List[Case]:
    """The shapes where the CUDA plans change."""
    return [
        _fw_block_case("fw_block/b64", 64, seed=20),
        _fw_block_case("fw_block_pred/b64", 64, pred=True, seed=21),
        _fw_block_case("fw_block/b256", 256, seed=22),
        _fw_block_case("fw_block/b512-grid", 512, seed=23),
        _fw_block_case("fw_block_pred/b512-grid", 512, pred=True, seed=24),
        case_for_fw_round_params(64, 192, o=64, seed=25),
        case_for_fw_round_params(256, 512, seed=26),
        _row_close_case("row_close/r16n512-split", 16, 512, seed=27),
        _row_close_case("row_close_pred/r16n512-split", 16, 512, mode="row_close_pred", seed=28),
        _row_close_case("row_close_argmin/r64n512-split", 64, 512, mode="row_close_argmin",
                        seed=29),
        _row_close_case("row_close/r129n258", 129, 258, seed=30),
        _row_close_case("row_close_pred/r129n258", 129, 258, mode="row_close_pred", seed=31),
        _strided_y_case("minplus/ring-ny-from-storage", 20, 40, 130, seed=32),
        _spd_case("minplus/spd-short-rows", 8, 99, seed=33),
        _pred_case("minplus_pred/stage3", 48, 16, stage=3, seed=34),
        _pred_case("minplus_pred/stage2", 48, 16, stage=2, seed=35),
    ]


def default_cases() -> List[Case]:
    return reference_cases() + port_cases()


def autotune_cases() -> List[Case]:
    """One case for every block size the port's ``fwround`` tuner can
    propose: ``autotune._FW_ROUND_BLOCKS`` and, for graphs whose bucket is
    below 32 nodes, the bucket itself (``tune_fw_round``'s fallback), each
    at N = 2B, last pivot."""
    from repro_torch.kernels import autotune

    blocks = sorted(set(autotune._FW_ROUND_BLOCKS)
                    | {min(autotune.bucket(v), 32) for v in range(1, 32)})
    return [case_for_fw_round_params(b, 2 * b, seed=40 + i) for i, b in enumerate(blocks)]
