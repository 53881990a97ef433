"""Incremental APSP — streaming batched edge updates on a solved state,
ported from ``repro.core.dynamic``.

:class:`DynamicAPSP` holds a solved ``(dist, pred)`` state on its device
plus the current cost matrix ``h`` on the host, and applies batched edge
updates without a full re-solve wherever the algebra allows it:

* **Decrease-only batches** (insert an edge, lower a weight) are exact
  rank-k fused updates, ``dist' = dist ⊕ (dist[:, U] ⊗ W ⊗ dist[V, :])``
  (``kernels.ops.rank_k_update``, on the ``minplus`` / ``minplus_argmin``
  kernels), iterated to fixpoint with early exit; ``ceil_log2(k+1) + 1``
  passes are enough.

* **Increases and deletions** invalidate entries.  The engine marks the
  pairs that may be stale (``_affected_mask``: from ``pred`` when tracked,
  else the conservative witness test), resets them to the direct edge and
  re-closes.  The stale pairs lie in the rows of the affected sources R,
  and every other row is exact, so the default re-close is the
  row-restricted bounded re-solve ``dist[R, :] ⊕= dist[R, :] ⊗ dist``
  (``kernels.ops.row_restricted_close``, the ``row_close`` kernel), to
  early-exit fixpoint at O(|R|·n²) a pass.  Past ``row_threshold · n``
  affected rows it takes the full-matrix warm re-solve (early-exit fused
  squaring on ``minplus`` / ``minplus_argmin``), and past
  ``resolve_threshold`` of affected pairs the full solver.

Each fixpoint is a host loop with one device sync a pass (the "did
anything improve" flag), where the JAX package runs a ``while_loop``.
Every decision — thresholds, paddings, pass bounds, version bumps, the
per-phase rollback — is the JAX engine's, so on the same inputs the two
engines give the same ``dist``, ``pred``, info dicts, ``stats`` and
``version``.

Atomicity: ``update`` mutates ``h`` per phase around the dispatch and
rolls the phase's edges back if the dispatch raises.  The device state is
computed into new tensors and committed only after the dispatch returned,
so a raising dispatch leaves ``dist`` and ``pred`` as they were.
Worsenings commit before decreases.

Exactness per semiring: the incremental paths are exact for
``monotone_mul`` semirings (tropical, reliability) and bit-equal to a full
solve under tropical integer weights.  Plateau semirings (bottleneck,
boolean) take the documented fallback on every update: a full re-solve.

Batch semantics: a batch is a set of "set edge (u, v) to w" requests;
duplicate (u, v) entries resolve last-wins.  Self-loops are rejected.
Setting ``w = semiring.zero`` deletes the edge.

:func:`apply_updates_batched` is the serving pool's cross-graph drain:
same-shape decrease batches of several engines run as one (G, n, n)
rank-k fixpoint, one batched launch a pass.
"""

from __future__ import annotations

import json
import os
import threading
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from .apsp import next_pow2, solve, validate_cost_matrix
from .errors import UpdateError
from .floyd_warshall import init_pred
from .paths import _host, _np_mul, reconstruct_path, reconstruct_path_device
from .semiring import Semiring, SemiringLike, ceil_log2, default_device, get_semiring

__all__ = ["DynamicAPSP", "UpdateJournal", "apply_updates_batched", "domain_violations"]


def domain_violations(x, semiring: SemiringLike) -> np.ndarray:
    """Boolean mask of entries outside the semiring's value domain — the
    shared leak detector for update weights (reject before mutation) and
    solved-state health probes (a poisoned closure must never be served).

    NaN is invalid everywhere.  Per instance: tropical values live in
    [0, +inf], reliability in [0, 1], boolean in {0.0, 1.0}; bottleneck's
    domain is all of [-inf, +inf] so only NaN is invalid.  Custom registered
    semirings get the NaN-only check.  ``x`` is an array or a tensor.
    """
    sr = get_semiring(semiring)
    a = _host(x)
    bad = np.isnan(a)
    if sr.name == "tropical":
        bad = bad | (a < 0)
    elif sr.name == "reliability":
        bad = bad | (a < 0) | (a > 1)
    elif sr.name == "boolean":
        bad = bad | ((a != 0.0) & (a != 1.0))
    return bad


def _bucket_k(k: int) -> int:
    """Padded update-batch width: next power of two, floor 4."""
    return next_pow2(k, 4)


class UpdateJournal:
    """Durable edge-update journal (jsonl, fsync-per-append) — the redo log
    that turns engine recovery into *replay* instead of a cold re-solve.
    The file format is the JAX package's, byte for byte, so a journal
    written by either engine replays onto the other.

    Each record is one committed update phase::

        {"seq": int, "v0": int, "u": [...], "v": [...], "w": [...]}

    where ``v0`` is the engine version *before* the phase applied and
    ``u/v/w`` are the **normalized** endpoint/weight arrays (deduped
    last-wins, int endpoints, f32 weights), so replaying a record through
    :meth:`DynamicAPSP.update` is idempotent and bit-deterministic.  The
    engine appends a record only after the phase's dispatch succeeded.

    Appends flush + fsync under a lock before returning.  A torn trailing
    line (crash mid-append) is ignored at read time — that update was never
    acked.  :meth:`truncate` drops records already captured by a checkpoint
    through a tmp file and ``os.replace``.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = str(path)
        self._fsync = bool(fsync)
        self._lock = threading.Lock()
        self._seq = 0
        for rec in self._read_all():
            self._seq = max(self._seq, int(rec["seq"]) + 1)
        self._fh = open(self.path, "a", encoding="utf-8")

    # -- write side ---------------------------------------------------------

    def append(self, u, v, w, version_before: int) -> int:
        """Durably record one committed update phase; returns its seq."""
        uu = [int(x) for x in np.asarray(u).ravel()]
        vv = [int(x) for x in np.asarray(v).ravel()]
        ww = [float(x) for x in np.asarray(w, dtype=np.float32).ravel()]
        with self._lock:
            seq = self._seq
            self._seq += 1
            rec = {"seq": seq, "v0": int(version_before),
                   "u": uu, "v": vv, "w": ww}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
        return seq

    def truncate(self, min_version: int) -> int:
        """Drop records with ``v0 < min_version``; returns the number
        dropped.  Survivors are rewritten to a tmp file and ``os.replace``d
        in."""
        with self._lock:
            self._fh.flush()
            recs = self._read_all()
            keep = [r for r in recs if int(r["v0"]) >= int(min_version)]
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                for r in keep:
                    fh.write(json.dumps(r) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            return len(recs) - len(keep)

    def clear(self) -> int:
        """Drop every record — a cold build starts a new incarnation."""
        return self.truncate(1 << 62)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()

    # -- read side ----------------------------------------------------------

    def _read_all(self) -> List[Dict]:
        if not os.path.exists(self.path):
            return []
        out: List[Dict] = []
        with open(self.path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:  # a torn tail from a crash mid-append was never acked
                    break
        return out

    def records(self, min_version: int = 0) -> List[Dict]:
        """All durable records with ``v0 >= min_version``, in append order."""
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
        return [r for r in self._read_all() if int(r["v0"]) >= int(min_version)]

    def __len__(self) -> int:
        return len(self.records())

    def replay_onto(self, engine: "DynamicAPSP", min_version: int = 0) -> int:
        """Re-apply every record with ``v0 >= min_version`` to ``engine``
        in order; returns the count replayed.  The engine's own journal is
        detached for the duration so replay does not re-append."""
        recs = self.records(min_version)
        saved, engine.journal = engine.journal, None
        try:
            for rec in recs:
                engine.update(
                    np.asarray(rec["u"], np.int32),
                    np.asarray(rec["v"], np.int32),
                    np.asarray(rec["w"], np.float32),
                )
        finally:
            engine.journal = saved
        return len(recs)


def _moved(sr: Semiring, z: torch.Tensor, d: torch.Tensor) -> bool:
    """Did any entry strictly improve?  The one device sync of a pass."""
    return bool(sr.better(z, d).any())


def _rank_k_fixpoint(dist, pred, u, v, w, *, semiring, with_pred, max_passes):
    """Iterate the fused rank-k relaxation to fixpoint (early exit)."""
    from repro_torch.kernels import ops as kops

    sr = semiring
    d, p, moved, passes = dist, pred, True, 0
    while moved and passes < max_passes:
        z, pz = kops.rank_k_update(d, u, v, w, pred=p if with_pred else None, semiring=sr)
        moved = _moved(sr, z, d)
        d, p, passes = z, (pz if with_pred else p), passes + 1
    return d, p, passes


def _rank_k_fixpoint_batch(dist, pred, u, v, w, *, semiring, with_pred, max_passes):
    """The rank-k fixpoint over a (G, n, n) stack with (G, k) edges — the
    pool's batched drain.  All graphs share the loop, which runs until every
    graph is at its fixpoint (converged graphs ride the extra passes as
    exact no-ops); ``ever`` says per graph whether its state moved, for
    the versions.  One device sync a pass, on the per-graph flags."""
    from repro_torch.kernels import ops as kops

    sr = semiring
    g = dist.shape[0]
    d, p, passes = dist, pred, 0
    moved = torch.ones(g, dtype=torch.bool)
    ever = torch.zeros(g, dtype=torch.bool)
    while bool(moved.any()) and passes < max_passes:
        z, pz = kops.rank_k_update(d, u, v, w, pred=p if with_pred else None, semiring=sr)
        moved = sr.better(z, d).flatten(1).any(dim=1).cpu()
        ever |= moved
        d, p, passes = z, (pz if with_pred else p), passes + 1
    return d, p, ever, passes


def _affected_mask(dist, pred, u, v, w_old, *, semiring, use_pred):
    """Pairs whose stored distance may be stale after worsening the edges
    ``(u_i, v_i)`` (weights ``w_old`` *before* the update), one edge at a
    time (an (n, n) candidate each).

    With ``use_pred``: pairs whose recorded tree's last hop into v_i is u_i
    (``pred[i, v] == u``) and v witnesses (i, j).  Without: the witness test
    ``dist[i, u] ⊗ w_old ⊗ dist[v, j]`` achieving ``dist[i, j]``.  The
    compare is widened by ``torch.isclose`` at rtol = eps(dtype) · 8 · n,
    as the JAX mask widens ``jnp.isclose``: a wider mask is always sound.
    A bf16 state's candidates are formed in f32 and not rounded, as in the
    jitted JAX mask (``w_old`` is f32, and XLA drops bf16 round trips).
    """
    sr = semiring
    n = dist.shape[-1]
    rtol = float(torch.finfo(dist.dtype).eps) * 8.0 * n
    ct = torch.promote_types(dist.dtype, torch.float32)
    d = dist.to(ct)
    mask = torch.zeros(dist.shape, dtype=torch.bool, device=dist.device)
    for i in range(u.shape[0]):
        ui, vi = int(u[i]), int(v[i])
        if use_pred:
            cand = sr.mul(d[:, vi][:, None], d[vi, :][None, :])
        else:
            cand = sr.mul(sr.mul(d[:, ui], w_old[i])[:, None], d[vi, :][None, :])
        wit = ~sr.better(d, cand) | torch.isclose(d, cand, rtol=rtol)
        if use_pred:
            wit &= (pred[:, vi] == ui)[:, None]
        mask |= wit
    return mask


def _reset(dist, pred, h, affected, *, semiring, with_pred):
    """The bounded re-solves' start: affected entries back to the direct
    edge, and the updated cost matrix folded in; new tensors."""
    sr = semiring
    d = torch.where(affected, h, dist)
    better = sr.better(h, d)
    d = torch.where(better, h, d)
    p = torch.where(affected | better, init_pred(h, sr), pred) if with_pred else None
    return d, p


def _warm_resolve(dist, pred, h, affected, *, semiring, with_pred, max_iters):
    """Bounded re-solve: the reset, then early-exit fused squaring.  The
    warm matrix lies entrywise between ``h`` and its closure, so the
    squaring fixpoint is the closure of the updated graph."""
    from repro_torch.kernels import ops as kops

    sr = semiring
    d, p = _reset(dist, pred, h, affected, semiring=sr, with_pred=with_pred)
    moved, iters = True, 0
    while moved and iters < max_iters:
        if with_pred:
            z, pz = kops.minplus_pred(d, d, p, p, a=d, pa=p, semiring=sr)
        else:
            z, pz = kops.minplus(d, d, d, semiring=sr), p
        moved = _moved(sr, z, d)
        d, p, iters = z, pz, iters + 1
    return d, p, iters


def _row_close(dist, pred, h, affected, rows, *, semiring, with_pred, max_iters):
    """Row-restricted bounded re-solve: the reset, then the panel pass
    ``d[R, :] ⊕= d[R, :] ⊗ d`` to early-exit fixpoint, O(|R|·n²) a pass.

    After the reset every non-R row holds its exact closure value and the R
    rows lie between the direct edge and the closure; the covered length of
    an optimal path's affected prefix doubles each pass.
    """
    from repro_torch.kernels import ops as kops

    sr = semiring
    d, p = _reset(dist, pred, h, affected, semiring=sr, with_pred=with_pred)
    moved, iters = True, 0
    while moved and iters < max_iters:
        z, pz = kops.row_restricted_close(d, rows, pred=p, semiring=sr)
        moved = _moved(sr, z, d)
        d, p, iters = z, pz, iters + 1
    return d, p, iters


class DynamicAPSP:
    """Incremental all-pairs engine over one persistent graph.

    Solves once at construction (:func:`repro_torch.core.solve`), then
    :meth:`update` applies batched edge updates along the cheapest exact
    path (see the module docstring).  ``dist`` / ``pred`` always reflect the
    current cost matrix ``h``.

    Parameters mirror ``solve``: ``method`` / ``with_pred`` / ``semiring``
    plus solver kwargs (``block_size``, ``dtype`` ...); ``resolve_threshold``
    is the affected-pair fraction above which a worsening batch goes to the
    full solver, and ``row_threshold`` the affected-*row* fraction |R|/n
    above which the row-restricted re-close yields to the warm re-solve.
    ``device`` is where the state lives, ``"cuda"`` when not given (a host
    without CUDA then raises); ``h`` stays a host numpy array.

    ``donate`` differs from the JAX engine, where handles obtained before
    an update are deleted by it and raise when read.  Here ``donate=True``
    (default) commits each incremental update into the engine's own
    ``dist`` / ``pred`` tensors in place, so a handle taken before the
    update shows the new values; ``donate=False`` rebinds the engine to new
    tensors and leaves every tensor handed out before an update unchanged.
    A full re-solve always rebinds.
    """

    def __init__(
        self,
        h,
        *,
        method: str = "blocked_fw",
        with_pred: bool = False,
        semiring: SemiringLike = "tropical",
        resolve_threshold: float = 0.25,
        row_threshold: float = 0.5,
        donate: bool = True,
        validate: bool = True,
        journal: Optional[UpdateJournal] = None,
        state: Optional[Dict] = None,
        device=None,
        **solve_kw,
    ):
        self._sr = get_semiring(semiring)
        self._device = torch.device(default_device(device))
        self._donate = bool(donate)
        self._method = method
        self._with_pred = bool(with_pred)
        self._solve_kw = dict(solve_kw)
        self._threshold = float(resolve_threshold)
        self._row_threshold = float(row_threshold)
        self._validate = bool(validate)
        self._h = np.array(_host(h), dtype=np.float32)
        if self._h.ndim != 2 or self._h.shape[0] != self._h.shape[1]:
            raise ValueError(f"h must be square, got {self._h.shape}")
        if self._validate:
            validate_cost_matrix(torch.from_numpy(self._h), self._sr)
        self.stats: Dict[str, int] = {
            "rank_k": 0, "row_resolve": 0, "warm_resolve": 0,
            "full_resolve": 0, "noop": 0,
            "rank_k_passes": 0, "row_iters": 0, "warm_iters": 0,
        }
        self._dist: Optional[torch.Tensor] = None
        self._pred: Optional[torch.Tensor] = None
        self._version = 0
        self.journal = journal
        if state is not None:
            self._install_state(state)
        else:
            self.solve_full()

    # -- state accessors ---------------------------------------------------

    @property
    def n(self) -> int:
        return self._h.shape[0]

    @property
    def h(self) -> np.ndarray:
        """Current cost matrix (a copy — the engine owns its state)."""
        return self._h.copy()

    @property
    def dist(self) -> torch.Tensor:
        return self._dist

    @property
    def pred(self) -> Optional[torch.Tensor]:
        return self._pred

    @property
    def semiring(self) -> Semiring:
        return self._sr

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def version(self) -> int:
        """Monotone state-version counter: bumps on every state-changing
        update and every full re-solve."""
        return self._version

    def solve_full(self) -> None:
        """Full re-solve from the current cost matrix (the last resort)."""
        r = solve(
            self._h, method=self._method, with_pred=self._with_pred,
            semiring=self._sr, validate=self._validate, device=self._device,
            **self._solve_kw,
        )
        self._dist, self._pred = r.dist, r.pred
        self._version += 1

    def _install_state(self, state: Dict) -> None:
        """Restore path: install a previously solved ``{"dist", "pred",
        "version"}`` state (a :meth:`snapshot`, tensors or host arrays)
        instead of cold-solving.  The caller owns ``dist == closure(h)``."""
        from .convert import to_torch

        def tensor(x):
            return x.to(self._device) if isinstance(x, torch.Tensor) else to_torch(x, self._device)

        dist = tensor(state["dist"])
        if tuple(dist.shape) != self._h.shape:
            raise ValueError(
                f"state dist shape {tuple(dist.shape)} != h shape {self._h.shape}"
            )
        self._dist = dist
        pred = state.get("pred")
        if self._with_pred:
            if pred is None:
                raise ValueError(
                    "state carries no pred but engine was built with_pred=True"
                )
            self._pred = tensor(pred)
        self._version = int(state["version"])

    def _commit(self, dist: torch.Tensor, pred: Optional[torch.Tensor]) -> None:
        """Install an incremental update's result: in place with
        ``donate``, else by rebinding (see the class docstring)."""
        if self._donate:
            self._dist.copy_(dist)
            if pred is not None:
                self._pred.copy_(pred)
        else:
            self._dist, self._pred = dist, pred

    def _journal_append(self, u, v, w, version_before: int) -> None:
        """Durably record a committed update phase (no-op without a journal)."""
        if self.journal is not None and np.asarray(u).size:
            self.journal.append(u, v, w, version_before)

    # -- serving-tier hooks (snapshot + health) ----------------------------

    def snapshot(self) -> Dict:
        """Host copy of the solved state: ``{"dist", "pred", "h",
        "version"}``, dist and pred as CPU tensors (numpy has no bf16), h as
        a numpy array.  Later updates, in place or not, never touch it."""
        return {
            "dist": self._dist.to("cpu", copy=True),
            "pred": None if self._pred is None else self._pred.to("cpu", copy=True),
            "h": self._h.copy(),
            "version": self._version,
        }

    def health_probe(self, n_samples: int = 64, rng=None) -> Dict:
        """Cheap invariant probe over the live state; returns ``{"ok",
        "domain_violations", "triangle_violations", "edge_violations"}``:
        (1) any entry of ``dist`` outside the semiring's domain; (2) ``h``
        strictly better than ``dist`` anywhere (a missed update); (3)
        ``n_samples`` sampled (i, k, j) triples violating the triangle
        fixpoint, at a tolerance scaled to the storage dtype.  Host-side on
        a synced copy, as in the JAX engine."""
        sr, mul = _np_mul(self._sr)
        d = _host(self._dist).astype(np.float32)
        out: Dict = {
            "ok": True,
            "domain_violations": int(domain_violations(d, sr).sum()),
            "edge_violations": 0,
            "triangle_violations": 0,
        }
        if out["domain_violations"]:
            out["ok"] = False
            return out                   # arithmetic below would hit the NaNs
        tol = max(1e-5, 4.0 * float(torch.finfo(self._dist.dtype).eps))
        close = partial(np.isclose, rtol=tol, atol=tol)
        edge = np.asarray(sr.better(self._h, d)) & ~close(self._h, d)
        out["edge_violations"] = int(edge.sum())
        rng = np.random.default_rng(0) if rng is None else rng
        i, k, j = rng.integers(0, self.n, (3, max(int(n_samples), 1)))
        cand = np.asarray(mul(d[i, k], d[k, j]))
        tri = np.asarray(sr.better(cand, d[i, j])) & ~close(cand, d[i, j])
        out["triangle_violations"] = int(tri.sum())
        out["ok"] = not (out["edge_violations"] or out["triangle_violations"])
        return out

    # -- updates -----------------------------------------------------------

    @staticmethod
    def _endpoints(x) -> np.ndarray:
        """Node-id vector -> int32, rejecting non-integral or non-finite
        ids rather than truncating them."""
        a = np.asarray(x).ravel()
        if a.dtype.kind == "f" and a.size:
            ok = np.isfinite(a) & (a == np.round(a))
            if not ok.all():
                i = int(np.argmax(~ok))
                raise UpdateError(
                    f"edge endpoints must be integral node ids, got "
                    f"{a[i]!r}; engine state is unchanged"
                )
        return a.astype(np.int32)

    def _normalize(self, u, v, w):
        """Validate + dedup (last wins) one update batch -> int/float arrays."""
        if v is None:
            edges = np.asarray(list(u), dtype=np.float64)
            if edges.size == 0:
                edges = edges.reshape(0, 3)          # empty batch is a noop
            if edges.ndim != 2 or edges.shape[1] != 3:
                raise ValueError("edges must be a sequence of (u, v, w) triples")
            u, v, w = edges[:, 0], edges[:, 1], edges[:, 2]
        u = self._endpoints(u)
        v = self._endpoints(v)
        w = np.asarray(w, np.float32).ravel()
        if not (u.shape == v.shape == w.shape):
            raise UpdateError("u, v, w must have matching lengths")
        n = self.n
        if u.size and (u.min() < 0 or u.max() >= n or v.min() < 0 or v.max() >= n):
            raise UpdateError(f"edge endpoints out of range for n={n}")
        if np.any(u == v):
            raise UpdateError(
                "self-loop updates are not allowed: the diagonal is the "
                "semiring one by convention"
            )
        if self._validate:
            bad = domain_violations(w, self._sr)
            # the semiring zero (= delete edge) is always a legal weight
            bad &= w != np.float32(self._sr.zero)
            if bad.any():
                i = int(np.argmax(bad))
                raise UpdateError(
                    f"update batch rejected: {int(bad.sum())} weight(s) "
                    f"outside the {self._sr.name!r} domain (first: edge "
                    f"({int(u[i])}, {int(v[i])}) -> {w[i]!r}); engine state "
                    "is unchanged.  Pass validate=False to skip this check."
                )
        if u.size > 1:
            flat = u.astype(np.int64) * n + v
            # last occurrence of each (u, v) wins — streaming set semantics
            _, first_rev = np.unique(flat[::-1], return_index=True)
            keep = np.sort(flat.size - 1 - first_rev)
            u, v, w = u[keep], v[keep], w[keep]
        return u, v, w

    def update(self, u, v=None, w=None) -> Dict:
        """Apply one batch of edge updates; returns an info dict.

        Call as ``update([(u, v, w), ...])`` or ``update(u_arr, v_arr,
        w_arr)``.  Each entry sets edge (u, v) to weight w (``semiring.zero``
        deletes).  Returns ``{"path": "rank_k" | "row_resolve" |
        "warm_resolve" | "full_resolve" | "noop", "n_updates": ..., ...}``;
        a batch mixing worsenings and decreases reports
        ``"<worsening path>+rank_k"``.

        Atomic under retry: ``h`` is mutated phase by phase and each phase's
        edges are rolled back if its dispatch raises, and the device state
        changes only once a dispatch has returned, so on any exception
        ``dist == closure(h)``.  Worsenings commit before decreases.
        """
        sr = self._sr
        u, v, w = self._normalize(u, v, w)
        if u.size == 0:
            self.stats["noop"] += 1
            return {"path": "noop", "n_updates": 0}
        v0 = self._version            # journal records carry the pre-update version
        old = self._h[u, v]
        worse = np.asarray(sr.better(old, w))      # strictly worsened edges
        changed = np.asarray(sr.better(w, old))    # strictly improved edges
        info: Dict = {"path": "noop", "n_updates": int(u.size)}

        # order-incomparable weights (NaN under validate=False) are inert for
        # the closure but recorded in the cost matrix: a dispatch-free write
        inert = ~worse & ~changed & ~((w == old) | (np.isnan(w) & np.isnan(old)))
        if inert.any():
            self._h[u[inert], v[inert]] = w[inert]
            self._journal_append(u[inert], v[inert], w[inert], v0)

        if not sr.monotone_mul:
            # plateau semirings: tied witnesses can cycle, so the fused
            # incremental paths are not trusted — documented fallback only.
            if worse.any() or changed.any():
                self._h[u, v] = w
                try:
                    self.solve_full()
                except BaseException:
                    self._h[u, v] = old
                    raise
                self._journal_append(u, v, w, v0)
                self.stats["full_resolve"] += 1
                info["path"] = "full_resolve"
                info["reason"] = "plateau semiring (monotone_mul=False)"
            else:
                self.stats["noop"] += 1
            return info

        if worse.any():
            self._h[u[worse], v[worse]] = w[worse]
            try:
                self._apply_worsening(u[worse], v[worse], old[worse], info)
            except BaseException:
                self._h[u[worse], v[worse]] = old[worse]
                raise
            # per-phase journaling: a committed phase is durable even if a
            # later phase of the same batch raises (its h writes persist)
            self._journal_append(u[worse], v[worse], w[worse], v0)
        if changed.any():
            self._h[u[changed], v[changed]] = w[changed]
            try:
                sub: Dict = {}
                self._apply_decreases(u[changed], v[changed], w[changed], sub)
            except BaseException:
                self._h[u[changed], v[changed]] = old[changed]
                raise
            self._journal_append(u[changed], v[changed], w[changed], v0)
            if info["path"] == "noop":
                info.update(sub)
            else:
                # mixed batch: worsenings committed first, then the rank-k
                info["path"] = f"{info['path']}+rank_k"
                info["passes"] = sub["passes"]
                info["k_padded"] = sub["k_padded"]
        if not (worse.any() or changed.any()):
            self.stats["noop"] += 1
        return info

    def _apply_decreases(self, u, v, w, info) -> Dict:
        """Exact rank-k fused update for a decrease-only batch."""
        sr = self._sr
        k = _bucket_k(u.size)
        pad = k - u.size
        dev = self._device
        # inert pad edges: weight = semiring zero annihilates the candidate
        u = torch.from_numpy(np.concatenate([u, np.zeros(pad, np.int32)])).to(dev)
        v = torch.from_numpy(np.concatenate([v, np.zeros(pad, np.int32)])).to(dev)
        # in the engine's dtype: a bf16 state keeps bf16 across the passes
        w = torch.from_numpy(
            np.concatenate([w, np.full(pad, sr.zero, np.float32)])
        ).to(dev, self._dist.dtype)
        max_passes = ceil_log2(min(k, self.n - 1) + 1) + 1
        dist, pred, passes = _rank_k_fixpoint(
            self._dist, self._pred, u, v, w,
            semiring=sr, with_pred=self._with_pred, max_passes=max_passes,
        )
        self._commit(dist, pred)
        self.stats["rank_k"] += 1
        self.stats["rank_k_passes"] += passes
        # the loop exits after one extra confirming pass, so passes == 1
        # means the very first pass already changed nothing: no version bump
        if passes > 1:
            self._version += 1
        info.update(path="rank_k", k_padded=k, passes=passes)
        return info

    def _apply_worsening(self, uw, vw, oldw, info) -> Dict:
        """Worsened-edge batch (``h`` already carries the new weights):
        affected-pair detection, then the cheapest sound re-close —
        row-restricted panel fixpoint by default, full-matrix warm resolve
        past ``row_threshold``, full solver past ``resolve_threshold``."""
        sr = self._sr
        k = _bucket_k(uw.size)
        pad = k - uw.size
        if self._with_pred:
            # pad with an endpoint no pred entry can name (-2): marks nothing
            uw = np.concatenate([uw, np.full(pad, -2, np.int32)])
        else:
            # pad weight = zero annihilates; marks only already-zero pairs,
            # whose reset is a no-op
            uw = np.concatenate([uw, np.zeros(pad, np.int32)])
        vw = np.concatenate([vw, np.zeros(pad, np.int32)])
        oldw = np.concatenate([oldw, np.full(pad, sr.zero, np.float32)])
        affected = _affected_mask(
            self._dist, self._pred, uw, vw,
            torch.from_numpy(oldw).to(self._device), semiring=sr,
            use_pred=self._with_pred,
        )
        # the float32 mean of the mask as the JAX engine's jnp.mean gives it:
        # XLA divides by the constant n * n as a product with its float32
        # reciprocal, which can differ from the quotient in the last bit
        frac = float(np.float32(int(affected.sum()))
                     * (np.float32(1.0) / np.float32(affected.numel())))
        info["affected_frac"] = frac
        if frac > self._threshold:
            self.solve_full()
            self.stats["full_resolve"] += 1
            info["path"] = "full_resolve"
            info["reason"] = f"affected fraction {frac:.2f} > threshold"
            return info
        rows = torch.nonzero(affected.any(dim=1)).flatten().to(torch.int32)
        r = int(rows.numel())
        info["affected_rows"] = r
        if r == 0:
            # no recorded path used a worsened edge: dist is already the
            # closure of the updated graph — nothing to dispatch, no bump
            self.stats["row_resolve"] += 1
            info.update(path="row_resolve", iters=0)
            return info
        h = torch.from_numpy(self._h).to(self._device, self._dist.dtype)
        if r <= self._row_threshold * self.n:
            # the JAX engine pads the row list to a pow2 bucket with copies
            # of a real row (inert: duplicates compute identical panel
            # rows); the pass folds the r distinct rows once each, and the
            # bucket sets the iteration cap and the stats as it does there
            r_pad = next_pow2(r, 4)
            dist, pred, iters = _row_close(
                self._dist, self._pred, h, affected, rows,
                semiring=sr, with_pred=self._with_pred,
                max_iters=ceil_log2(min(r_pad, self.n - 1) + 1) + 1,
            )
            self._commit(dist, pred)
            self.stats["row_resolve"] += 1
            self.stats["row_iters"] += iters
            self._version += 1
            info.update(path="row_resolve", iters=iters, rows_padded=r_pad)
            return info
        dist, pred, iters = _warm_resolve(
            self._dist, self._pred, h, affected,
            semiring=sr, with_pred=self._with_pred,
            max_iters=ceil_log2(self.n) + 1,
        )
        self._commit(dist, pred)
        self.stats["warm_resolve"] += 1
        self.stats["warm_iters"] += iters
        self._version += 1
        info.update(path="warm_resolve", iters=iters)
        return info

    # -- batched application (serving-tier drains) -------------------------

    @staticmethod
    def _classify_batch(eng: "DynamicAPSP", batch):
        """Normalize one (u, v, w) batch and decide batched-dispatch
        eligibility.  Returns ``("noop", info)``, ``("defer", None)``
        (worsenings / plateau semirings / validation failures — anything
        the shared rank-k pass cannot express), or ``("rank_k", (u, v, w,
        n_updates))`` with the decrease subset."""
        sr = eng._sr
        try:
            u, v, w = eng._normalize(*batch)
        except UpdateError:
            return "defer", None
        if u.size == 0:
            return "noop", {"path": "noop", "n_updates": 0}
        old = eng._h[u, v]
        worse = np.asarray(sr.better(old, w))
        changed = np.asarray(sr.better(w, old))
        if not sr.monotone_mul or worse.any():
            return "defer", None
        if not changed.any():
            return "noop", {"path": "noop", "n_updates": int(u.size)}
        return "rank_k", (u[changed], v[changed], w[changed], int(u.size))

    # -- queries -----------------------------------------------------------

    def path(self, i: int, j: int, *, max_len: Optional[int] = None) -> Optional[List[int]]:
        """Node list of the recorded optimal i->j path, or None if
        unreachable.  Walks ``pred`` on its device with
        ``reconstruct_path_device``; a truncated walk (length 0 with a
        reachable pair) falls back to the host pred walk.

        Monotone semirings only: plateau instances can hold legitimate
        witness cycles in ``pred``, so a walk could misreport a reachable
        pair as unreachable."""
        if self._pred is None:
            raise ValueError("engine was built with with_pred=False")
        if not self._sr.monotone_mul:
            raise ValueError(
                f"full path reconstruction is not guaranteed for plateau "
                f"semiring {self._sr.name!r} (monotone_mul=False): pred "
                "chains may cycle through tied witnesses"
            )
        if i == j:
            return [i]
        if bool(self._sr.is_zero(self._dist[i, j])):
            return None
        ml = self.n if max_len is None else int(max_len)
        p, length = reconstruct_path_device(self._pred, i, j, max_len=ml)
        if int(length) == 0:
            # reachable but truncated -> host pred-walk fallback
            return reconstruct_path(self._pred, i, j)
        return p[: int(length)].tolist()


def apply_updates_batched(engines, batches):
    """Apply one update batch per engine, coalescing same-shape decrease
    batches into one (G, n, n) rank-k fixpoint — the serving pool's
    cross-graph drain (one batched launch a pass instead of a per-slot
    loop).

    ``engines`` / ``batches`` are parallel lists; each batch is an
    ``(u, v, w)`` triple in :meth:`DynamicAPSP.update`'s array form.
    Engines are grouped by (semiring, with_pred, n, dtype, device,
    padded-k bucket); each group runs :func:`_rank_k_fixpoint_batch` and
    commits per-engine state with single-engine semantics: ``h`` mutates
    only after the dispatch returned, versions bump only for graphs whose
    state moved, stats mirror :meth:`DynamicAPSP.update`.

    Returns ``(infos, deferred)``: ``infos[i]`` is engine i's info dict
    (``None`` where deferred, ``"batched": G`` where the group ran) and
    ``deferred`` lists the indices whose batch must take the per-engine
    path — worsenings, plateau semirings, validation failures, or a group
    whose batched dispatch itself raised (those engines are untouched, so
    the caller's retry machinery sees the true pre-update state).
    """
    infos: List[Optional[Dict]] = [None] * len(engines)
    deferred: List[int] = []
    groups: Dict[tuple, List[tuple]] = {}
    for i, (eng, batch) in enumerate(zip(engines, batches)):
        kind, payload = DynamicAPSP._classify_batch(eng, batch)
        if kind == "defer":
            deferred.append(i)
            continue
        if kind == "noop":
            eng.stats["noop"] += 1
            infos[i] = payload
            continue
        u, v, w, n_updates = payload
        key = (
            eng._sr.name, eng._with_pred, eng.n, str(eng._dist.dtype), str(eng._device),
            _bucket_k(int(u.size)),
        )
        groups.setdefault(key, []).append((i, eng, u, v, w, n_updates))

    for (_, with_pred, n, _dt, _dev, kb), members in groups.items():
        lead = members[0][1]
        sr, dev = lead._sr, lead._device
        g = len(members)
        uu = np.zeros((g, kb), np.int32)
        vv = np.zeros((g, kb), np.int32)
        ww = np.full((g, kb), sr.zero, np.float32)   # inert pad edges
        for j, (_, _, u, v, w, _) in enumerate(members):
            uu[j, : u.size], vv[j, : v.size], ww[j, : w.size] = u, v, w
        try:
            d = torch.stack([m[1]._dist for m in members])
            p = torch.stack([m[1]._pred for m in members]) if with_pred else None
            d, p, ever, n_passes = _rank_k_fixpoint_batch(
                d, p, torch.from_numpy(uu).to(dev), torch.from_numpy(vv).to(dev),
                torch.from_numpy(ww).to(dev, d.dtype),
                semiring=sr, with_pred=with_pred,
                max_passes=ceil_log2(min(kb, n - 1) + 1) + 1,
            )
        except Exception:
            # the group's engines are untouched (h mutates below): send them
            # down the per-engine path and its retry machinery
            deferred.extend(m[0] for m in members)
            continue
        for j, (i, eng, u, v, w, n_updates) in enumerate(members):
            eng._h[u, v] = w
            # the per-engine path's journal contract: exactly the h mutation
            # (the decrease subset), once the dispatch has returned
            eng._journal_append(u, v, w, eng._version)
            eng._commit(d[j], p[j] if with_pred else None)
            eng.stats["rank_k"] += 1
            eng.stats["rank_k_passes"] += n_passes
            if bool(ever[j]):
                eng._version += 1
            infos[i] = {
                "path": "rank_k", "n_updates": n_updates, "k_padded": kb,
                "passes": n_passes, "batched": g,
            }
    return infos, sorted(deferred)
