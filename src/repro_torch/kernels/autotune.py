"""Persistent autotune cache of the PyTorch port, ported from
``repro.kernels.autotune``.

The JAX package measures a small candidate lattice per (shape bucket,
dtype, backend) and persists the winners; its dispatch reads them.  The
port does the same for its three key families, on its kernels' own knobs:

* the product family (:func:`key_for`): the ``minplus`` kernel's
  ``tile_rows`` (16, 32 or 64: the tile lattice of
  ``csrc/minplus_tile.cuh``) and ``chunks`` (k split across CTAs, finished
  by the split-k combine).  :func:`candidates` lists the lattice of a
  shape bucket, :func:`tune` measures it on the card and persists the
  fastest, :func:`tune_blocked_fw` tunes the three panel shapes of one
  blocked-FW pivot step; ``kernels.ops`` reads the winner on every CUDA
  (and ``meta``) dispatch that passes no knob (:func:`lookup`).
* ``rowclose|...`` (:func:`key_for_row_close`): ``row_close``'s
  ``tile_rows`` and ``chunks`` (:func:`tune_row_close`; without a winner
  its plan comes from the fill rule of ``row_close.launch_plan``).
* ``fwround|...`` (:func:`key_for_fw_round`): the blocked solve's
  (block_size, round_mode).  :func:`tune_fw_round` warms each candidate
  block's (N, B, N) product first, then sweeps block size x round mode
  with whole solves; ``core.blocked_fw._resolve_round`` consults
  :func:`lookup_fw_round` when the caller gives no block size or mode
  (explicit arguments win; predecessor solves stay on the fused round).

Every tuner measures on the card with CUDA events, candidates
interleaved (every candidate in every round, the best of each kept).  On
the CPU the plain versions have no knob (a knob changes no value):
:func:`tune` and :func:`tune_row_close` return the plain fold's fixed
entry, measure nothing and write nothing; :func:`tune_fw_round` times
whole solves on the host clock.

Keys are the JAX package's with the backend tag ``cuda`` (the kernels, and
the ``meta`` route that stands for them) or ``torch`` (the plain versions
on the CPU).  :func:`lookup` and its siblings are a plain dict read of
the cache and never measure; they return only the backend's knobs
(:func:`knobs`).

Cache file: JSON, atomic tmp+rename writes, merged on save, the JAX
package's schema, but a file of the port's own — never the JAX package's
``~/.cache/repro/autotune.json``.

Environment:

  * ``REPRO_AUTOTUNE=0``       disabled: lookups return {} and the tuners
                               return ``source="disabled"``.
  * unset / ``REPRO_AUTOTUNE=1``  lookups read the cache; the tuners
                               measure only on a cache miss.
  * ``REPRO_AUTOTUNE=force``   the tuners re-measure and overwrite even
                               when a winner is cached.
  * ``REPRO_TORCH_AUTOTUNE_CACHE``  cache file path (default
                               ``build/repro_torch/autotune.json`` at the
                               repo root, beside the built kernels).
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "mode",
    "cache_path",
    "bucket",
    "key_for",
    "key_for_fw_round",
    "key_for_row_close",
    "lookup",
    "lookup_fw_round",
    "lookup_row_close",
    "knobs",
    "candidates",
    "tune",
    "tune_blocked_fw",
    "tune_fw_round",
    "tune_row_close",
    "load_entries",
    "touched_entries",
    "measure",
]

SCHEMA = 1
# The knobs of the CUDA product and row_close kernels (``minplus.launch_plan``
# and ``row_close.launch_plan``); the plain versions take none.
_CUDA_KEYS = ("tile_rows", "chunks")
# The most chunks the product and row-close lattices split k into (the
# grid verifier proves every count up to it: kernelcheck.lattice).
_MAX_CHUNKS = 64
# The most bytes of chunk partials a split candidate may allocate (a witness
# plan's: a value and a k, 8 bytes an output a chunk): 1 GiB, an eightieth
# of the H100's memory.  A fixed cap, not the card's free memory, keeps the
# lattice a function of the shape alone, as the grid verifier lists it.
_MAX_PARTIAL_BYTES = 1 << 30
_FW_ROUND_BLOCKS = (32, 64, 128, 256)
_FW_ROUND_MODES = ("fused", "split")
_DEFAULT_CACHE = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "autotune.json"

# The cache file as this process parsed it, and the knobs each shape bucket
# resolved to in it: ``lookup`` runs on every CUDA product dispatch, so the
# file is read once a path and a bucket's keys and fallbacks resolved once;
# both are dropped when the path changes or this process saves (the tuners
# run in the process that dispatches).
_memo = {"path": None, "entries": {}, "resolved": {}}

# cache keys this process consulted (hit) or tuned
_touched: set = set()


def mode() -> str:
    """Autotune behaviour: 'off' | 'on' | 'force' (see module docstring)."""
    env = os.environ.get("REPRO_AUTOTUNE", "1").strip().lower()
    if env in ("0", "off", "false", "no"):
        return "off"
    if env == "force":
        return "force"
    return "on"


def cache_path() -> Path:
    return Path(_cache_file())


def _cache_file() -> str:
    """The cache file's path as a string, which each lookup compares with
    the memo's."""
    return os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE", "") or str(_DEFAULT_CACHE)


def bucket(v: int) -> int:
    """Shape bucket: next power of two, floor 8."""
    p = 8
    while p < v:
        p *= 2
    return p


def _dtype_name(dtype) -> str:
    """``torch.float32`` / ``np.float32`` / ``"float32"`` -> ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return dtype if isinstance(dtype, str) else np.dtype(dtype).name


def _semiring_tag(key: str, semiring: str) -> str:
    return key if semiring == "tropical" else f"{key}|s:{semiring}"


def key_for(backend: str, dtype, m: int, k: int, n: int, g: int = 0,
            semiring: str = "tropical") -> str:
    """Product-family key; non-tropical semirings add ``|s:<name>``."""
    gb = bucket(g) if g else 0
    return _semiring_tag(
        f"{backend}|{_dtype_name(dtype)}|g{gb}|m{bucket(m)}|k{bucket(k)}|n{bucket(n)}",
        semiring)


def key_for_fw_round(backend: str, dtype, n: int, g: int = 0,
                     semiring: str = "tropical") -> str:
    """Key of the blocked solve's round shape: the winner is a
    (block_size, round_mode) pair for one matrix edge bucket; bf16 tunes
    separately from f32."""
    gb = bucket(g) if g else 0
    return _semiring_tag(f"fwround|{backend}|{_dtype_name(dtype)}|g{gb}|n{bucket(n)}",
                         semiring)


def key_for_row_close(backend: str, dtype, r: int, n: int,
                      semiring: str = "tropical") -> str:
    """Key of the row-restricted close pass: affected-row bucket r, matrix
    edge n."""
    return _semiring_tag(f"rowclose|{backend}|{_dtype_name(dtype)}|r{bucket(r)}|n{bucket(n)}",
                         semiring)


def load_entries(*, reload: bool = False) -> Dict[str, dict]:
    """Parsed cache entries, read once a path unless ``reload`` ({} on an
    absent or corrupt file)."""
    p = _cache_file()
    if not reload and _memo["path"] == p:
        return _memo["entries"]
    try:
        data = json.loads(Path(p).read_text())
        entries = data.get("entries", {}) if data.get("schema") == SCHEMA else {}
        if not isinstance(entries, dict):
            entries = {}
    except (OSError, ValueError, AttributeError):
        entries = {}
    _memo.update(path=p, entries=entries, resolved={})
    return entries


def _save(new_entries: Dict[str, dict]) -> None:
    """Merge ``new_entries`` into the cache file atomically."""
    p = cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    entries = dict(load_entries(reload=True))
    entries.update(new_entries)
    payload = json.dumps({"schema": SCHEMA, "entries": entries}, indent=1, sort_keys=True)
    fd, tmp = tempfile.mkstemp(dir=str(p.parent), prefix=".autotune-")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _memo.update(path=None, entries={}, resolved={})  # re-read


def _lookup(keys) -> Optional[dict]:
    """The params of the first cached key of ``keys``, or None."""
    if mode() == "off":
        return None
    entries = load_entries()
    for key in keys:
        e = entries.get(key)
        if e and isinstance(e.get("params"), dict):
            _touched.add(key)
            return e["params"]
    return None


def _fallbacks(semiring: str, g: int):
    """(semiring, g) lookup order: batched -> g=0, non-tropical ->
    tropical of the same shape (identical memory traffic)."""
    srs = (semiring, "tropical") if semiring != "tropical" else ("tropical",)
    return [(sq, gq) for sq in srs for gq in ((g, 0) if g else (0,))]


def knobs(backend: str, params: dict) -> dict:
    """``params`` cut to the knobs ``backend`` takes (``_filter`` of the
    JAX package): ``tile_rows`` and ``chunks`` on ``cuda`` and ``meta``,
    none on ``torch`` (the plain versions fold one way)."""
    keys = _CUDA_KEYS if backend in ("cuda", "meta") else ()
    return {k: int(v) for k, v in params.items() if k in keys}


def _resolved(rkey: tuple, keys) -> dict:
    """The knobs of the first cached key of ``keys()``, resolved once a
    read of the cache file for the bucket ``rkey`` (family, backend, dtype,
    buckets, semiring); {} on a miss or disabled."""
    if mode() == "off":
        return {}
    load_entries()
    memo = _memo["resolved"]
    if rkey not in memo:
        p = _lookup(keys())
        memo[rkey] = {} if p is None else knobs(rkey[1], p)
    return dict(memo[rkey])


def lookup(backend: str, dtype, m: int, k: int, n: int, g: int = 0,
           semiring: str = "tropical") -> dict:
    """Cached knobs of a product shape, or {} (miss / disabled)."""
    return _resolved(("product", backend, dtype, bucket(m), bucket(k), bucket(n),
                      bucket(g) if g else 0, semiring),
                     lambda: (key_for(backend, dtype, m, k, n, g=gq, semiring=sq)
                              for sq, gq in _fallbacks(semiring, g)))


def lookup_fw_round(backend: str, dtype, n: int, g: int = 0,
                    semiring: str = "tropical") -> dict:
    """Winner (block_size, round_mode) of a blocked solve of edge n, or {}
    (miss / disabled); fallbacks as :func:`lookup`."""
    p = _lookup(key_for_fw_round(backend, dtype, n, g=gq, semiring=sq)
                for sq, gq in _fallbacks(semiring, g))
    out: dict = {}
    if p:
        if "block_size" in p:
            out["block_size"] = int(p["block_size"])
        if p.get("round_mode") in _FW_ROUND_MODES:
            out["round_mode"] = p["round_mode"]
    return out


def lookup_row_close(backend: str, dtype, r: int, n: int,
                     semiring: str = "tropical") -> dict:
    """Cached knobs of a row-close pass, or {} (miss / disabled)."""
    return _resolved(("rowclose", backend, dtype, bucket(r), bucket(n), semiring),
                     lambda: (key_for_row_close(backend, dtype, r, n, semiring=sq)
                              for sq, _ in _fallbacks(semiring, 0)))


def touched_entries() -> Dict[str, dict]:
    """{key: params} of the cache entries this process consulted or tuned."""
    entries = load_entries()
    return {key: entries[key].get("params") for key in sorted(_touched) if key in entries}


def _device(device) -> torch.device:
    """``device``, or the card when none is given (the port's default)."""
    from repro_torch.core.semiring import default_device

    return torch.device(default_device(device))


def _sms(device) -> int:
    """The SM count of the card ``device``, which the candidates' fill test
    takes."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def measure(fn, reps: int, device="cpu", burst: int = 1) -> float:
    """Best-of-``reps`` time of ``fn()`` in microseconds, after one warm
    call: CUDA events on a CUDA device, the host clock elsewhere.  With
    ``burst`` > 1 each rep times that many calls back to back and divides:
    the cost a call has in a dispatch loop, the larger of its host and its
    device time."""
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(max(reps, 1)):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(burst):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / burst)
        else:
            t0 = time.perf_counter()
            for _ in range(burst):
                fn()
            best = min(best, (time.perf_counter() - t0) * 1e6 / burst)
    return best


def _fixed(source: str, params: dict) -> dict:
    return {"params": params, "source": f"fixed plan: {source}"}


def _plain_entry() -> dict:
    from .minplus import _FOLD_BUDGET

    return _fixed("the plain fold's fixed element budget; nothing to measure",
                  {"fold_elements": _FOLD_BUDGET})


def _chunk_counts(k: int) -> List[int]:
    """Chunk counts of the lattice for a k bucket: powers of two while a
    chunk stays at least ``row_close.MIN_CHUNK`` long, at most
    :data:`_MAX_CHUNKS`."""
    from .row_close import MIN_CHUNK

    out, c = [1], 2
    while k // c >= MIN_CHUNK and c <= _MAX_CHUNKS:
        out.append(c)
        c *= 2
    return out


def candidates(backend: str, m: int, k: int, n: int, *, g: int = 0,
               sms: int = 132) -> List[dict]:
    """The candidate lattice measured per shape bucket (kept small: seconds
    a bucket).  ``cuda``: the product kernel's plans for the bucketed shape
    (a batch of ``g``) on a card of ``sms`` SMs: tile rows no taller than
    the bucketed m needs (16 up to m = 16, 32 up to 32), each whole, and
    split into the chunk counts of :func:`_chunk_counts` only while its
    unsplit grid fills less than ``row_close.WAVE_FILL`` of its last wave
    (``row_close``'s fill test) and the partials stay within
    :data:`_MAX_PARTIAL_BYTES`; every one a legal ``minplus.launch_plan``.
    ``torch``: the plain fold's single entry."""
    if backend not in ("cuda", "meta"):
        return [_plain_entry()["params"]]
    from .minplus import LATTICE_ROWS, launch_plan, tile
    from .row_close import WAVE_FILL, wave_fill

    gb, mb, kb, nb = (bucket(g) if g else 1), bucket(m), bucket(k), bucket(n)
    out = []
    for r in (r for r in LATTICE_ROWS if r <= max(LATTICE_ROWS[0], mb)):
        ctas = gb * -(-mb // r) * -(-nb // tile(r, False)[1])
        counts = _chunk_counts(kb) if wave_fill(ctas, sms) < WAVE_FILL else [1]
        out += [{"tile_rows": r, "chunks": c} for c in counts
                if launch_plan(gb, mb, kb, nb, "minplus_argmin", tile_rows=r,
                               chunks=c).partial_bytes <= _MAX_PARTIAL_BYTES]
    return out


def _row_close_candidates(backend: str, r: int, n: int, sms: int = 132) -> List[dict]:
    """The row-close pass's lattice for an (r, n) bucket: as
    :func:`candidates` over the (r, n) x (n, n) panel, plus the plan the
    fill rule gives with no knob (``row_close.launch_plan``), so the winner
    is never one the default beats.  ``torch``: the plain fold's entry."""
    if backend not in ("cuda", "meta"):
        return [_plain_entry()["params"]]
    from .row_close import launch_plan

    out = candidates(backend, r, n, n, sms=sms)
    fill = launch_plan(r, n, False, sms)
    default = {"tile_rows": fill.rows, "chunks": fill.chunks}
    return out if default in out else out + [default]


def _entry(key: str, md: str, force: Optional[bool], filt) -> Optional[dict]:
    """The cached entry of ``key`` as a tuner returns it (knobs filtered,
    ``source="cache"``), unless re-measuring is forced."""
    _touched.add(key)
    refresh = (md == "force") if force is None else force
    if refresh:
        return None
    cached = load_entries().get(key)
    if cached and isinstance(cached.get("params"), dict):
        return dict(cached, params=filt(cached["params"]), source="cache")
    return None


# Calls a product or row-pass candidate is timed over, back to back: a
# dispatch loop's cost a call (:func:`measure`), so a plan that saves device
# time but adds host work (a split plan's combine launch) wins only where
# the card, not the host, bounds the loop.
_BURST = 8


def _sweep(fns, reps: int, device, burst: int = 1) -> List[float]:
    """Best time of each of ``fns`` in microseconds over ``max(reps, 2)``
    rounds that each time every function once, after its warm call
    (:func:`measure`, ``burst`` calls a time): interleaved,
    candidate-major, since load that drifts within a sequential sweep would
    crown whichever candidate ran in the calm moment."""
    best = [float("inf")] * len(fns)
    for _ in range(max(reps, 2)):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], measure(fn, 1, device, burst))
    return best


def _measured(cands: List[dict], best: List[float], key: str) -> dict:
    """Persist the fastest of ``cands`` (times ``best``) under ``key``;
    the entry as the JAX tuner writes it."""
    best_us = min(best)
    entry = {
        "params": cands[best.index(best_us)],
        "us": best_us,
        "lattice": len(cands),
        "source": "measured",
        "measured_at": datetime.datetime.now().isoformat(timespec="seconds"),
    }
    _save({key: entry})
    return entry


def tune(m: int, k: int, n: int, *, g: int = 0, dtype=torch.float32, device=None,
         backend: Optional[str] = None, reps: int = 2, force: Optional[bool] = None,
         semiring: str = "tropical") -> dict:
    """Measure the product lattice (:func:`candidates`) for one shape
    bucket on the card — the fused accumulate ``a ⊕ x ⊗ y`` at the bucketed
    shape, the batch capped at 8 — and persist the fastest under
    :func:`key_for`'s key (backend ``cuda``).  Returns the cache entry;
    ``source`` is ``"cache"`` when a persisted winner was reused,
    ``"measured"`` after a sweep, ``"disabled"`` under ``REPRO_AUTOTUNE=0``.
    On the CPU: the plain fold's fixed entry, nothing measured or written.
    Arguments as the JAX tuner's; ``device`` picks the route, and JAX's
    ``backend`` (Pallas, XLA or interpret) is taken and dropped, whatever
    its value."""
    from repro_torch.core.semiring import get_semiring

    del backend                          # the route follows ``device``
    sr = get_semiring(semiring)
    md = mode()
    if md == "off":
        return {"params": {}, "source": "disabled"}
    dev = _device(device)
    if dev.type != "cuda":
        return _plain_entry()
    key = key_for("cuda", dtype, m, k, n, g=g, semiring=sr.name)
    cached = _entry(key, md, force, lambda p: knobs("cuda", p))
    if cached is not None:
        return cached
    from .minplus import minplus_cuda

    mb, kb, nb = bucket(m), bucket(k), bucket(n)
    gb = min(bucket(g), 8) if g else 0
    lead = (gb,) if gb else ()
    # f32 operands whatever the key's dtype: the kernel computes in f32
    x = _in_domain(lead + (mb, kb), sr, dev, 0)
    y = _in_domain(lead + (kb, nb), sr, dev, 1)
    a = _in_domain(lead + (mb, nb), sr, dev, 2)
    cands = candidates("cuda", mb, kb, nb, g=gb, sms=_sms(dev))
    fns = [(lambda p=p: minplus_cuda(x, y, a, semiring=sr, **p)) for p in cands]
    return _measured(cands, _sweep(fns, reps, dev, _BURST), key)


def tune_blocked_fw(n: int, block_size: int, *, g: int = 0, dtype=torch.float32, device=None,
                    backend: Optional[str] = None, reps: int = 2,
                    semiring: str = "tropical") -> Dict[str, dict]:
    """Tune the three panel-product shapes one blocked-FW pivot step hits:
    the row panel (B, B) x (B, N), the column panel (N, B) x (B, B) and the
    fused phase-3 (N, B) x (B, N) accumulate.  Returns {shape name: entry}.
    ``backend`` is dropped, as :func:`tune` drops it."""
    del backend
    b = min(block_size, n)
    shapes = {"row_panel": (b, b, n), "col_panel": (n, b, b), "phase3": (n, b, n)}
    return {name: tune(m, k, nn, g=g, dtype=dtype, device=device, reps=reps,
                       semiring=semiring)
            for name, (m, k, nn) in shapes.items()}


def tune_row_close(r: int, n: int, *, dtype=torch.float32, device=None,
                   backend: Optional[str] = None, reps: int = 2,
                   force: Optional[bool] = None, semiring: str = "tropical") -> dict:
    """Measure the row-close lattice (:func:`_row_close_candidates`) for one
    (r, n) bucket on the card — the pass's grids alone, on an in-domain
    (n, n) matrix and r distinct rows (r's bucket halved, as the JAX tuner
    takes it) — and persist the fastest under the ``rowclose|...`` key.
    Semantics as :func:`tune` (``backend`` dropped); on the CPU the plain
    fold's fixed entry."""
    from repro_torch.core.semiring import get_semiring

    del backend
    sr = get_semiring(semiring)
    md = mode()
    if md == "off":
        return {"params": {}, "source": "disabled"}
    dev = _device(device)
    if dev.type != "cuda":
        return _plain_entry()
    key = key_for_row_close("cuda", dtype, r, n, semiring=sr.name)
    cached = _entry(key, md, force, lambda p: knobs("cuda", p))
    if cached is not None:
        return cached
    from .row_close import _prepare

    nb = bucket(n)
    rb = min(max(r, max(bucket(r) // 2, 1)), nb)
    d = _tuning_matrix(nb, torch.float32, sr, dev)
    rows = _tuning_rows(nb, rb, dev)
    cands = _row_close_candidates("cuda", rb, nb, _sms(dev))

    def make(p):
        launch = _prepare("row_close", d, rows, None, sr, **p)[0]

        def run():
            err = launch()
            if err:
                raise RuntimeError(f"row_close kernel launch failed: cudaError_t {err}")
        return run

    return _measured(cands, _sweep([make(p) for p in cands], reps, dev, _BURST), key)


def _in_domain(shape, semiring, device, seed: int) -> torch.Tensor:
    """In-domain float32 values of ``shape`` for ``semiring``, 30% no-edge
    (the semiring zero), as the JAX tuner draws them, drawn on ``device``
    (a full-size operand drawn on the host would cost the tuner seconds)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(shape, generator=gen, device=device)
    no_edge = torch.rand(shape, generator=gen, device=device) < 0.3
    if semiring.name == "reliability":
        vals, zero = 0.05 + 0.95 * u, 0.0
    elif semiring.name == "boolean":
        vals, zero = torch.ones_like(u), 0.0
    else:
        vals = 1.0 + 99.0 * u
        zero = float("-inf") if semiring.name == "bottleneck" else float("inf")
    return torch.where(no_edge, torch.full_like(u, zero), vals)


def _tuning_rows(n: int, r: int, device) -> torch.Tensor:
    """r distinct row ids of [0, n), int32 (the JAX tuner's draw)."""
    ids = np.random.default_rng(0).choice(n, size=r, replace=False).astype(np.int32)
    return torch.from_numpy(ids).to(device)


def _tuning_matrix(n: int, dtype, semiring, device) -> torch.Tensor:
    """An in-domain (n, n) cost matrix, 30% no-edge, the one on the
    diagonal (the JAX tuner's inputs)."""
    a = _in_domain((n, n), semiring, device, 0)
    a.diagonal().fill_(semiring.one)
    return a.to(dtype)


def tune_fw_round(n: int, *, dtype=torch.float32, device=None,
                  backend: Optional[str] = None, reps: int = 2,
                  force: Optional[bool] = None, semiring: str = "tropical",
                  blocks: Optional[tuple] = None) -> dict:
    """Sweep block size x round mode with whole blocked solves on an
    in-domain matrix of edge ``bucket(n)`` and persist the winning
    (block_size, round_mode) under the ``fwround|...`` key.  Returns the
    cache entry; ``source`` is ``"cache"`` when a persisted winner was
    reused, ``"measured"`` after a sweep, ``"disabled"`` under
    ``REPRO_AUTOTUNE=0``.  ``backend`` is dropped, as :func:`tune` drops
    it: the key's backend follows ``device``."""
    from repro_torch.core.semiring import get_semiring

    sr = get_semiring(semiring)
    md = mode()
    if md == "off":
        return {"params": {}, "source": "disabled"}
    dev = _device(device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    key = key_for_fw_round(backend, dtype, n, semiring=sr.name)
    cached = _entry(key, md, force, dict)
    if cached is not None:
        return cached

    from repro_torch.core.blocked_fw import blocked_fw   # lazy: core imports kernels

    nb = bucket(n)
    cand_blocks = tuple(bb for bb in (blocks or _FW_ROUND_BLOCKS) if bb <= nb) or (min(nb, 32),)
    # Each candidate's dominant stage-3 product (N, B) x (B, N) is tuned
    # first (on a miss), so the sweep times each round with the products
    # its dispatch will run.
    for bb in cand_blocks:
        tune(nb, bb, nb, dtype=dtype, device=dev, reps=1, semiring=sr.name)
    h = _tuning_matrix(nb, dtype, sr, dev)
    cands = [{"block_size": bb, "round_mode": rm}
             for bb in cand_blocks for rm in _FW_ROUND_MODES]
    fns = [
        (lambda p=p: blocked_fw(h, block_size=p["block_size"], round_mode=p["round_mode"],
                                semiring=sr)[0])
        for p in cands
    ]
    return _measured(cands, _sweep(fns, reps, dev), key)
