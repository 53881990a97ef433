"""Persistent autotune cache of the PyTorch port, ported from
``repro.kernels.autotune``.

The JAX package measures a small candidate lattice per (shape bucket,
dtype, backend) and persists the winners; its dispatch reads them.  Of its
three key families only one has a knob here:

* ``fwround|...`` (:func:`key_for_fw_round`): the blocked solve's
  (block_size, round_mode).  :func:`tune_fw_round` sweeps block size x
  round mode with whole solves, interleaved as in the JAX package, timed
  with CUDA events on the card (the host clock on the CPU), and persists
  the winner; ``core.blocked_fw._resolve_round`` consults
  :func:`lookup_fw_round` when the caller gives no block size or mode
  (explicit arguments win; predecessor solves stay on the fused round).
* the product family (:func:`key_for`) and ``rowclose|...``
  (:func:`key_for_row_close`) have no knob: the ``minplus`` kernel takes a
  fixed 64 x 128 value tile (64 x 64 with a witness), 32-deep k slices,
  and ``row_close`` derives its plan from the shape
  (``row_close.launch_plan``); the plain versions fold a fixed number of
  elements at a time.  :func:`tune` and :func:`tune_row_close` return that
  fixed plan without measuring (``source`` says so) and write nothing.

Keys are the JAX package's with the backend tag ``cuda`` (the kernels) or
``torch`` (the plain versions on the CPU).  :func:`lookup` and its
siblings are a plain dict read of the cache and never measure.

Cache file: JSON, atomic tmp+rename writes, merged on save, the JAX
package's schema, but a file of the port's own — never the JAX package's
``~/.cache/repro/autotune.json``.

Environment:

  * ``REPRO_AUTOTUNE=0``       disabled: lookups return {} and the tuners
                               return ``source="disabled"``.
  * unset / ``REPRO_AUTOTUNE=1``  lookups read the cache; the tuners
                               measure only on a cache miss.
  * ``REPRO_AUTOTUNE=force``   :func:`tune_fw_round` re-measures and
                               overwrites even when a winner is cached.
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
from typing import Dict, Optional

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
    "tune",
    "tune_fw_round",
    "tune_row_close",
    "load_entries",
    "touched_entries",
    "measure",
]

SCHEMA = 1
_FW_ROUND_BLOCKS = (32, 64, 128, 256)
_FW_ROUND_MODES = ("fused", "split")
_DEFAULT_CACHE = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "autotune.json"

# memoized parse of the cache file, invalidated by mtime
_memo = {"path": None, "mtime": None, "entries": {}}

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
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE", "")
    return Path(env) if env else _DEFAULT_CACHE


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
    """Parsed cache entries (mtime-memoized; {} on an absent or corrupt
    file)."""
    p = cache_path()
    try:
        st = os.stat(p)
    except OSError:
        _memo.update(path=str(p), mtime=None, entries={})
        return {}
    if not reload and _memo["path"] == str(p) and _memo["mtime"] == st.st_mtime_ns:
        return _memo["entries"]
    try:
        data = json.loads(Path(p).read_text())
        entries = data.get("entries", {}) if data.get("schema") == SCHEMA else {}
        if not isinstance(entries, dict):
            entries = {}
    except (OSError, ValueError, AttributeError):
        entries = {}
    _memo.update(path=str(p), mtime=st.st_mtime_ns, entries=entries)
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
    _memo.update(path=str(p), mtime=None, entries={})   # force a re-read


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


def lookup(backend: str, dtype, m: int, k: int, n: int, g: int = 0,
           semiring: str = "tropical") -> dict:
    """Cached params of a product shape, or {} (miss / disabled)."""
    p = _lookup(key_for(backend, dtype, m, k, n, g=gq, semiring=sq)
                for sq, gq in _fallbacks(semiring, g))
    return {} if p is None else dict(p)


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
    """Cached params of a row-close pass, or {} (miss / disabled)."""
    p = _lookup(key_for_row_close(backend, dtype, r, n, semiring=sq)
                for sq, _ in _fallbacks(semiring, 0))
    return {} if p is None else dict(p)


def touched_entries() -> Dict[str, dict]:
    """{key: params} of the cache entries this process consulted or tuned."""
    entries = load_entries()
    return {key: entries[key].get("params") for key in sorted(_touched) if key in entries}


def _device(device) -> torch.device:
    """``device``, or the card when none is given (the port's default)."""
    from repro_torch.core.semiring import default_device

    return torch.device(default_device(device))


def measure(fn, reps: int, device="cpu") -> float:
    """Best-of-``reps`` time of ``fn()`` in microseconds, after one warm
    call: CUDA events on a CUDA device, the host clock elsewhere."""
    cuda = torch.device(device).type == "cuda"
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(max(reps, 1)):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


def _fixed(source: str, params: dict) -> dict:
    return {"params": params, "source": f"fixed plan: {source}"}


def tune(m: int, k: int, n: int, *, g: int = 0, dtype=torch.float32, device=None,
         reps: int = 2, force: Optional[bool] = None, semiring: str = "tropical") -> dict:
    """The product family's plan for one shape: fixed, nothing measured or
    written (see the module docstring); ``source="disabled"`` under
    ``REPRO_AUTOTUNE=0``.  Arguments as the JAX tuner's."""
    if mode() == "off":
        return {"params": {}, "source": "disabled"}
    if _device(device).type == "cuda":
        return _fixed("the minplus kernel's 64 x 128 value tile (64 x 64 with a witness), "
                      "32-deep k slices; nothing to measure", {"bm": 64, "bn": 128, "bk": 32})
    from .minplus import _FOLD_BUDGET

    return _fixed("the plain fold's fixed element budget; nothing to measure",
                  {"fold_elements": _FOLD_BUDGET})


def tune_row_close(r: int, n: int, *, dtype=torch.float32, device=None, reps: int = 2,
                   force: Optional[bool] = None, semiring: str = "tropical") -> dict:
    """The row-close pass's plan for (r, n): on the card the plan
    ``row_close.launch_plan`` derives from the shape, nothing measured or
    written; ``source="disabled"`` under ``REPRO_AUTOTUNE=0``."""
    if mode() == "off":
        return {"params": {}, "source": "disabled"}
    dev = _device(device)
    if dev.type == "cuda":
        from .row_close import launch_plan

        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return _fixed("row_close.launch_plan derives it from the shape; nothing to measure",
                      launch_plan(r, n, False, sms)._asdict())
    from .minplus import _FOLD_BUDGET

    return _fixed("the plain fold's fixed element budget; nothing to measure",
                  {"fold_elements": _FOLD_BUDGET})


def _tuning_matrix(n: int, dtype, semiring, device) -> torch.Tensor:
    """An in-domain (n, n) cost matrix, 30% no-edge, the one on the
    diagonal (the JAX tuner's inputs)."""
    rng = np.random.default_rng(0)
    no_edge = rng.uniform(size=(n, n)) < 0.3
    if semiring.name == "reliability":
        a = np.where(no_edge, 0.0, rng.uniform(0.05, 1.0, size=(n, n)))
    elif semiring.name == "boolean":
        a = np.where(no_edge, 0.0, 1.0)
    elif semiring.name == "bottleneck":
        a = np.where(no_edge, -np.inf, rng.uniform(1, 100, size=(n, n)))
    else:
        a = np.where(no_edge, np.inf, rng.uniform(1, 100, size=(n, n)))
    a = a.astype(np.float32)
    np.fill_diagonal(a, semiring.one)
    return torch.from_numpy(a).to(device, dtype)


def tune_fw_round(n: int, *, dtype=torch.float32, device=None, reps: int = 2,
                  force: Optional[bool] = None, semiring: str = "tropical",
                  blocks: Optional[tuple] = None) -> dict:
    """Sweep block size x round mode with whole blocked solves on an
    in-domain matrix of edge ``bucket(n)`` and persist the winning
    (block_size, round_mode) under the ``fwround|...`` key.  Returns the
    cache entry; ``source`` is ``"cache"`` when a persisted winner was
    reused, ``"measured"`` after a sweep, ``"disabled"`` under
    ``REPRO_AUTOTUNE=0``."""
    from repro_torch.core.semiring import get_semiring

    sr = get_semiring(semiring)
    md = mode()
    if md == "off":
        return {"params": {}, "source": "disabled"}
    dev = _device(device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    key = key_for_fw_round(backend, dtype, n, semiring=sr.name)
    _touched.add(key)
    refresh = (md == "force") if force is None else force
    if not refresh:
        cached = load_entries().get(key)
        if cached and isinstance(cached.get("params"), dict):
            return dict(cached, source="cache")

    from repro_torch.core.blocked_fw import blocked_fw   # lazy: core imports kernels

    nb = bucket(n)
    cand_blocks = tuple(bb for bb in (blocks or _FW_ROUND_BLOCKS) if bb <= nb) or (min(nb, 32),)
    h = _tuning_matrix(nb, dtype, sr, dev)
    cands = [{"block_size": bb, "round_mode": rm}
             for bb in cand_blocks for rm in _FW_ROUND_MODES]
    fns = [
        (lambda p=p: blocked_fw(h, block_size=p["block_size"], round_mode=p["round_mode"],
                                semiring=sr)[0])
        for p in cands
    ]
    # Interleaved sweeps (candidate-major, not rep-major): load that drifts
    # within a sequential sweep would crown whichever candidate ran in the
    # calm moment; round-robin puts every candidate in every window.
    best = [float("inf")] * len(cands)
    for _ in range(max(reps, 2)):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], measure(fn, 1, dev))
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
