"""Atomic checkpoints, ported from ``repro.checkpoint.checkpoint``.

Layout per step, the JAX package's, so a checkpoint written by either
package loads in the other:

    <dir>/step_000123/
        arrays.npz        key-path-flattened leaves
        manifest.json     step, leaf keys and dtypes, caller's extra
    <dir>/LATEST          name of the newest committed step dir

Write protocol (fault tolerant):
    1. write everything into  <dir>/.tmp_step_000123
    2. fsync, then os.replace -> step_000123       (atomic on POSIX)
    3. update <dir>/LATEST (tmp+replace again)
A crash mid-write leaves only a .tmp_ directory, which restore ignores and
the next save overwrites.  ``CheckpointManager`` runs saves on a background
thread (the device->host copy happens synchronously, disk I/O does not
block the caller) and keeps the last ``keep`` checkpoints.

A state is a tree of dicts, lists, tuples and dataclasses (a
``TrainState``) whose leaves are tensors, numpy arrays or numbers; leaves
are keyed by their path (``"a/b/0"``, dict keys sorted, a dataclass field
by its name, ``None`` skipped), as ``jax.tree_util`` keys them, so a train
checkpoint of either package restores in the other.  numpy has no bf16: a
bf16 tensor is stored as its uint16 bit view, its manifest dtype
``"bfloat16"``.  ``restore_onto_mesh`` restores onto one device, or onto
a device mesh (a tree of ``repro_torch.sharding.Sharding``), where each
rank takes its own block of every leaf.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.convert import to_numpy, to_torch
from repro_torch.tree import flatten_with_path, tree_map_with_path

__all__ = [
    "save_checkpoint", "load_checkpoint", "latest_step", "restore_onto_mesh",
    "CheckpointManager", "save_engine_checkpoint", "load_engine_checkpoint",
]

_SEP = "/"


def _leaves(tree):
    for path, leaf in flatten_with_path(tree):
        yield _SEP.join(path), leaf


def _flatten(tree):
    """(flat {key: host array}, {key: dtype name}); bf16 as its bit view."""
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            flat[key], dtypes[key] = to_numpy(leaf)
        else:
            flat[key] = np.asarray(leaf)
            dtypes[key] = str(flat[key].dtype)
    return flat, dtypes


def _write(directory: str, step: int, flat, dtypes, extra: Optional[dict]) -> str:
    """The atomic write protocol of the module docstring."""
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, f".tmp_{name}")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    ltmp = os.path.join(directory, ".LATEST.tmp")
    with open(ltmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(ltmp, os.path.join(directory, "LATEST"))
    return final


def save_checkpoint(directory: str, step: int, state, *, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    flat, dtypes = _flatten(state)
    return _write(directory, step, flat, dtypes, extra)


def latest_step(directory: str) -> Optional[int]:
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            return int(f.read().strip().split("_")[-1])
    except (FileNotFoundError, ValueError):
        return None


def load_checkpoint(directory: str, step: Optional[int] = None):
    """-> (flat dict of host arrays, manifest).  Picks LATEST if step is
    None.  bf16 leaves come back as their uint16 bit views (the manifest's
    ``dtypes`` names them)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return flat, manifest


def restore_onto_mesh(flat: Dict[str, np.ndarray], example_tree, shardings=None, *,
                      device="cuda"):
    """Rebuild ``example_tree``'s structure from ``flat`` (a loaded
    checkpoint), each leaf a new tensor in its example's dtype, with its
    example's ``requires_grad``.  Raises ``KeyError`` on a missing leaf and
    ``ValueError`` on a shape that differs, as the JAX function does.

    Without ``shardings`` every leaf lands whole on ``device``.  With a
    tree of ``repro_torch.sharding.Sharding`` of the example's structure
    (``make_shardings``), each rank takes its own block of each leaf (the
    whole leaf where its spec shards nothing), on the mesh's device; the
    example's shape is the global shape."""
    by_key = None
    if shardings is not None:
        by_key = {_SEP.join(p): s for p, s in flatten_with_path(shardings)}
        want = {k for k, _ in _leaves(example_tree)}
        if set(by_key) != want:
            raise ValueError(f"the sharding tree does not match the state: "
                             f"{sorted(want ^ set(by_key))[:5]}")

    def put(path, example):
        key = _SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(example.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(example.shape)}")
        dev = device
        if by_key is not None:
            sh = by_key[key]
            arr, dev = arr[sh.local_slices(arr.shape)], sh.mesh.device
        if isinstance(example, torch.Tensor):
            out = torch.from_numpy(np.array(arr)).to(device=dev, dtype=example.dtype)
            return out.requires_grad_(example.requires_grad)
        return np.asarray(arr).astype(np.asarray(example).dtype)

    return tree_map_with_path(put, example_tree)


# -- durable engine snapshots (serving-tier restore path) -------------------
#
# A DynamicAPSP engine's recoverable state is its snapshot() (dist / pred /
# h / version) plus the config to rebuild an equivalent engine (semiring,
# storage dtype, with_pred, n), stored through the step-dir protocol above
# with step == version, so LATEST names the newest committed state.  bf16
# states are stored as uint16 bit views with the true dtype in the
# manifest, exactly as the JAX package stores them.


def _unbits(a: Optional[np.ndarray], dtype: Optional[str]) -> Optional[torch.Tensor]:
    """A stored leaf back in its true dtype, as a CPU tensor."""
    if a is None:
        return None
    if dtype not in (None, "bfloat16") and str(a.dtype) != dtype:
        a = a.astype(np.dtype(dtype))
    return to_torch(a, "cpu", dtype)


def save_engine_checkpoint(directory: str, engine, *, extra: Optional[dict] = None) -> str:
    """Atomically checkpoint a ``DynamicAPSP`` engine's solved state.

    Returns the checkpoint path.  Step number == engine version, so the
    LATEST pointer names the newest committed state and
    :func:`load_engine_checkpoint` + journal replay of records with
    ``v0 >= version`` reconstructs any later live state bit-exactly.
    """
    snap = engine.snapshot()
    dist, dist_dt = to_numpy(snap["dist"])
    state = {"dist": dist, "h": snap["h"]}
    pred_dt = None
    if snap["pred"] is not None:
        state["pred"], pred_dt = to_numpy(snap["pred"])
    meta = {
        "kind": "engine",
        "version": int(snap["version"]),
        "n": int(engine.n),
        "semiring": engine.semiring.name,
        "with_pred": pred_dt is not None,
        "state_dtype": dist_dt,
        "pred_dtype": pred_dt,
    }
    if extra:
        meta.update(extra)
    return save_checkpoint(directory, int(snap["version"]), state, extra=meta)


def load_engine_checkpoint(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Load a durable engine snapshot (LATEST if ``step`` is None).

    Returns ``{"dist", "pred", "h", "version", "semiring", "with_pred",
    "state_dtype", "n"}``: ``dist`` / ``pred`` as CPU tensors in their true
    dtypes (numpy has no bf16; ``DynamicAPSP.snapshot`` gives the same
    form), ``h`` a float32 numpy array — directly consumable as
    ``DynamicAPSP(h, state=...)``'s restore state.
    """
    flat, manifest = load_checkpoint(directory, step)
    meta = manifest.get("extra", {})
    if meta.get("kind") != "engine":
        raise ValueError(
            f"checkpoint under {directory} is not an engine checkpoint "
            f"(kind={meta.get('kind')!r})"
        )
    out = dict(meta)
    out["dist"] = _unbits(flat["dist"], meta.get("state_dtype"))
    out["pred"] = (_unbits(flat.get("pred"), meta.get("pred_dtype"))
                   if meta.get("with_pred") else None)
    out["h"] = flat["h"]
    out["version"] = int(meta["version"])
    return out


class CheckpointManager:
    """Background-threaded saver with retention.

    ``save`` copies the state to the host synchronously and hands disk I/O
    to a worker thread; ``wait`` joins the write in flight and raises its
    error, if any (call it before exit and before a restore)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, extra: Optional[dict] = None):
        self.wait()
        flat, dtypes = _flatten(state)     # device->host before returning

        def work():
            try:
                _write(self.directory, step, flat, dtypes, extra)
                self._gc()
            except BaseException as e:   # surfaced on the next save/wait
                self._error = e

        os.makedirs(self.directory, exist_ok=True)
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            d for d in os.listdir(self.directory) if d.startswith("step_")
        )
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
