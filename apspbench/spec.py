"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads[]``) names a configuration, whose ``file`` holds its
sizes, and a traffic mix, ``traffic/<traffic>.json``, whose ``kind`` is a
loop, ``kinds/<kind>.py``.  Every metric is a reader,
``metrics/<name>.py``, with ``read(record) -> float | None``.  A later
change adds a cell, a configuration, a mix, a traffic kind or a metric as
new files and new entries, and edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metrics(spec: dict, workload: str, per_layer: bool) -> List[dict]:
    """The cell's metrics of one kind: those that list it, and those that
    list no cells."""
    key = "per_layer" if per_layer else "end_to_end"
    return [m for m in spec[key] if workload in m.get("workloads", [workload])]


_readers: Dict[str, object] = {}


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    if name not in _readers:
        path = HERE / "metrics" / f"{name}.py"
        mod_spec = importlib.util.spec_from_file_location(f"apspbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _readers[name] = mod.read
    return _readers[name]
