"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/repro_torch/`` at the repo
root, named by a hash of the sources so that an edit rebuilds.  Nothing
prebuilt is used.  The flags leave out ``--use_fast_math`` and
``-ftz=true``: flushed subnormals would change the reliability semiring's
products.  ``-Xptxas -v`` output is kept beside the library, so callers can
report each kernel's registers and spills.

Import this module only where a kernel is about to launch: the CPU tests
import the package on hosts with no ``nvcc`` and no CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[Tuple[str, str], Any] = {}
# Sources outside csrc/ (name -> path of its .cu), built and loaded the same
# way: the grid verifier's seeded-defect kernels.
_extra: Dict[str, Path] = {}


def register_source(name: str, path) -> None:
    """Build ``path`` (a .cu file with a plain C interface) under ``name``
    with the kernels' flags, at first use like the others."""
    _extra[name] = Path(path)


def _source(name: str) -> Path:
    return _extra.get(name, CSRC / f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [_source(name)]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def paths(name: str):
    """(library, ptxas log) paths of ``csrc/<name>.cu`` for its current sources."""
    stem = f"lib{name}-{_digest(name)}"
    return BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.ptxas.log"


def sources():
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names) -> None:
    """Compile every named source that is not built yet, one nvcc each, all
    started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib, _ = paths(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {_source(name)}:\n{out}")
            continue
        lib, log = paths(name)
        log.write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if it is not yet."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(paths(name)[0]))
        return _libs[name]


def function(name: str, entry: str, argtypes: Sequence) -> Any:
    """The C entry point ``entry`` of ``csrc/<name>.cu`` (returning a
    ``cudaError_t`` as int), its ``argtypes`` declared once.  ctypes keeps
    one function object a library, so declaring it on every call from
    several threads (the serving tier's background drains) would write
    shared state each launch."""
    key = (name, entry)
    fn = _functions.get(key)
    if fn is None:
        lib = load(name)
        with _lock:
            fn = _functions.get(key)
            if fn is None:
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
                _functions[key] = fn
    return fn


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each ``__global__`` in the ptxas log of
    ``csrc/<name>.cu``, keyed by kernel, semiring code and storage type
    (e.g. ``fw_update<0,float>``)."""
    _, log = paths(name)
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
        if m:
            current = kernel_key(m.group(1))
            out.setdefault(current, {"registers": -1, "spill_bytes": 0})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[current]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


_TEMPLATE_ARG = re.compile(r"Li(\d+)E|Lb([01])E|(f)|(13__nv_bfloat16)")


def kernel_key(mangled: str) -> str:
    """``_ZN11repro_torch9fw_updateILi0EfEEv...`` -> ``fw_update<0,float>``,
    ``..14minplus_argminILi2ELb1EEEv...`` -> ``minplus_argmin<2,true>``."""
    m = re.search(r"repro_torch(\d+)", mangled)
    if not m:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    if not rest.startswith("I"):
        return name
    args, pos = [], 1
    while pos < len(rest) and rest[pos] != "E":
        t = _TEMPLATE_ARG.match(rest, pos)
        if not t:
            return name
        num, flag, f32, bf16 = t.groups()
        args.append(num if num is not None else ("true" if flag == "1" else "false")
                    if flag is not None else "float" if f32 else "bf16")
        pos = t.end()
    return f"{name}<{','.join(args)}>"
