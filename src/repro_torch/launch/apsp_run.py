"""Distributed APSP runner of the PyTorch port, ported from
``repro.launch.apsp_run``: the paper's technique on a device mesh.

Generates a random cost matrix with the paper's generator (the same on
every rank, from ``--seed``), lays it over the mesh as a 2D block grid,
solves with the selected distributed method and, with ``--verify``,
checks it against the plain Floyd-Warshall loop (small sizes).

It starts ``prod(mesh)`` ranks itself on this host (``run_ranks``: spawned
processes joined by a ``FileStore`` in a temporary directory, no network),
each on ``--device``: rank r on ``cuda:(r % cards)``, or the CPU.  The
backend is NCCL where every rank has a card of its own, gloo otherwise
(NCCL refuses two ranks on one card; gloo stages each broadcast through
the host), unless ``--backend`` says otherwise.

    python -m repro_torch.launch.apsp_run --n 96 --method fw --mesh 2x2 \\
        --block-size 16 --verify [--device cpu]

``--mesh 2x16x16`` (three dimensions) is the multi-pod layout.
"""

from __future__ import annotations

import argparse
import math
import os
import queue
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["run_ranks", "default_backend", "main"]


def default_backend(world: int, device: str) -> str:
    """NCCL where each rank has a card of its own, gloo otherwise."""
    if torch.device(device).type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank: int, world: int, store: str, backend: str, device: str, timeout: float,
               fn: Callable, args: tuple, results) -> None:
    """One rank: join the process group, run ``fn(*args)``, report."""
    import torch.distributed as dist

    # Bind gloo's and NCCL's sockets to the loopback interface: the ranks
    # share this host and nothing else.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:                                  # the ranks share this host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
        try:
            out = fn(*args, device=str(dev))
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:                      # reported to the parent, which fails
        results.put((rank, "error", traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: Sequence = (), *, device: str = "cuda",
              backend: Optional[str] = None, timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args, device=...)`` on ``world`` spawned ranks of one process
    group; -> each rank's return value (picklable; keep tensors on the
    CPU), by rank.  ``fn`` must be importable by name.  A rank that raises,
    or a run past ``timeout`` seconds, stops every rank and raises here."""
    ctx = torch.multiprocessing.get_context("spawn")
    backend = backend or default_backend(world, device)
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro-torch-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, backend, device, timeout, fn, tuple(args),
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        deadline = time.monotonic() + timeout
        grace = 10.0
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    grace = 0.0
                    raise TimeoutError(f"{world} ranks ran past {timeout} s; "
                                       f"{sorted(out)} finished")
                try:
                    rank, status, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank exited with code {dead[0]} before "
                                           f"reporting")
                    continue
                if status != "ok":
                    grace = 0.0          # the others may wait on it in a collective
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            stop = time.monotonic() + grace
            for p in procs:
                p.join(timeout=max(0.0, stop - time.monotonic()))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]


def _fw_oracle(h: np.ndarray, sr_name: str) -> np.ndarray:
    """The plain Floyd-Warshall loop of the reference's ``--verify``."""
    add = {"tropical": np.minimum}.get(sr_name, np.maximum)
    mul = {"tropical": np.add, "reliability": np.multiply}.get(sr_name, np.minimum)
    d = h.copy()
    for k in range(h.shape[0]):
        d = add(d, mul(d[:, k][:, None], d[k, :][None, :]))
    return d


def solve_on_mesh(args: argparse.Namespace, *, device: str):
    """One rank's run: the graph, the mesh, the solve; rank 0 reports."""
    import torch.distributed as dist

    from repro_torch.core import generate_np, get_semiring
    from repro_torch.core.distributed import apsp_distributed
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import _recast_graph

    dims = tuple(int(x) for x in args.mesh.split("x"))
    multi_pod = len(dims) == 3
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = make_mesh(dims, axes, device=device)
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"[mesh] {mesh.shape} = {mesh.size} ranks, backend {dist.get_backend()}, "
              f"device {mesh.device}", flush=True)
    sr = get_semiring(args.semiring)
    g = generate_np(np.random.default_rng(args.seed), args.n, rho=args.rho)
    h = _recast_graph(g.h, sr.name)
    if rank0:
        print(f"[graph] N={g.n_nodes} edges={g.n_edges} density={g.density:.3f} "
              f"semiring={sr.name}", flush=True)
    t0 = time.time()
    out = apsp_distributed(torch.from_numpy(h), mesh=mesh, method=args.method,
                           multi_pod=multi_pod, block_size=args.block_size, semiring=sr)
    out = out.cpu().numpy()
    if not rank0:
        return None
    reach = float((~sr.is_zero(torch.from_numpy(out))).float().mean())
    print(f"[solve] method={args.method} wall={time.time() - t0:.2f}s "
          f"reachable-pairs={reach:.3f}", flush=True)
    if args.verify:
        ok = bool(np.allclose(out, _fw_oracle(h, sr.name), equal_nan=True))
        print(f"[verify] vs numpy FW oracle: {'OK' if ok else 'MISMATCH'}", flush=True)
        return ok
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--method", default="fw", choices=["squaring", "fw", "rkleene"])
    ap.add_argument("--mesh", default="4x2", help="e.g. 4x2, 16x16, 2x16x16")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--rho", type=float, default=50.0)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--semiring", default="tropical",
                    help="path semiring (see repro_torch.core.SEMIRINGS)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default cuda; cpu runs the plain path)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend (default: nccl where each rank has a card "
                         "of its own, else gloo)")
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("apsp_run: no CUDA device; pass --device cpu", file=sys.stderr)
            return 2
        from repro_torch.kernels import _build

        _build.build(_build.sources())     # once, before the ranks load it
    world = math.prod(int(x) for x in args.mesh.split("x"))
    ok = run_ranks(solve_on_mesh, world, (args,), device=args.device, backend=args.backend,
                   timeout=args.timeout)[0]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
