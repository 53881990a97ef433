"""Serving driver of the PyTorch port, ported from ``repro.launch.serve``:
a batched request loop over prefill + greedy decode (LM), interest
extraction + retrieval (MIND), batched APSP over a stream of graph
requests, and incremental APSP on the supervised engine pool.

The LM mode (``--arch`` one of the five LMs) serves the arch's smoke
config: batches of up to 4 prompts of 16 tokens through ``prefill``, then
``--gen`` greedy ``decode_step``s each against the KV cache.  The MIND
mode (``--arch mind``) computes ``--requests`` users' interests and one
user's top 10 of the whole item table.

The batched mode packs incoming ragged graphs into (G, N_max, N_max)
inf-padded slots (padding is inert under (min, +)) and solves each cycle
with one ``solve_batch`` call on the card; results are unpadded per graph.
With ``--mutate-rate > 0`` it switches to the incremental shape: a
supervised pool (``repro_torch.launch.pool``) of persistent
``DynamicAPSP`` engines serving an interleaved stream of edge-update
batches (queued, coalesced, applied without a full re-solve) and distance
queries (live under a deadline, or bounded-staleness snapshot answers).
``--fault-spec`` turns on the deterministic chaos layer
(``repro_torch.launch.faults``); the run exits non-zero on verify drift, a
poisoned answer, or an unrecovered slot.

Everything runs on ``--device`` (``cuda`` unless told otherwise; ``cpu``
runs the kernels' plain versions).

Usage:
    python -m repro_torch.launch.serve --arch qwen2-1.5b --requests 4 --gen 16
    python -m repro_torch.launch.serve --arch mind --requests 8
    python -m repro_torch.launch.serve --arch apsp --requests 64 --batch 16 \\
        --n-max 1024 --method blocked_fw
    python -m repro_torch.launch.serve --arch apsp --requests 64 --n-max 8192 \\
        --mutate-rate 0.5 --graphs 4 --verify-every 16
    python -m repro_torch.launch.serve --arch apsp --device cpu --requests 128 \\
        --n-max 64 --mutate-rate 0.5 --graphs 3 --verify-every 16 \\
        --fault-spec nan:0.1,crash:0.08:3,poison:0.05 --deadline-ms 50
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core.semiring import default_device


def serve_lm(arch_id: str, n_requests: int, gen_len: int, seed: int = 0, *,
             device="cuda") -> int:
    """Prefill + greedy decode over batches of random prompts, the arch's
    smoke config with weights drawn from ``seed`` on ``device``."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import decode_step, init_lm, prefill

    cfg = get_arch(arch_id).smoke_config()
    params, _ = init_lm(torch.Generator(device=device).manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    batch = max(2, min(4, n_requests))
    prompt_len, max_len = 16, 16 + gen_len
    done = 0
    t0 = time.time()
    with torch.no_grad():
        while done < n_requests:
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, prompt_len))).to(device)
            logits, cache = prefill(params, toks, cfg, max_len)
            out = [torch.argmax(logits, -1)[:, None]]
            for _ in range(gen_len - 1):
                lg, cache = decode_step(params, cache, out[-1], cfg)
                out.append(torch.argmax(lg, -1)[:, None])
            gen = torch.cat(out, dim=1)
            assert gen.shape == (batch, gen_len)
            assert not bool(torch.isnan(lg).any())
            done += batch
            print(f"[serve] batch of {batch}: prompt {prompt_len} -> +{gen_len} tokens "
                  f"(sample: {gen[0, :8].tolist()})")
    dt = time.time() - t0
    print(f"[done] {done} requests, {done * gen_len / dt:.1f} tok/s (smoke config on {device})")
    return 0


def serve_mind(n_requests: int, seed: int = 0, *, device="cuda") -> int:
    """``n_requests`` users' interests, then one user's top 10 of every
    item, MIND's smoke config."""
    from repro_torch.configs import get_arch
    from repro_torch.data import mind_batch_stream
    from repro_torch.models.mind import init_mind, retrieval_scores, serve_user

    cfg = get_arch("mind").smoke_config()
    params, _ = init_mind(torch.Generator(device=device).manual_seed(seed), cfg)
    stream = mind_batch_stream(
        batch=n_requests, n_items=cfg.n_items, hist_len=cfg.hist_len,
        n_profile_feats=cfg.n_profile_feats, profile_bag_len=cfg.profile_bag_len,
        n_interests=cfg.n_interests, n_negatives=cfg.n_negatives, seed=seed)
    batch = {k: torch.from_numpy(v).to(device) for k, v in next(stream).items() if k != "step"}
    with torch.no_grad():
        interests = serve_user(params, batch, cfg)
        print(f"[serve] {n_requests} users -> interests {tuple(interests.shape)}")
        one = {k: v[:1] for k, v in batch.items()}
        one["cand_ids"] = torch.arange(cfg.n_items, dtype=torch.int32, device=device)
        _, ids = retrieval_scores(params, one, cfg, top_k=10)
    print(f"[retrieval] top-10 of {cfg.n_items}: ids={ids.tolist()}")
    return 0

#: semirings the synthetic tropical request stream can be recast into.
RECASTABLE = ("tropical", "bottleneck", "reliability", "boolean")


def _recast_graph(h: np.ndarray, semiring: str) -> np.ndarray:
    """Recast a tropical cost matrix into another semiring's domain, keeping
    the same edge structure: no-edge -> semiring zero, diagonal -> one,
    costs -> capacities (bottleneck), probabilities 1/(1+cost)
    (reliability), or 1.0 (boolean).  Arithmetic runs on the edge mask only
    (the inf no-edge entries would raise numpy warnings)."""
    if semiring == "tropical":
        return h
    _check_recastable(semiring)
    edge = np.isfinite(h) & ~np.eye(h.shape[0], dtype=bool)
    if semiring == "bottleneck":
        out = np.full(h.shape, -np.inf, np.float32)
        out[edge] = h[edge]
        np.fill_diagonal(out, np.inf)
    elif semiring == "reliability":
        out = np.zeros(h.shape, np.float32)
        out[edge] = 1.0 / (1.0 + h[edge])
        np.fill_diagonal(out, 1.0)
    else:  # boolean (guarded by _check_recastable)
        out = np.zeros(h.shape, np.float32)
        out[edge] = 1.0
        np.fill_diagonal(out, 1.0)
    return out


def _check_recastable(semiring: str) -> None:
    """Fail fast (before any serving work) for semirings the synthetic
    request stream has no domain mapping for."""
    if semiring not in RECASTABLE:
        raise ValueError(
            f"--semiring {semiring!r} has no request-recast rule: the serve "
            "loop generates tropical cost matrices and only maps them into "
            f"the built-in instances {RECASTABLE}.  Serve a custom "
            "registered semiring by feeding repro_torch.solve_batch requests "
            "already expressed in that instance's domain."
        )


def _recast_edge_weights(w: np.ndarray, semiring: str) -> np.ndarray:
    """Per-edge analogue of :func:`_recast_graph` for streamed update
    weights (the engine classifies each batch itself, so results stay
    exact; only the update/re-solve mix shifts)."""
    if semiring == "bottleneck":
        return w
    if semiring == "reliability":
        return (1.0 / (1.0 + w)).astype(np.float32)
    return np.ones_like(w)  # boolean


def _device(device) -> torch.device:
    """Where the run goes: ``device``, the card when none is given.  A run
    asked onto the card on a host without one fails here, before any work,
    and says how to run on the CPU."""
    dev = torch.device(default_device(device))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this host has no CUDA device: pass --device cpu (device='cpu') to "
            "serve on the kernels' plain versions"
        )
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_autotune(method: str, n_max: int, batch: int, *, semiring: str = "tropical",
                  device=None):
    """Warm the autotune cache for the shapes ``method``'s dispatch looks
    up, before the first solve, as the JAX server does: ``blocked_fw`` its
    round shape (``tune_fw_round``: block size x fused or split), then the
    three panel products of that block (``tune_blocked_fw``, batched, so
    g-bucketed keys); ``squaring`` and ``squaring_3d`` the N^3 product
    (their per-slice products dispatch as 2-D); ``rkleene`` the quadrant
    products of every edge along the ``split_point`` chain below the root
    (the root edge is never a product operand); ``classic`` nothing.
    Prints one ``[autotune] dispatch warm ...`` line with each source and
    returns the sources (None when autotuning is off)."""
    from repro_torch.kernels import autotune

    if autotune.mode() == "off":
        return None
    t_tune = time.time()
    src = "nothing to tune"
    if method == "blocked_fw":
        e = autotune.tune_fw_round(n_max, reps=1, semiring=semiring, device=device)
        b = e.get("params", {}).get("block_size", 256)
        tuned = autotune.tune_blocked_fw(n_max, b, g=batch, reps=1, semiring=semiring,
                                         device=device)
        src = {"fw_round": e.get("source"), **{k: e2.get("source") for k, e2 in tuned.items()}}
    elif method in ("squaring", "squaring_3d"):
        src = autotune.tune(n_max, n_max, n_max, reps=1, semiring=semiring,
                            device=device).get("source")
    elif method == "rkleene":
        import importlib

        # the module (``repro_torch.core.rkleene`` is bound to the solver)
        rk = importlib.import_module("repro_torch.core.rkleene")
        srcs, seen = [], set()
        root = rk.padded_size(n_max, 64)
        stack = [rk.split_point(root, 64), root - rk.split_point(root, 64)] if root > 64 else []
        while stack:
            e = stack.pop()
            if e <= 64 or e in seen:
                continue
            seen.add(e)
            srcs.append(autotune.tune(e, e, e, reps=1, semiring=semiring,
                                      device=device).get("source"))
            m = rk.split_point(e, 64)
            stack += [m, e - m]
        src = srcs or "leaf-only (closure kernel)"
    print(f"[autotune] dispatch warm for n_max={n_max} ({src}, {time.time() - t_tune:.2f}s)")
    return src


def serve_apsp(
    n_requests: int,
    *,
    batch: int = 16,
    n_max: int = 128,
    method: str = "squaring",
    with_pred: bool = False,
    semiring: str = "tropical",
    seed: int = 0,
    device=None,
    summary_out: dict = None,
) -> int:
    """Continuous-batched APSP serving over a synthetic graph-request stream.

    Requests are ragged (sizes ~ U[4, n_max]); each cycle fills ``batch``
    slots, pads into the (batch, n_max, n_max) buffer and runs one batched
    solve.  The first cycle pays the kernels' first build (reported as
    "first cycle"); every later one reuses them.  ``semiring`` serves any
    built-in instance from the same loop (the stream is recast into its
    domain).  Before the first cycle the server warms the autotune cache
    for the shapes its method's dispatch looks up (:func:`warm_autotune`),
    which the solves then read from the cache.  ``summary_out``, when
    given, receives the run's graphs/s and timings.
    """
    from repro_torch.core import get_semiring, solve_batch
    from repro_torch.core.graphgen import generate_np

    _check_recastable(semiring)
    dev = _device(device)
    warm_autotune(method, n_max, batch, semiring=semiring, device=dev)

    rng = np.random.default_rng(seed)
    sr = get_semiring(semiring)
    done = 0
    t0 = time.time()
    t_first = None
    while done < n_requests:
        sizes = rng.integers(4, n_max + 1, size=batch)
        graphs = [generate_np(rng, int(n)) for n in sizes]
        res = solve_batch(
            [_recast_graph(g.h, sr.name) for g in graphs], method=method,
            with_pred=with_pred, n_max=n_max, semiring=sr, device=dev,
        )
        _sync(dev)
        if t_first is None:
            t_first = time.time() - t0
        reach = [int((~sr.is_zero(res.unpadded(i).dist)).sum())
                 for i in range(min(2, batch))]
        done += batch
        print(f"[serve] batch of {batch} graphs (sizes {sizes.min()}-{sizes.max()}) "
              f"-> dist {tuple(res.dist.shape)} (reachable entries sample: {reach})")
    dt = max(time.time() - t0, 1e-9)   # two clock reads may be equal
    msg = f"[done] {done} graphs, {done / dt:.1f} graphs/s end-to-end"
    if t_first is not None:
        if done > batch:               # steady state needs a cycle after the first
            steady = max(dt - t_first, 1e-9)
            msg += f" ({(done - batch) / steady:.1f} graphs/s steady-state)"
        msg += f" (first cycle {t_first:.2f}s, method={method}, device={dev})"
    print(msg)
    if summary_out is not None:
        steady = (done - batch) / max(dt - t_first, 1e-9) if done > batch else None
        summary_out.update(graphs=done, seconds=dt, first_cycle_s=t_first,
                           graphs_per_s=done / dt, steady_graphs_per_s=steady)
    return 0


def serve_apsp_dynamic(
    n_requests: int,
    *,
    n_max: int = 128,
    graphs: int = 4,
    mutate_rate: float = 0.5,
    mutate_k: int = 8,
    method: str = "blocked_fw",
    with_pred: bool = False,
    semiring: str = "tropical",
    verify_every: int = 0,
    seed: int = 0,
    fault_spec: str = "",
    deadline_ms: float = 0.0,
    mem_budget_mb: float = 0.0,
    backlog_watermark: int = 8,
    max_retries: int = 2,
    async_updates: bool = False,
    executor_workers: int = 1,
    reader_workers: int = 0,
    durability_dir: str = "",
    checkpoint_every: int = 0,
    device=None,
    summary_out: dict = None,
) -> int:
    """Incremental APSP serving on the supervised engine pool.

    Every persistent graph lives behind a health-checked
    :class:`repro_torch.launch.pool.EngineSlot`.  The interleaved request
    stream: with probability ``mutate_rate`` a request is a batch of up to
    ``mutate_k`` edge updates *queued* against a slot (coalesced into one
    rank-k dispatch at drain); otherwise it is a distance query served live
    under ``deadline_ms`` — or, when the slot is unhealthy / the backlog
    exceeds ``backlog_watermark`` / the deadline is missed, a
    bounded-staleness answer from the last-known-good snapshot with an
    explicit staleness tag.  ``verify_every`` > 0 checks a slot against a
    cold solve every that-many requests; drift degrades the slot, triggers
    re-solve-on-drift, and fails the run.

    ``fault_spec`` turns on the deterministic chaos layer.  The exit code
    asserts the resilience contract: zero poisoned answers served, no
    unrecovered drift, and every slot back to healthy (or deliberately
    evicted under the memory budget) at the end of the run.

    ``async_updates`` moves drains onto the background executor
    (``executor_workers`` threads); ``durability_dir`` (``"auto"`` = a
    fresh temp dir) gives every slot a write-ahead journal + atomic
    checkpoints every ``checkpoint_every`` drains; ``reader_workers`` sizes
    the sync-path deadline readers (0 = one per slot).  ``summary_out``,
    when given, receives the pool's summary and the run's timings.
    """
    import json
    import tempfile

    from repro_torch.core import get_semiring
    from repro_torch.core.graphgen import generate_edge_updates, generate_np
    from repro_torch.launch.faults import FaultInjector, FaultSpec
    from repro_torch.launch.pool import EnginePool, SlotState

    _check_recastable(semiring)
    sr = get_semiring(semiring)
    dev = _device(device)
    spec = FaultSpec.parse(fault_spec)
    if durability_dir == "auto":
        durability_dir = tempfile.mkdtemp(prefix="repro-torch-serve-dur-")
        print(f"[durability] journal + checkpoints under {durability_dir}")
    if spec.crash_restore > 0 and not durability_dir:
        raise ValueError(
            "crash_restore chaos needs --durability-dir (the drill restores "
            "from checkpoint + journal; pass 'auto' for a temp dir)"
        )
    pool = EnginePool(
        method=method, with_pred=with_pred, semiring=sr,
        max_retries=max_retries, deadline_s=deadline_ms / 1e3,
        mem_budget_bytes=int(mem_budget_mb * 2**20),
        backlog_watermark=backlog_watermark,
        injector=FaultInjector(spec, seed=seed), seed=seed,
        async_updates=async_updates, executor_workers=executor_workers,
        reader_workers=reader_workers,
        durability_dir=durability_dir or None,
        checkpoint_every=checkpoint_every, device=dev,
    )
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for gid in range(graphs):
        g = generate_np(rng, n_max, rho=60.0)
        pool.admit(gid, _recast_graph(g.h, sr.name))
    t_warm = time.time() - t0
    print(f"[dynamic] {graphs} supervised slots of n={n_max} warmed on {dev} "
          f"({t_warm:.2f}s incl. the kernels' first build; states {pool.state_counts()})")
    if spec.any():
        print(f"[chaos] fault spec active: {fault_spec} (seed {seed})")

    n_updates = n_queries = 0
    t_update = t_query = 0.0
    drift_reports = []
    t0 = time.time()
    for req in range(n_requests):
        gi = int(rng.integers(0, graphs))
        slot = pool.slots[gi]
        if rng.uniform() < mutate_rate:
            # mostly decreases/inserts (the fast exact path), a sprinkle of
            # worsenings (exercises the bounded re-solve)
            u, v, w = generate_edge_updates(
                rng, slot.engine.h if slot.engine is not None else slot._h,
                int(rng.integers(1, mutate_k + 1)), worsen_frac=0.05,
            )
            if semiring != "tropical":
                w = _recast_edge_weights(w, semiring)
            t = time.time()
            pool.submit_update(gi, u, v, w)
            if pool.backlog() > pool.backlog_watermark:
                # saturated: drain the queues (coalesced) so admission
                # control sheds at most a bounded query window
                pool.drain_all()
            t_update += time.time() - t
            n_updates += 1
            if req < 3 or req % max(n_requests // 4, 1) == 0:
                print(f"[mutate] slot {gi}: queued {u.size} edges "
                      f"(backlog {pool.backlog()}, state {slot.state}, "
                      f"req {req})")
        else:
            qi = rng.integers(0, n_max, 8)
            qj = rng.integers(0, n_max, 8)
            t = time.time()
            r = pool.query(gi, qi, qj)
            t_query += time.time() - t
            n_queries += 1
            if r.values.shape != (8,):
                raise RuntimeError(f"query answered {r.values.shape}, not (8,)")
            if r.source != "live" and (req < 3 or req % max(n_requests // 4, 1) == 0):
                print(f"[degraded] slot {gi}: {r.source} answer, staleness "
                      f"{r.staleness} (shed={r.shed} "
                      f"deadline_missed={r.deadline_missed}, req {req})")
        if verify_every and (req + 1) % verify_every == 0:
            report = pool.verify(gi)
            print(f"[verify] slot {gi} vs cold solve: "
                  f"{'OK' if report['ok'] else 'DRIFT'}"
                  + ("" if report["ok"] else f" (recovered={report['recovered']})"))
            if not report["ok"]:
                drift_reports.append(report)
    dt = time.time() - t0
    pool.recover_all(readmit=True)

    summary = pool.summary()
    ms_update = 1e3 * t_update / max(n_updates, 1)
    ms_query = 1e3 * t_query / max(n_queries, 1)
    print(f"[done] {n_requests} requests in {dt:.2f}s — "
          f"{n_updates} update batches ({ms_update:.1f} ms/submit+drain), "
          f"{n_queries} queries ({ms_query:.2f} ms/query)")
    print(f"[pool] {json.dumps(summary, sort_keys=True, default=str)}")
    if summary_out is not None:
        summary_out.update(summary=summary, seconds=dt, warm_s=t_warm,
                           engine_stats={gid: dict(s.engine.stats)
                                         for gid, s in pool.slots.items()
                                         if s.engine is not None},
                           n_updates=n_updates, n_queries=n_queries,
                           ms_per_submit_drain=ms_update, ms_per_query=ms_query,
                           verify_drift=len(drift_reports))
    pool.close()

    # resilience contract: structured failure summary + non-zero exit
    states = summary["states"]
    unrecovered = states[SlotState.DEGRADED] + states[SlotState.QUARANTINED]
    failures = {}
    if drift_reports:
        failures["verify_drift"] = drift_reports
    if summary["pool"]["poisoned_served"]:
        failures["poisoned_served"] = summary["pool"]["poisoned_served"]
    if unrecovered:
        failures["unrecovered_slots"] = {
            gid: s.state for gid, s in pool.slots.items()
            if s.state in (SlotState.DEGRADED, SlotState.QUARANTINED)
        }
    if failures:
        print(f"[serve-error] {json.dumps(failures, sort_keys=True, default=str)}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="'apsp', 'mind' or one of the LM archs (repro_torch.configs)")
    ap.add_argument("--device", default="cuda",
                    help="where the models, solves and engines run: 'cuda' (the "
                         "kernels) or 'cpu' (their plain versions)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16,
                    help="LM mode: tokens generated a request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16,
                    help="graph slots per serving cycle")
    ap.add_argument("--n-max", type=int, default=128,
                    help="padded graph edge")
    ap.add_argument("--method", default="squaring",
                    help="solver (see repro_torch.METHODS)")
    ap.add_argument("--with-pred", action="store_true",
                    help="also compute predecessor matrices")
    ap.add_argument("--semiring", default="tropical",
                    help="path semiring (see repro_torch.SEMIRINGS)")
    ap.add_argument("--mutate-rate", type=float, default=0.0,
                    help="fraction of requests that are edge-update batches "
                         "against persistent graph state (> 0 selects the "
                         "incremental DynamicAPSP serving mode)")
    ap.add_argument("--graphs", type=int, default=4,
                    help="dynamic mode: persistent graph count")
    ap.add_argument("--mutate-k", type=int, default=8,
                    help="dynamic mode: max edges per update batch")
    ap.add_argument("--verify-every", type=int, default=0,
                    help="dynamic mode: check an engine against a cold solve "
                         "every N requests (0 = off; drift exits non-zero)")
    ap.add_argument("--fault-spec", default="",
                    help="dynamic mode: chaos layer, e.g. "
                         "'nan:0.1,crash:0.08:3,latency:0.1:20,poison:0.05,"
                         "mem:0.1:0.5' (see repro_torch.launch.faults)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="dynamic mode: per-query deadline; a miss is answered "
                         "from the last-known-good snapshot (0 = off)")
    ap.add_argument("--mem-budget-mb", type=float, default=0.0,
                    help="dynamic mode: device-state budget; admissions beyond "
                         "it evict LRU slots (0 = unlimited)")
    ap.add_argument("--backlog-watermark", type=int, default=8,
                    help="dynamic mode: pending update batches above which "
                         "queries are shed to snapshots")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="dynamic mode: transient apply failures retried (with "
                         "backoff) before quarantine")
    ap.add_argument("--async-updates", action="store_true",
                    help="dynamic mode: apply update batches on the background "
                         "executor; queries read published snapshots")
    ap.add_argument("--executor-workers", type=int, default=1,
                    help="dynamic mode: background drain threads (with "
                         "--async-updates)")
    ap.add_argument("--reader-workers", type=int, default=0,
                    help="dynamic mode: deadline-reader sizing for the sync "
                         "path (0 = one dedicated worker per slot)")
    ap.add_argument("--durability-dir", default="",
                    help="dynamic mode: per-slot write-ahead journal + atomic "
                         "engine checkpoints under this directory ('auto' = "
                         "fresh temp dir); required by the crash_restore drill")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="dynamic mode: checkpoint a durable slot every N "
                         "successful drains (0 = only the build-time checkpoint)")
    args = ap.parse_args(argv)
    if args.arch == "mind":
        return serve_mind(args.requests, args.seed, device=args.device)
    if args.arch != "apsp":
        return serve_lm(args.arch, args.requests, args.gen, args.seed, device=args.device)
    if args.mutate_rate > 0.0:
        return serve_apsp_dynamic(
            args.requests, n_max=args.n_max, graphs=args.graphs,
            mutate_rate=args.mutate_rate, mutate_k=args.mutate_k,
            method=args.method, with_pred=args.with_pred,
            semiring=args.semiring, verify_every=args.verify_every,
            seed=args.seed, fault_spec=args.fault_spec,
            deadline_ms=args.deadline_ms, mem_budget_mb=args.mem_budget_mb,
            backlog_watermark=args.backlog_watermark,
            max_retries=args.max_retries, async_updates=args.async_updates,
            executor_workers=args.executor_workers,
            reader_workers=args.reader_workers,
            durability_dir=args.durability_dir,
            checkpoint_every=args.checkpoint_every, device=args.device,
        )
    return serve_apsp(
        args.requests, batch=args.batch, n_max=args.n_max, method=args.method,
        with_pred=args.with_pred, semiring=args.semiring, seed=args.seed,
        device=args.device,
    )


if __name__ == "__main__":
    sys.exit(main())
