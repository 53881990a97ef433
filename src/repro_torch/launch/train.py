"""The training CLI of the PyTorch port, ported from ``repro.launch.train``:
data pipeline -> train step -> checkpoints, on the card unless
``--device cpu`` says otherwise.

Fault-tolerance features, as in the reference:
  * step-atomic background checkpoints (tmp+rename; ``CheckpointManager``)
  * auto-resume: on start, restore LATEST (params, opt state, data cursor);
    the checkpoint has the JAX package's keys, so a run of either package
    resumes the other's
  * straggler/hang mitigation: each step runs under a watchdog timeout; a
    step exceeding ``--step-timeout`` logs, checkpoints, and exits 75 so
    the scheduler can reschedule
  * deterministic data: stream position == step count, so restarts replay
    nothing and skip nothing

It runs the reduced smoke config of every trainable family: ``lm`` (the
five LMs, next-token loss on ``data.lm_batch_stream``), ``recsys`` (MIND,
the sampled softmax on ``data.mind_batch_stream``), ``gnn`` (gcn-cora,
gin-tu, pna) and ``nequip``, which trains on energy alone (the mean
squared error of the batch's molecule energies, as the reference's loss),
fed by ``data.molecule_batch_stream``.  ``apsp`` has no trainer.  Float32
matrix products run in full float32 (TF32 off), set explicitly.

Usage:
    python -m repro_torch.launch.train --arch gcn-cora --steps 200 \\
        --ckpt-dir /tmp/ckpt --ckpt-every 50 [--device cpu]
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch.checkpoint import CheckpointManager, load_checkpoint, restore_onto_mesh
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.configs import get_arch
from repro_torch.data import (
    lm_batch_stream,
    mind_batch_stream,
    molecule_batch_stream,
    synthetic_graph,
)
from repro_torch.models.gnn import init_gnn, loss_gnn
from repro_torch.models.mind import init_mind, mind_loss
from repro_torch.models.nequip import init_nequip, nequip_energy_batch
from repro_torch.models.transformer import init_lm
from repro_torch.models.transformer import loss_fn as lm_loss
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.train import init_train_state, make_train_step

__all__ = ["build_smoke_trainer", "nequip_loss", "Watchdog", "main"]


def build_smoke_trainer(arch_id: str, seed: int = 0, *, device="cuda"):
    """(loss_fn-bound train_step, init state, batch iterator) for the
    reduced config of a ported arch family, on ``device``."""
    arch = get_arch(arch_id)
    cfg = arch.smoke_config()
    opt = make_optimizer(arch.optimizer, warmup_cosine(arch.learning_rate, 20, 10_000))
    gen = torch.Generator().manual_seed(seed)
    if arch.family == "lm":
        params, _ = init_lm(torch.Generator(device=device).manual_seed(seed), cfg)
        step_fn = make_train_step(lambda p, b: lm_loss(p, b, cfg), opt)
        stream = lm_batch_stream(batch=8, seq_len=64, vocab=cfg.vocab, seed=seed)

        def batches():
            for b in stream:
                yield {k: torch.from_numpy(b[k]).to(device) for k in ("tokens", "labels")}
    elif arch.family == "recsys":
        params, _ = init_mind(torch.Generator(device=device).manual_seed(seed), cfg)
        step_fn = make_train_step(lambda p, b: mind_loss(p, b, cfg), opt)
        stream = mind_batch_stream(
            batch=32, n_items=cfg.n_items, hist_len=cfg.hist_len,
            n_profile_feats=cfg.n_profile_feats, profile_bag_len=cfg.profile_bag_len,
            n_interests=cfg.n_interests, n_negatives=cfg.n_negatives, seed=seed)

        def batches():
            for b in stream:
                yield {k: torch.from_numpy(v).to(device) for k, v in b.items() if k != "step"}
    elif arch.family == "gnn":
        params = init_gnn(gen, cfg, device=device)
        step_fn = make_train_step(lambda p, g: loss_gnn(p, g, cfg), opt)
        g = synthetic_graph(n_nodes=64, n_edges=256, d_feat=cfg.d_feat,
                            n_classes=cfg.n_classes, seed=seed)
        graph = {k: torch.from_numpy(v).to(device) for k, v in g.items()}

        def batches():
            while True:
                yield graph
    elif arch.family == "nequip":
        params = init_nequip(gen, cfg, device=device)
        step_fn = make_train_step(lambda p, b: nequip_loss(p, b, cfg), opt)
        stream = molecule_batch_stream(batch=4, n_atoms=8, n_edges=16,
                                       n_species=cfg.n_species, seed=seed)

        def batches():
            for b in stream:
                yield {k: torch.from_numpy(v).to(device) for k, v in b.items() if k != "step"}
    else:
        raise ValueError(f"no smoke trainer for family {arch.family}")

    state = init_train_state(params, opt)
    return step_fn, state, batches()


def nequip_loss(params, batch: dict, cfg):
    """Energy-only MSE over a batch of molecules -> (loss, {"loss"})."""
    e = nequip_energy_batch(params, batch, cfg)
    loss = torch.mean((e - batch["energy"]) ** 2)
    return loss, {"loss": loss}


class Watchdog:
    """SIGALRM-based per-step timeout (straggler/hang mitigation); the
    step runs on the main thread, where ``signal.setitimer`` works."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def __enter__(self):
        if self.seconds > 0:
            signal.signal(signal.SIGALRM, self._fire)
            signal.setitimer(signal.ITIMER_REAL, self.seconds)
        return self

    def _fire(self, *_):
        raise TimeoutError(f"step exceeded {self.seconds}s watchdog")

    def __exit__(self, *exc):
        if self.seconds > 0:
            signal.setitimer(signal.ITIMER_REAL, 0)
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--step-timeout", type=float, default=0.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs the plain path)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    step_fn, state, batches = build_smoke_trainer(args.arch, args.seed, device=args.device)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            flat, man = load_checkpoint(args.ckpt_dir, last)
            state = restore_onto_mesh(flat, state, device=args.device)
            start = int(man["extra"].get("data_step", last))
            print(f"[resume] restored step {last}, data cursor {start}")

    it = iter(batches)
    for _ in range(start):        # deterministic stream replay-free skip
        next(it)

    metrics = None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = next(it)
        try:
            with Watchdog(args.step_timeout):
                state, metrics = step_fn(state, batch)
                float(metrics["loss"])       # wait for the step's device work
        except TimeoutError as e:
            print(f"[straggler] {e}; checkpointing and exiting for reschedule")
            if mgr:
                mgr.save(step, state, extra={"data_step": step})
                mgr.wait()
            return 75                      # EX_TEMPFAIL: scheduler retries
        if (step + 1) % args.log_every == 0:
            dt = (time.time() - t0) / (step + 1 - start)
            print(f"step {step+1:5d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  {dt*1e3:.0f} ms/step")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state, extra={"data_step": step + 1})
    if mgr:
        mgr.save(args.steps, state, extra={"data_step": args.steps})
        mgr.wait()
    final = "n/a (no step run)" if metrics is None else f"{float(metrics['loss']):.4f}"
    print(f"[done] {args.steps} steps, final loss {final}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
