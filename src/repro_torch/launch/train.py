"""End-to-end training driver on the CUDA device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt [--reduced --device cpu]

The reference package's CLI, plus ``--device`` (default ``cuda``; the CPU
runs the kernels' plain versions).  ``--reduced`` takes the tiny
same-family config; ``--n-layers`` cuts the depth and keeps the widths.
Fault tolerance: periodic checkpoints with atomic
commit, in the reference's on-disk format; ``--resume`` restores the
latest valid one (also after a simulated ``--fail-at`` crash).

``--scheduled`` runs the loop through the scheduling core: the train steps
are a time-sensitive job on a ``LiveKernel`` slot and each checkpoint save
a background job on the same slot, so saves only use slack and never delay
a step.  A save job holds the state of its step: every train step builds a
new state and never writes the old one, so that state is still step N's
when the save runs, after later steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import torch

from ..configs.base import get_arch
from ..data.pipeline import SyntheticTokens
from ..models.transformer import Model
from ..models.weights import tree_leaves
from ..training import optimizer as opt
from ..training import trainer as T
from ..training.checkpoint import CheckpointManager


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="keep this many layers (default: the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate a crash after N steps (fault-tolerance demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--scheduled", action="store_true",
                    help="run the loop under a LiveKernel: steps are a "
                         "time-sensitive job, checkpoint saves background jobs")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as ``args`` say.  Returns ``{"losses": {step: loss}, "state",
    "failed_at": the step of a simulated crash or None, "start_step"}``."""
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = Model(cfg, device=args.device)
    tcfg = T.TrainConfig(
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
        opt=opt.OptimizerConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                                total_steps=args.steps))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    state = T.init_state(model, tcfg, gen)
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params:,} device={model.device}",
          flush=True)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        # Scheduled mode replaces the ad-hoc save thread with background
        # jobs, so the save itself is the unit of scheduled work.
        mgr = CheckpointManager(args.ckpt_dir, keep_n=3,
                                async_save=not args.scheduled)
        if args.resume:
            got = mgr.restore_latest(state)
            if got[0] is not None:
                start_step, state = got
                print(f"resumed from checkpoint step {start_step}")

    step_fn = T.make_train_step(model, tcfg)
    src = SyntheticTokens(cfg.vocab_size, seed=args.seed)

    def make_batch(step: int) -> dict:
        raw = src.batch(step, 0, args.batch, args.seq)
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in raw.items()}
        if cfg.encoder_layers:
            batch["frames"] = torch.zeros(
                (args.batch, cfg.encoder_len, cfg.d_model), device=model.device)
        if cfg.vision_tokens:
            batch["vision_embeds"] = torch.zeros(
                (args.batch, cfg.vision_tokens, cfg.d_model), device=model.device)
        return batch

    out = {"losses": {}, "failed_at": None, "start_step": start_step}
    t0 = time.time()

    def one_step(state, step: int):
        state, metrics = step_fn(state, make_batch(step))
        loss = float(metrics["loss"])
        out["losses"][step + 1] = loss
        if (step + 1) % args.log_every == 0 or step == start_step:
            rate = (step + 1 - start_step) * args.batch * args.seq / (time.time() - t0)
            print(f"step {step+1:5d} loss {loss:7.4f} "
                  f"lr {float(metrics['lr']):.2e} tok/s {rate:,.0f}",
                  flush=True)
        return state

    if args.scheduled:
        state = _run_scheduled(args, state, start_step, one_step, mgr, out)
    else:
        for step in range(start_step, args.steps):
            state = one_step(state, step)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state)
            if args.fail_at is not None and step + 1 >= args.fail_at:
                out["failed_at"] = step + 1
                break
    if mgr:
        if out["failed_at"] is None:
            mgr.save(args.steps, state)
        mgr.wait()
    out["state"] = state
    return out


def _run_scheduled(args, state, start_step, one_step, mgr, out):
    """Drive the training loop through the scheduling core.

    One LiveKernel slot, UFS policy: the step loop is a time-sensitive job
    (one chunk = one step), each checkpoint save a background-tier job on
    the same slot.  Saves therefore run only in the slack between steps --
    the paper's mixed-workload story applied to the training driver itself.
    """
    from ..core import KernelReport, Tier, build_kernel
    from ..core.live import LiveJob

    kernel = build_kernel("live", policy="ufs", n_slots=1)
    train_g = kernel.create_group("train", Tier.TIME_SENSITIVE, 10_000.0)
    ckpt_g = kernel.create_group("ckpt", Tier.BACKGROUND, 1.0)
    box = {"state": state, "step": start_step, "saves_queued": 0,
           "saves_done": 0}
    done = threading.Event()

    def save_chunk(step: int, snap) -> str:
        mgr.save(step, snap)
        box["saves_done"] += 1
        return "done"

    def train_chunk(budget: float) -> str:
        step = box["step"]
        if step >= args.steps:
            done.set()
            return "done"
        box["state"] = one_step(box["state"], step)
        box["step"] = step + 1
        if mgr and (step + 1) % args.ckpt_every == 0:
            snap = box["state"]      # step N's state: later steps build new ones
            box["saves_queued"] += 1
            kernel.wake(LiveJob(ckpt_g,
                                lambda budget, s=step + 1, st=snap: save_chunk(s, st),
                                name=f"ckpt-{step+1}", kind="bound"))
        if args.fail_at is not None and step + 1 >= args.fail_at:
            out["failed_at"] = step + 1
            done.set()
            return "done"
        return "yield"

    kernel.start()
    kernel.wake(LiveJob(train_g, train_chunk, name="train-loop", kind="bound"))
    done.wait()
    # Under UFS a 1-slot kernel gives background saves no slack while steps
    # are queued; drain queued saves (now pure slack) before stopping.
    deadline = time.monotonic() + 120.0
    while box["saves_done"] < box["saves_queued"] and time.monotonic() < deadline:
        time.sleep(0.01)
    kernel.stop()
    print(KernelReport.from_kernel(kernel).pretty())
    if box["saves_done"] < box["saves_queued"]:
        raise RuntimeError(f"{box['saves_queued'] - box['saves_done']} "
                           "checkpoint saves did not finish")
    return box["state"]


def main(argv=None) -> None:
    out = run(parse_args(argv))
    if out["failed_at"] is not None:
        raise SystemExit(f"simulated failure at step {out['failed_at']} "
                         f"(restart with --resume)")
    print("done")


if __name__ == "__main__":
    main()
