"""Mixed-workload serving driver: UFS schedules a live inference engine
(time-sensitive) against background training on the CUDA device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --requests 12 --policy ufs [--background-train] [--no-reduced] \
      [--device cpu]

Decode steps are CPU-bursty time-sensitive jobs; training steps of the
same architecture on weights of their own (``--background-train``) are the
background; application hints guard the cache-slot allocator.
``--reduced`` (the default) serves the tiny same-family config;
``--no-reduced`` serves the published widths and depth.
Every decoder family serves: dense (llama3.2-1b, qwen2-0.5b, stablelm-3b,
...), MoE (qwen2-moe-a2.7b), MLA with MoE (deepseek-v3-671b), xLSTM
(xlstm-350m), hybrid (hymba-1.5b) and the VLM backbone (internvl2-1b, text
only: the engine passes only tokens, as the reference's does).  The
encoder-decoder (seamless-m4t-medium) needs frames the engine does not
give, so ``serve`` stops on it with a plain error.  The background lane
trains through the port's trainer, so on the card it needs the families
whose kernels have a backward (dense attention).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_arch
from ..core import (KernelReport, Tier, build_kernel, percentile,
                    write_chrome_trace)
from ..core.live import LiveJob
from ..models.transformer import Model
from ..serving.engine import InferenceEngine, Request
from ..training import optimizer as opt
from ..training import trainer as T


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (--no-reduced: full width)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default="ufs")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--background-train", action="store_true")
    ap.add_argument("--slots", type=int, default=1)
    ap.add_argument("--kick-latency", type=float, default=0.0,
                    help="seconds before a kick takes effect (chunk-boundary "
                         "model; supported by both executor backends)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace JSON of the run (open at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--report-out", default=None,
                    help="write the KernelReport JSON to this path")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if cfg.encoder_layers:
        raise SystemExit(
            f"{cfg.name} is an encoder-decoder: its prefill needs stub audio "
            "frames, and the serving engine passes only tokens (as the "
            "reference's does); it is held at model level instead")
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    params = model.init_params(seed=0)

    kernel = build_kernel("live", policy=args.policy, n_slots=args.slots,
                          kick_latency=args.kick_latency,
                          trace=args.trace_out is not None)
    engine = InferenceEngine(model, params, kernel, max_batch=4, max_len=64)
    kernel.start()
    engine.start()

    if args.background_train:
        box = background_train(model, kernel)

    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
        reqs.append(engine.submit(Request(prompt=prompt,
                                          max_new_tokens=args.max_new_tokens)))
        time.sleep(0.05)

    deadline = time.monotonic() + 60
    for r in reqs:
        r.done_event.wait(timeout=max(0.0, deadline - time.monotonic()))
    engine.stop()
    time.sleep(0.1)
    kernel.stop()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)

    lats = [r.latency for r in reqs if r.ok]
    print(f"completed {len(lats)}/{len(reqs)} requests")
    if lats:
        print(f"latency mean {1e3*sum(lats)/len(lats):.1f} ms  "
              f"p95 {1e3*percentile(lats, 95):.1f} ms")
    if args.background_train:
        print(f"background train steps: {box['steps']}")
    print("engine", engine.stats.summary())
    report = KernelReport.from_kernel(kernel)
    print(report.pretty())
    if args.report_out:
        report.write(args.report_out)
        print(f"report written to {args.report_out}")
    if args.trace_out:
        n = write_chrome_trace(kernel.tracer.events, args.trace_out,
                               end=kernel.now)
        print(f"wrote {n} trace records to {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")


def background_train(model, kernel) -> dict:
    """Wake the background training lane on ``kernel``: AdamW steps at lr
    1e-3 on ``model``'s architecture from weights of its own (generator
    seeded 1), each on (2, 32) random tokens, as one background job that
    yields after every step.  Returns the lane's box: ``steps`` taken and
    their ``losses``."""
    cfg = model.cfg
    tmodel = Model(cfg, device=model.device)
    tcfg = T.TrainConfig(opt=opt.OptimizerConfig(lr=1e-3))
    gen = torch.Generator(device=tmodel.device).manual_seed(1)
    tstep = T.make_train_step(tmodel, tcfg)
    box = {"state": T.init_state(tmodel, tcfg, gen), "steps": 0, "losses": []}
    rng = np.random.default_rng(1)
    bg = kernel.create_group("train", Tier.BACKGROUND, 1.0)

    def train_chunk(budget):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 32)),
                               dtype=torch.int32, device=tmodel.device)
        box["state"], m = tstep(box["state"], {"tokens": toks, "labels": toks})
        box["losses"].append(float(m["loss"]))     # waits for the step
        box["steps"] += 1
        return "yield"

    kernel.wake(LiveJob(bg, train_chunk, name="bg-train", kind="bound"))
    return box


if __name__ == "__main__":
    main()
