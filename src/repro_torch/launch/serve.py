"""Mixed-workload serving driver: UFS schedules a live inference engine on
the CUDA device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --requests 12 --policy ufs [--no-reduced] [--device cpu]

Decode steps are CPU-bursty time-sensitive jobs; application hints guard
the cache-slot allocator.  ``--reduced`` (the default) serves the tiny
same-family config; ``--no-reduced`` serves the published widths and depth.
Every decoder family serves: dense (llama3.2-1b, qwen2-0.5b, stablelm-3b,
...), MoE (qwen2-moe-a2.7b), MLA with MoE (deepseek-v3-671b), xLSTM
(xlstm-350m), hybrid (hymba-1.5b) and the VLM backbone (internvl2-1b, text
only: the engine passes only tokens, as the reference's does).  The
encoder-decoder (seamless-m4t-medium) needs frames the engine does not
give, so ``serve`` stops on it with a plain error.  The background
training lane of the reference's ``serve`` waits for the trainer's port
(ROADMAP.md).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import get_arch
from ..core import KernelReport, build_kernel, percentile, write_chrome_trace
from ..models.transformer import Model
from ..serving.engine import InferenceEngine, Request


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


if __name__ == "__main__":
    main()
