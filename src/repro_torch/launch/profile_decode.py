"""Where a serving decode step spends its time on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode [--arch NAME]
      [--n-layers N]

Builds the model (``--arch``, default llama3.2-1b) at its published widths
and depth (``--n-layers`` cuts the depth: deepseek-v3-671b does not fit on
one card, and 5 of its 61 layers, its 3 dense layers and 2 MoE layers, are
what ``chip_smoke.py`` serves) in bfloat16 with random weights (seed 0) and
random caches at the
serving engine's largest batch (8 rows, 1024 positions, 700 live for
attention caches, the ring of a sliding window included; random recurrent
states for xLSTM and hymba's SSD heads), then times
``decode_step``, ``prefill_batch`` (8 prompts of 256 tokens) and the bulk
prefill (``prefill`` of one 500-token prompt, as the engine runs a
background request) as the engine calls them: host wall time per call (ending in a synchronize), and a
``torch.profiler`` window that gives the device's busy share and the
device time by kernel (the 40 largest).  MoE layers run at the reference's
default capacity factors (1.25 for prefill, 2.0 for decode).  An
encoder-decoder's prefills get stub frames and its cache random encoder
K/V, both from a seed.  Prints one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs.base import get_arch
from ..models.transformer import Model
from ..models.weights import tree_leaves


def _wall_ms(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _device_table(prof, n_calls: int, wall_ms: float, top: int) -> dict:
    """Device time by kernel name per call, and the device's busy share of
    the profiled window (kernels on one stream do not overlap)."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:     # host ops: their kernels
            continue                               # are counted as themselves
        rows.append((evt.self_device_time_total, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3 / n_calls
    return {
        "device_busy_ms_per_call": busy_ms,
        "wall_ms_per_call": wall_ms,
        "device_busy_share": busy_ms / wall_ms,
        "top_kernels": [{"name": k[:90], "ms_per_call": us / 1e3 / n_calls,
                         "launches_per_call": c / n_calls}
                        for us, c, k in rows[:top]],
        "device_launches_per_call": sum(r[1] for r in rows) / n_calls,
    }


BATCH, MAX_LEN, LIVE, PROMPT_LEN, BULK_LEN = 8, 1024, 700, 256, 500
ITERS, TOP = 20, 40


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="keep this many decoder layers (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode measures the CUDA device; none found")

    cfg = get_arch(args.arch)
    if args.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    model = Model(cfg, device="cuda")
    params = model.init_params(seed=0)
    caches = model.init_cache(BATCH, MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for leaf in tree_leaves(caches):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    tok = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen,
                        device="cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (BATCH, PROMPT_LEN)).astype(np.int32),
             "lengths": np.full((BATCH,), PROMPT_LEN, np.int32)}
    bulk = {"tokens": rng.integers(0, cfg.vocab_size,
                                   (1, BULK_LEN)).astype(np.int32)}
    if cfg.encoder_layers:
        for bt in (batch, bulk):
            bt["frames"] = torch.randn(
                (len(bt["tokens"]), cfg.encoder_len, cfg.d_model),
                generator=gen, device="cuda")
    calls = {
        "decode_step": lambda: model.decode_step(params, caches, tok, LIVE),
        "prefill_batch": lambda: model.prefill_batch(params, batch, MAX_LEN),
        "bulk_prefill": lambda: model.prefill(params, bulk, MAX_LEN),
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        wall = _wall_ms(fn, ITERS)
        n = max(3, ITERS // 4)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) / n * 1e3
        out = {"call": name, "arch": cfg.name, "n_layers": cfg.n_layers,
               "batch": BATCH,
               "max_len": MAX_LEN, "card": card,
               "wall_ms_unprofiled": wall}
        out.update(_device_table(prof, n, window, TOP))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
