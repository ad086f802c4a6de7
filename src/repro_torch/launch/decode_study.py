"""K2 (decode attention) in bf16 against another build of it, on the same
inputs in one process: the device time of one launch of each, the
wrapper's host time a call, the K/V bytes a call reads and the rate it
reads them at, beside the call's bound, in rounds of baseline, this tree,
this tree, baseline.

  PYTHONPATH=src python -m repro_torch.launch.decode_study \\
      --baseline OTHER/src/repro_torch/csrc/decode_attention.cu

``--baseline`` is a ``decode_attention.cu`` of another tree (an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  That tree's own wrapper, ``kernels/decode_attention.py`` beside
the source's ``csrc/``, is loaded under a name of its own and called as
this tree's is: it builds its source with its own flags into its own
tree's ``build/kernels/`` and calls it through its own C interface and
scratch.  The shapes (``SHAPES``) are the decode steps of ``chip_smoke.py``'s
K2 timings: B 8, S_max 1024, every row 700 live (llama3.2-1b, hymba-1.5b,
qwen2-moe-a2.7b, stablelm-3b) or 1024 (seamless-m4t-medium's
cross-attention).  Both builds are first held to the plain version
(``ref.grouped_decode_ref``, bf16: 3e-2 of max(1, max |plain|)); this
tree's two calls must give the same bits (whether the two builds' bf16
bits are equal is printed), and both builds' float32 route (the split
kernel in both) the same bits as each other.  Each of
``ROUNDS`` rounds times a profiler window of ``ITERS`` calls of one build
(the kernel's mean device time a launch, every kernel whose name holds
``decode_``); then the wrapper's host microseconds a call, in
``HOST_PAIRS`` pairs of runs of 100 unsynchronised calls of each build,
their order alternating (``host_pairs``).  ``kv_bytes`` is the live K and V rows a call reads;
``tb_per_s`` divides them by the device time; ``bound_ms`` is
``kernels.work.decode`` over the card's peak (``roofline.analysis``).

Prints one JSON line per shape with every round's numbers and the card's
name and power limit.

  PYTHONPATH=src python -m repro_torch.launch.decode_study --stamps

``--stamps`` builds ``csrc/decode_attention.cu`` with ``-DDECODE_STAMPS``
(a library of its own) and prints, for each shape, the SM cycles the bf16
kernel's first thread of a block spends in each phase (``PHASES``), summed
over one call and divided by the blocks, the tiles (steps) a block, and
from the global timer the span from the first block's start to the last
block's start and end; no baseline is needed.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import statistics
import sys
import time
import types
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels import build, decode_attention as kdecode, ref, work as W
from ..roofline import analysis as RA
from .scan_study import card_line

# name: (B, S_max, live, H, KH, hd)
SHAPES = {
    "llama": (8, 1024, 700, 32, 8, 64),
    "hymba": (8, 1024, 700, 25, 5, 64),
    "qwen2moe": (8, 1024, 700, 16, 16, 128),
    "stablelm": (8, 1024, 700, 32, 32, 80),
    "cross_decode": (8, 1024, 1024, 16, 16, 64),
}
TOL = 3e-2
ROUNDS = 3          # rounds of baseline, this tree, this tree, baseline
ITERS = 20          # calls in a profiler window
HOST_PAIRS = 40     # paired runs of 100 calls for the host time
# the bf16 kernel's STAMP(k) phases, in order
PHASES = ["set-up: copies issued, q asked for", "q and first tile landed",
          "later tiles landed", "scores", "softmax",
          "P V, next copies issued", "warps' partials, block merge",
          "cluster arrival", "cluster merge, output", "groups' merge"]
SLOTS = 15          # STAMP_SLOTS in the CUDA source: 10 phases, blocks,
                    # steps, first start, last start, last end (ns)


def inputs(b, s, live, h, kh, hd, dtype, seed: int = 800) -> tuple:
    gen = torch.Generator(device="cuda")

    def randn(shape, off):
        gen.manual_seed(seed + off)
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
    return randn((b, 1, h, hd), 0), randn((b, s, kh, hd), 1), \
        randn((b, s, kh, hd), 2), lengths


def baseline_wrapper(source: Path):
    """The ``kernels.decode_attention`` module of the tree that holds
    ``source`` (``<tree>/src/repro_torch/csrc/decode_attention.cu``), loaded
    beside this tree's as ``decode_baseline.decode_attention``, with that
    tree's ``build`` module."""
    pkg = types.ModuleType("decode_baseline")
    pkg.__path__ = [str(source.parents[1] / "kernels")]
    sys.modules[pkg.__name__] = pkg
    return importlib.import_module(f"{pkg.__name__}.decode_attention")


def device_ms(fn, iters: int) -> tuple:
    """Mean device time of one K2 launch over a profiler window of
    ``iters`` calls (after one call outside it), and the kernels' names.
    The profiler can lose a window's device events: up to three windows
    are tried."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count
                and "decode_" in e.key]
        count = sum(e.count for e in mine)
        if 0 < count <= iters:
            break
    else:
        raise AssertionError(f"profiler saw {count} launches in {iters} calls")
    return (sum(e.self_device_time_total for e in mine) / count / 1e3,
            sorted({re.search(r"decode_\w+_kernel", e.key).group(0)
                    for e in mine}))


def host_run_us(fn, batch: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to return, the mean over a
    run of ``batch`` unsynchronised calls (the device drained before and
    after, outside the timing)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batch):
        fn()
    us = (time.perf_counter() - t0) / batch * 1e6
    torch.cuda.synchronize()
    return us


def host_pairs(base, mine, pairs: int) -> dict:
    """The wrapper's host microseconds a call of two builds, in ``pairs``
    pairs of runs of 100 calls, the order alternating from pair to pair:
    each build's runs, their medians and quartiles, and the share of pairs
    that this tree's run took less time in.  The host's cores are shared,
    so one run's mean moves by tens of microseconds; paired runs see the
    same load."""
    base(), mine()
    runs = {"baseline": [], "this_tree": []}
    won = 0
    for i in range(pairs):
        order = (("baseline", base), ("this_tree", mine))
        t = {w: host_run_us(fn) for w, fn in (order if i % 2 == 0
                                             else order[::-1])}
        for w in runs:
            runs[w].append(t[w])
        won += t["this_tree"] < t["baseline"]
    q = {w: statistics.quantiles(r, n=4) for w, r in runs.items()}
    return {"runs": runs, "median": {w: q[w][1] for w in q},
            "quartiles": {w: [q[w][0], q[w][2]] for w in q},
            "this_tree_faster_share": won / pairs}


def error(got, want) -> float:
    """Max error over max(1, max |plain|)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


def stamps(card: str) -> None:
    """Each shape's phase cycles from the -DDECODE_STAMPS build (see the
    module's doc), after two calls outside the count."""
    import numpy as np
    flags = kdecode.STAMP_FLAGS
    read = build.function("decode_attention", "decode_attention_stamps",
                          [ctypes.c_void_p], flags)
    for name, (b, s, live, h, kh, hd) in SHAPES.items():
        q, k, v, lengths = inputs(b, s, live, h, kh, hd, torch.bfloat16)

        def call():
            return kdecode._decode(q, k, v, lengths, None, flags)
        st = np.zeros(SLOTS, np.uint64)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "decode_attention_stamps")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "decode_attention_stamps")
        row = st.astype(np.float64)
        blocks = max(1.0, row[10])
        per = {n: row[i] / blocks for i, n in enumerate(PHASES)}
        print(json.dumps({
            "study": "decode_stamps", "shape": name, "B": b, "S_max": s,
            "live": live, "H": h, "KH": kh, "hd": hd,
            "plan": kdecode.mma_plan(s, b, kh),
            "blocks": int(row[10]), "steps_per_block": row[11] / blocks,
            "cycles_per_block": per,
            "cycles_per_block_sum": sum(per.values()),
            "last_start_after_first_us": (row[13] - row[12]) / 1e3,
            "last_end_after_first_start_us": (row[14] - row[12]) / 1e3,
            "call_ms": start.elapsed_time(end), "card": card}), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path)
    p.add_argument("--stamps", action="store_true")
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_study needs a CUDA device")
    card = card_line()
    if a.stamps:
        return stamps(card)
    if a.baseline is None:
        raise SystemExit("decode_study: --baseline or --stamps")
    base = baseline_wrapper(a.baseline.resolve()).decode_attention
    for name, (b, s, live, h, kh, hd) in SHAPES.items():
        x32 = inputs(b, s, live, h, kh, hd, torch.float32)
        f32_equal = torch.equal(kdecode.decode_attention(*x32), base(*x32))
        del x32
        x = inputs(b, s, live, h, kh, hd, torch.bfloat16)
        runs = {"baseline": lambda: base(*x),
                "this_tree": lambda: kdecode.decode_attention(*x)}
        want = ref.grouped_decode_ref(*x)
        errs, got = {}, {}
        for who, fn in runs.items():
            got[who] = fn()
            errs[who] = error(got[who], want)
            if not errs[who] < TOL:
                raise AssertionError(f"{who} at {name}: error {errs[who]}")
        repeat_equal = torch.equal(got["this_tree"], runs["this_tree"]())
        bf16_equal = torch.equal(got["this_tree"], got["baseline"])
        del want, got
        times = {who: [] for who in runs}
        kernels = {}
        for _ in range(ROUNDS):
            for who in ("baseline", "this_tree", "this_tree", "baseline"):
                ms, kernels[who] = device_ms(runs[who], ITERS)
                times[who].append(ms)
        hosts = host_pairs(runs["baseline"], runs["this_tree"], HOST_PAIRS)
        kv_bytes = 2 * b * live * kh * hd * 2
        mean = {w: sum(t) / len(t) for w, t in times.items()}
        bound, bound_by = RA.bound_ms(W.decode(*x))
        print(json.dumps({
            "study": "decode", "shape": name, "B": b, "S_max": s,
            "live": live, "H": h, "KH": kh, "hd": hd, "G": h // kh,
            "dtype": "bfloat16", "device_ms": times, "mean_ms": mean,
            "this_over_baseline": mean["this_tree"] / mean["baseline"],
            "host_us": hosts,
            "kv_bytes": kv_bytes,
            "tb_per_s": {w: kv_bytes / (t * 1e-3) / 1e12
                         for w, t in mean.items()},
            "bound_ms": bound, "bound_by": bound_by,
            "share_of_bound": {w: bound / t for w, t in mean.items()},
            "max_err_vs_plain": errs, "two_calls_equal_bits": repeat_equal,
            "bits_equal_to_baseline": bf16_equal,
            "float32_route_bits_equal_to_baseline": f32_equal,
            "plan": {"split": kdecode.split_plan(s, b, kh),
                     "mma": kdecode.mma_plan(s, b, kh)},
            "kernels": kernels, "baseline": str(a.baseline),
            "iters": ITERS, "card": card}),
            flush=True)
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
