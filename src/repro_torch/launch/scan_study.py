"""Where the mLSTM scan (K3) spends its time on the card, which of its two
bfloat16 designs is faster where, what its bf16 roundings cost, and how its
forward compares with another build of it.

  PYTHONPATH=src python -m repro_torch.launch.scan_study stamps [--bh 16 --s 2048]
  PYTHONPATH=src python -m repro_torch.launch.scan_study plans \
      [--dk 16 --dv 64 --bhs 25,50,100,200 --ss 64,128,256,500,1024,2048]
  PYTHONPATH=src python -m repro_torch.launch.scan_study rounding
  PYTHONPATH=src python -m repro_torch.launch.scan_study \
      --baseline OTHER/src/repro_torch/csrc/mlstm_scan.cu [--rounds 2]

``stamps``: builds ``csrc/mlstm_scan.cu`` with ``-DMLSTM_STAMPS`` (a
library of its own under ``build/kernels/``), runs the single pass at
(BH, S, 512, 512) and prints, for each of its two consumer warpgroups, the
SM cycles a chunk spends in each phase (``PHASES``), summed over the
call's blocks and divided by their chunks, after two calls outside the
count.

``plans``: device time of one call under each design, forced, over row-heads
(``--bhs``) x sequence lengths (``--ss``) at key and value dims ``--dk`` and
``--dv`` (default 512, xlstm-350m's heads; hymba-1.5b's SSD heads are dk 16,
dv 64 at 25 row-heads a batch row), from a profiler window (the sum over a
call's kernels), beside the design ``scan_plan`` picks.

``rounding``: at hymba's shape (BH 200, dk 16, dv 64, scale 1.0) the
kernel's and the plain version's bf16 outputs against the float32 result
of the same bf16 inputs, the bf16 spacing where they differ most, and the
error of each bf16 operand rounding of the tensor-core design alone
(score tile, the C copy, w o V), emulated in float32 PyTorch.

``--baseline``: the bf16 forward of this tree against another build of it
on the same inputs in one process, at ``BASELINE_SHAPES`` (xlstm-350m's
training, admission and bulk prefill, hymba-1.5b's training), under each
tree's own plan and with the single pass forced: the device ms of a call
(profiler, summed over its K3 kernels) in rounds of baseline, this tree,
this tree, baseline; each build's max error against the plain version
(3e-2 of max(1, max |plain|)), whether two calls give the same bits,
whether the two builds' bits are equal, each build's CUDA-event ms a call
(host included), the bound (``kernels.work.scan``)
and, at a reduced shape of each, whether the float32 route's bits equal
the baseline's.  ``OTHER`` is an earlier tree unpacked with ``git archive``
into a directory ``.gitignore`` lists: its own ``kernels/mlstm_scan.py``,
loaded under a name of its own, builds and calls its own source.

Each prints one JSON line per measurement, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels import build, ref
from ..kernels import mlstm_scan as kscan

STAMP_FLAGS = ("-DMLSTM_STAMPS",)
# the single pass's MSTAMP(k) phases, in order (csrc/mlstm_scan.cu); the
# panel phases are summed over the chunk's panels.  Consumer 1 stamps 0-3,
# its carries' issue and wait on the one before as 5, its last carry's
# wait as 6.
PHASES = ["V and aux rows landed", "w o V", "stage landed", "C_p^T out",
          "C_p^T from consumer 1", "products issued", "product waits",
          "q . n_prev", "mask and row sums", "P V", "output stores"]
# name: (BH, S, dk, dv, scale)
BASELINE_SHAPES = {
    "train_xlstm": (16, 2048, 512, 512, None),
    "admission": (32, 256, 512, 512, None),
    "bulk": (4, 500, 512, 512, None),
    "train_hymba": (50, 2048, 16, 64, 1.0),
    "admission_hymba": (200, 256, 16, 64, 1.0),
}
F32_SHAPES = {"xlstm": (4, 256, 512, 512, None),
              "hymba": (50, 256, 16, 64, 1.0)}
TOL = 3e-2
ITERS = 10
PLAN_BH = (1, 2, 4, 8, 12, 16, 24, 32)
PLAN_S = (128, 256, 500, 1024, 2048)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def scan_inputs(bh, s, dk, dv, seed):
    """bf16 inputs drawn as chip_smoke.py draws its K3 inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, seed_off):
        gen.manual_seed(seed + seed_off)
        return torch.randn(shape, generator=gen, device="cuda")

    q = (randn(bh, s, dk, seed_off=0) * 0.5).bfloat16()
    k = (randn(bh, s, dk, seed_off=1) * 0.5).bfloat16()
    v = randn(bh, s, dv, seed_off=2).bfloat16()
    logf = torch.nn.functional.logsigmoid(randn(bh, s, seed_off=3) + 2.0)
    i = torch.sigmoid(randn(bh, s, seed_off=4))
    return q, k, v, logf, i


def stamps(bh: int, s: int, card: str) -> None:
    d = 512
    q, k, v, logf, ig = scan_inputs(bh, s, d, d, 0)
    read = build.function("mlstm_scan", "mlstm_stamps", [ctypes.c_void_p],
                          STAMP_FLAGS)
    st = np.zeros((2, len(PHASES) + 1), np.uint64)
    for _ in range(2):
        kscan.run(q, k, v, logf, ig, design="single", flags=STAMP_FLAGS)
    torch.cuda.synchronize()
    build.check(read(st.ctypes.data), "mlstm_stamps")      # clears
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    kscan.run(q, k, v, logf, ig, design="single", flags=STAMP_FLAGS)
    end.record()
    torch.cuda.synchronize()
    build.check(read(st.ctypes.data), "mlstm_stamps")
    for w in range(2):
        chunks = int(st[w, -1])
        if not chunks:
            continue
        per = {name: float(st[w, j]) / chunks for j, name in enumerate(PHASES)}
        print(json.dumps({"study": "stamps", "bh": bh, "s": s, "dk": d,
                          "dv": d, "consumer": w, "chunks": chunks,
                          "cycles_per_chunk": per,
                          "cycles_per_chunk_sum": sum(per.values()),
                          "call_ms": start.elapsed_time(end),
                          "card": card}), flush=True)


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-inclusive time of one call of ``fn``: CUDA events around
    ``iters`` back-to-back calls after ``warmup``, over ``iters``."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def baseline_wrapper(source: Path):
    """The ``kernels.mlstm_scan`` module of the tree that holds ``source``
    (``<tree>/src/repro_torch/csrc/mlstm_scan.cu``), loaded beside this
    tree's as ``scan_baseline.mlstm_scan``, with that tree's ``build``
    module."""
    pkg = types.ModuleType("scan_baseline")
    pkg.__path__ = [str(source.parents[1] / "kernels")]
    sys.modules[pkg.__name__] = pkg
    return importlib.import_module(f"{pkg.__name__}.mlstm_scan")


def baseline(card: str, source: Path, rounds: int) -> None:
    """This tree's bf16 forward against the build at ``source`` (see the
    module's doc)."""
    from ..kernels import work as W
    from ..roofline import analysis as RA
    build.build(("mlstm_scan",))
    base = baseline_wrapper(source.resolve())
    for name, (bh, s, dk, dv, scale) in F32_SHAPES.items():
        x = scan_inputs(bh, s, dk, dv, 17)
        x = (*(t.float() for t in x[:3]), *x[3:])
        equal = torch.equal(kscan.mlstm_scan(*x, scale=scale),
                            base.mlstm_scan(*x, scale=scale))
        print(json.dumps({"study": "scan_baseline_float32", "shape": name,
                          "bh": bh, "s": s, "dk": dk, "dv": dv,
                          "bits_equal_to_baseline": equal, "card": card}),
              flush=True)
    for name, (bh, s, dk, dv, scale) in BASELINE_SHAPES.items():
        x = scan_inputs(bh, s, dk, dv, 29)
        want = ref.mlstm_chunkwise_ref(*x, scale=scale).float()
        limit = TOL * max(1.0, want.abs().max().item())
        row = {"study": "scan_baseline", "shape": name, "bh": bh, "s": s,
               "dk": dk, "dv": dv, "scale": scale,
               "plan": {"this_tree": kscan.scan_plan(bh, s, dk, dv).design,
                        "baseline": base.scan_plan(bh, s, dk, dv).design}}
        for design in (None, "single"):
            tag = "own_plan" if design is None else "single"
            runs = {"baseline": lambda d=design: base.mlstm_scan(
                        *x, scale=scale, design=d),
                    "this_tree": lambda d=design: kscan.mlstm_scan(
                        *x, scale=scale, design=d)}
            got = {w: fn() for w, fn in runs.items()}
            errs = {w: (g.float() - want).abs().max().item()
                    for w, g in got.items()}
            for w, e in errs.items():
                if not e < limit:
                    raise AssertionError(f"{w} at {name} ({tag}): max err "
                                         f"{e} (limit {limit})")
            again = runs["this_tree"]()
            times = {w: [] for w in runs}
            by_kernel = {w: {} for w in runs}
            for _ in range(rounds):
                for w in ("baseline", "this_tree", "this_tree", "baseline"):
                    by_kernel[w] = {}
                    times[w].append(device_ms(runs[w], ITERS, by_kernel[w]))
            mean = {w: sum(t) / len(t) for w, t in times.items()}
            row[tag] = {
                "events_ms": {w: events_ms(fn) for w, fn in runs.items()},
                "device_ms": times, "mean_ms": mean,
                "this_over_baseline": mean["this_tree"] / mean["baseline"],
                "device_ms_by_kernel_last_round": by_kernel,
                "max_abs_err": errs,
                "two_calls_equal_bits": torch.equal(got["this_tree"], again),
                "bits_equal_to_baseline": torch.equal(got["this_tree"],
                                                      got["baseline"])}
            del got, again
        row["bound_ms"], row["bound_by"] = RA.bound_ms(W.scan(*x))
        row["tolerance"] = limit
        print(json.dumps({**row, "baseline": str(source), "iters": ITERS,
                          "card": card}), flush=True)
        del x, want
        torch.cuda.empty_cache()


def device_ms(fn, iters: int = 5, by_kernel: dict | None = None) -> float:
    """Device time of one call of ``fn``, summed over its K3 kernels (up
    to three profiler windows, until one holds a launch a call: the
    profiler can lose a window's device events); each kernel's ms a call
    into ``by_kernel`` when given."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "mlstm_" in e.key]
        if mine and min(e.count for e in mine) >= iters:
            break
    if by_kernel is not None:
        for e in mine:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            name = name.split("(")[0].split("::")[-1]
            by_kernel[name] = (by_kernel.get(name, 0.0)
                               + e.self_device_time_total / iters / 1e3)
    return sum(e.self_device_time_total for e in mine) / iters / 1e3


def plans(card: str, dk: int = 512, dv: int = 512, bhs=PLAN_BH,
          ss=PLAN_S) -> None:
    for bh in bhs:
        for s in ss:
            q, k, v, logf, ig = scan_inputs(bh, s, dk, dv, bh * 7919 + s)
            ms = {design: device_ms(lambda design=design: kscan.run(
                      q, k, v, logf, ig, design=design))
                  for design in kscan.DESIGNS}
            print(json.dumps({"study": "plans", "bh": bh, "s": s, "dk": dk,
                              "dv": dv, "device_ms": ms,
                              "faster": min(ms, key=ms.get),
                              "plan": kscan.scan_plan(bh, s, dk, dv).design,
                              "card": card}), flush=True)
            del q, k, v, logf, ig
            torch.cuda.empty_cache()


def emulate(q, k, v, logf, i, scale: float, rounded: tuple):
    """The tensor-core design's chunk arithmetic (chunks of 64, row sums of
    the unrounded scores) in float32, with the operands named in
    ``rounded`` rounded to bf16 where the kernel rounds them: ``scores``
    (the masked score tile, A of S V), ``state`` (the C copy, B of Q C),
    ``w_v`` (w o V, B of the carry).  The output is not rounded."""
    def rnd(x, name):
        return x.bfloat16().float() if name in rounded else x

    bh, s, dk = q.shape
    dv, chunk = v.shape[-1], kscan.CHUNK
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def tail(x):
        x = x.float()
        return torch.nn.functional.pad(x, (0, 0, 0, pad) if x.dim() == 3
                                       else (0, pad))

    qc = tail(q).reshape(bh, nc, chunk, dk)
    kc = tail(k).reshape(bh, nc, chunk, dk)
    vc = tail(v).reshape(bh, nc, chunk, dv)
    lc = tail(logf).reshape(bh, nc, chunk)
    ic = tail(i).reshape(bh, nc, chunk)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    c = torch.zeros((bh, dk, dv), device=q.device)
    n = torch.zeros((bh, dk), device=q.device)
    hs = []
    for j in range(nc):
        qb, kb, vb, ib = qc[:, j], kc[:, j], vc[:, j], ic[:, j]
        la = torch.cumsum(lc[:, j], dim=-1)
        total = la[:, -1]
        g = scale * la.exp()
        inter = (qb @ rnd(c, "state")) * g[..., None]
        n_inter = (qb @ n[..., None])[..., 0] * g
        dmat = torch.where(causal, (la[:, :, None] - la[:, None, :]).exp()
                           * ib[:, None, :], 0.0)
        smat = (qb @ kb.transpose(1, 2)) * scale * dmat
        den = (n_inter + smat.sum(-1)).abs().clamp(min=1.0)
        hs.append((inter + rnd(smat, "scores") @ vb) / den[..., None])
        w = ib * (total[:, None] - la).exp()
        c = (total.exp()[:, None, None] * c
             + kb.transpose(1, 2) @ rnd(vb * w[..., None], "w_v"))
        n = total.exp()[:, None] * n + (w[:, None, :] @ kb)[:, 0]
    return torch.cat(hs, dim=1)[:, :s]


def rounding(card: str) -> None:
    bh, s, dk, dv, scale = 200, 256, 16, 64, 1.0   # hymba-1.5b, B = 8 x H = 25
    seed = 240                                     # chip_smoke.py's inputs here
    q, k, v, logf, i = scan_inputs(bh, s, dk, dv, seed)
    kern = kscan.run(q, k, v, logf, i, scale=scale).float()
    plain = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale).float()
    exact = ref.mlstm_chunkwise_ref(q.float(), k.float(), v.float(), logf, i,
                                    scale=scale)
    diff = (kern - plain).abs()
    at = int(diff.argmax())
    x = abs(exact.flatten()[at].item())
    emulated = {"+".join(r): (emulate(q, k, v, logf, i, scale, r) - exact
                              ).abs().max().item()
                for r in (("scores",), ("state",), ("w_v",),
                          ("scores", "state", "w_v"))}
    print(json.dumps({
        "study": "rounding", "bh": bh, "s": s, "dk": dk, "dv": dv,
        "scale": scale, "seed": seed,
        "kernel_vs_plain": diff.max().item(),
        "float32_value_there": x,
        "bf16_spacing_there": 2.0 ** (np.floor(np.log2(x)) - 7) if x else 0.0,
        "kernel_vs_float32": (kern - exact).abs().max().item(),
        "plain_vs_float32": (plain - exact).abs().max().item(),
        "max_abs_float32": exact.abs().max().item(),
        "emulated_rounding_vs_float32": emulated,
        "outputs_differing": int((diff > 0).sum()), "outputs": diff.numel(),
        "card": card}), flush=True)


def _ints(text: str) -> tuple:
    return tuple(int(x) for x in text.split(","))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("study", nargs="?", choices=("stamps", "plans", "rounding"))
    ap.add_argument("--baseline", type=Path,
                    help="an mlstm_scan.cu of another tree to time against")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--bh", type=int, default=16)
    ap.add_argument("--s", type=int, default=2048)
    ap.add_argument("--dk", type=int, default=512)
    ap.add_argument("--dv", type=int, default=512)
    ap.add_argument("--bhs", type=_ints, default=PLAN_BH,
                    help="plans: row-heads, comma-separated")
    ap.add_argument("--ss", type=_ints, default=PLAN_S,
                    help="plans: sequence lengths, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_study measures the CUDA device; none found")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.baseline is not None:
        baseline(card, args.baseline, args.rounds)
    if args.study is None:
        if args.baseline is None:
            raise SystemExit("scan_study: a study or --baseline")
    elif args.study == "stamps":
        stamps(args.bh, args.s, card)
    elif args.study == "plans":
        plans(card, args.dk, args.dv, args.bhs, args.ss)
    else:
        rounding(card)


if __name__ == "__main__":
    main()
