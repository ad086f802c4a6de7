"""K3's bf16 backward against another build of it, on the same inputs in
one process: the device time of one call of each build's kernels, in rounds
of baseline, this tree, this tree, baseline, beside the call's bound, the
state bytes each build's launches move and the rate they move them at.

  PYTHONPATH=src python -m repro_torch.launch.scan_bwd_study \\
      --baseline OTHER/src/repro_torch/csrc/mlstm_scan_bwd.cu [--rounds 2]

``--baseline`` is an ``mlstm_scan_bwd.cu`` of another tree (an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  That tree's own wrapper, ``kernels/mlstm_scan.py`` beside the
source's ``csrc/``, is loaded under a name of its own and called as this
tree's is: it builds its source with its own flags into its own tree's
``build/kernels/`` and calls it through its own C interface and scratch.
The shapes are the port's training shapes: xlstm-350m (B 4, four heads: 16
row-heads, S 2048, dk = dv = 512) and hymba-1.5b's SSD heads (B 2: 50
row-heads, S 2048, dk 16, dv 64, scale 1.0), with inputs drawn as
``chip_smoke.py`` draws them.
Both builds are first held to the plain version
(``ref.mlstm_chunkwise_bwd_ref``, the bf16 gates: 3e-2 of max(1, max
|plain|) and 1e-2 in norm) and to each other (whether their bits are
equal); the float32 route of both builds is run at a reduced shape of each
and its bits compared.  Each round times a profiler window of ``ITERS``
calls of one build: the device ms a call summed over its kernels and by
kernel.  ``state_bytes`` counts the bytes of the chunk states (C before and
dC after every chunk, BH nc dk dv elements) each launch writes and reads,
from the design its kernels' names show; ``tb_per_s`` divides a launch's by
its device time.  ``bound_ms`` is ``kernels.work.scan_bwd`` over the card's peak
(``roofline.analysis``).

Prints one JSON line per shape with every round's numbers and the card's
name and power limit.

  PYTHONPATH=src python -m repro_torch.launch.scan_bwd_study --stamps

``--stamps`` builds ``csrc/mlstm_scan_bwd.cu`` with ``-DK3B_STAMPS`` (a
library of its own) and prints, for each shape, the SM cycles a consumer
warpgroup of each walk spends in each phase of a step, and of the
gradient kernel's dq / dk consumers in each phase of an item (``PHASES``),
summed over one call and divided by the steps (items); no baseline is
needed.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import sys
import types
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels import build, mlstm_scan as kscan, ref, work as W
from ..roofline import analysis as RA
from .scan_study import card_line

# name: (BH, S, dk, dv, scale, qk, ssd)
SHAPES = {
    "xlstm": (16, 2048, 512, 512, None, 1.0, False),
    "hymba": (50, 2048, 16, 64, 1.0, 0.5, True),
}
# the float32 route's bit check, at a reduced shape of each
F32_SHAPES = {"xlstm": (4, 256, 512, 512, None, 1.0, False),
              "hymba": (50, 256, 16, 64, 1.0, 0.5, True)}
TOL, NORM_TOL = 3e-2, 1e-2
STAMP_FLAGS = ("-DK3B_STAMPS",)
# the kernels' K3STAMP(k) phases, in order: the walks', the gradient's
PHASES = {
    "walk": ["out tile free", "state out, store issued", "stage landed",
             "y scaled", "q C", "shares", "carry product",
             "n carry, release"],
    "grad": ["fixed tiles landed", "stage landed", "U, W", "<C, dC>, release",
             "dq product", "dq epilogue", "dk product",
             "dk epilogue, <C, dC> sum"],
}
ITERS = 10          # calls in a profiler window
# bytes of chunk state each bf16 launch moves, per state element (bf16
# copies 2 bytes, float32 ones 4), by design: this one (TMA walks), and the
# one before it, which kept a float32 C beside its bf16 copy
STATE_BYTES = {
    "tma": {"scan_bwd_walk_tma_kernel<1>": 2,           # writes C as bf16
            "scan_bwd_walk_tma_kernel<-1>": 2,          # writes dC as bf16
            "scan_bwd_grad_tma_kernel": 6},             # reads C, dC, dC
    "f32-state": {"scan_bwd_walk_wgmma_kernel<1>": 6,   # C f32 + bf16
                  "scan_bwd_walk_wgmma_kernel<-1>": 6,  # reads C f32,
                                                        # writes dC bf16
                  "scan_bwd_norm_wgmma_kernel": 2,      # reads C bf16
                  "scan_bwd_grad_wgmma_kernel": 6},     # C, dC, dC bf16
}


def inputs(bh, s, dk, dv, qk, ssd, dtype, seed: int = 900) -> tuple:
    """q, k (scaled by ``qk``), v, dh, and the gates, as ``chip_smoke.py``
    draws K3's backward inputs."""
    gen = torch.Generator(device="cuda")

    def randn(shape, dt, off):
        gen.manual_seed(seed + off)
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    F = torch.nn.functional
    q = (randn((bh, s, dk), torch.float32, 0) * qk).to(dtype)
    k = (randn((bh, s, dk), torch.float32, 1) * qk).to(dtype)
    v, dh = randn((bh, s, dv), dtype, 2), randn((bh, s, dv), dtype, 3)
    g = randn((bh, s), torch.float32, 4)
    if ssd:
        dt = F.softplus(g * 1.5)
        return q, k, v, -dt, dt, dh
    return (q, k, v, F.logsigmoid(g + 2.0),
            torch.sigmoid(randn((bh, s), torch.float32, 5)), dh)


def baseline_wrapper(source: Path):
    """The ``kernels.mlstm_scan`` module of the tree that holds ``source``
    (``<tree>/src/repro_torch/csrc/mlstm_scan_bwd.cu``), loaded beside this
    tree's as ``scan_bwd_baseline.mlstm_scan``, with that tree's ``build``
    module."""
    pkg = types.ModuleType("scan_bwd_baseline")
    pkg.__path__ = [str(source.parents[1] / "kernels")]
    sys.modules[pkg.__name__] = pkg
    return importlib.import_module(f"{pkg.__name__}.mlstm_scan")


def design_of(by_kernel: dict) -> str | None:
    """The ``STATE_BYTES`` design whose kernels ran, or None."""
    return next((d for d, per in STATE_BYTES.items()
                 if set(per) <= set(by_kernel)), None)


def profile_calls(fn, iters: int) -> tuple:
    """(device ms a call summed over the ``scan_bwd`` kernels, {kernel,
    its template arguments kept: ms a call}) from a profiler window over
    ``iters`` calls after one outside it; up to three windows until one
    holds at least ``iters`` launches of each (the profiler can lose a
    window's device events)."""
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
                and "scan_bwd" in e.key]
        if mine and min(e.count for e in mine) >= iters:
            break
    by = {}
    for e in mine:
        short = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
        short = short.split("(")[0].split("::")[-1]
        by[short] = by.get(short, 0.0) + (e.self_device_time_total / e.count
                                          / 1e3 * round(e.count / iters))
    return sum(by.values()), by


def errors(got, want) -> dict:
    out = {}
    for n, g, w in zip(("dq", "dk", "dv", "dlogf", "di"), got, want):
        g, w = g.float(), w.float()
        e = ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
        ne = ((g - w).norm() / w.norm()).item() if w.norm() > 0 else (
            0.0 if (g == 0).all() else float("inf"))
        out[n] = [e, ne]
    return out


def stamps(card: str) -> None:
    """Each shape's phase cycles from the -DK3B_STAMPS build (see the
    module's doc), after two calls outside the count."""
    import numpy as np
    read = build.function("mlstm_scan_bwd", "mlstm_scan_bwd_stamps",
                          [ctypes.c_void_p], STAMP_FLAGS)
    for name, (bh, s, dk, dv, scale, qk, ssd) in SHAPES.items():
        x = inputs(bh, s, dk, dv, qk, ssd, torch.bfloat16)

        def call():
            return kscan._backward(*x, scale, STAMP_FLAGS, ())
        st = np.zeros((3, len(PHASES["walk"]) + 1), np.uint64)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "mlstm_scan_bwd_stamps")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "mlstm_scan_bwd_stamps")
        out = {}
        for kern, label in enumerate(("walk_forward", "walk_reverse",
                                      "grad_dq_dk")):
            steps = max(1, int(st[kern, -1]))
            names = PHASES["grad" if kern == 2 else "walk"]
            out[label] = {"steps": steps, "cycles_per_step": {
                n: float(c) / steps for n, c in zip(names, st[kern, :-1])
                if n != "-"}}
            out[label]["cycles_per_step_sum"] = sum(
                out[label]["cycles_per_step"].values())
        print(json.dumps({"study": "scan_bwd_stamps", "shape": name,
                          "BH": bh, "S": s, "dk": dk, "dv": dv, **out,
                          "call_ms": start.elapsed_time(end), "card": card}),
              flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path)
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--rounds", type=int, default=2)
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_bwd_study needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    if a.stamps:
        return stamps(card)
    if a.baseline is None:
        raise SystemExit("scan_bwd_study: --baseline or --stamps")
    build.build(("mlstm_scan_bwd",))
    base = baseline_wrapper(a.baseline.resolve()).mlstm_scan_bwd
    for name, (bh, s, dk, dv, scale, qk, ssd) in SHAPES.items():
        # the float32 route, bit for bit, at a reduced shape
        fb = F32_SHAPES[name]
        x32 = inputs(*fb[:4], fb[5], fb[6], torch.float32)
        f32_equal = all(torch.equal(g, b) for g, b in zip(
            kscan.mlstm_scan_bwd(*x32, scale=fb[4]),
            base(*x32, scale=fb[4])))
        del x32
        x = inputs(bh, s, dk, dv, qk, ssd, torch.bfloat16)
        runs = {"baseline": lambda: base(*x, scale=scale),
                "this_tree": lambda: kscan.mlstm_scan_bwd(*x, scale=scale)}
        want = ref.mlstm_chunkwise_bwd_ref(*x, scale=scale)
        errs, got = {}, {}
        for who, fn in runs.items():
            got[who] = fn()
            errs[who] = errors(got[who], want)
            for n, (e, ne) in errs[who].items():
                if not (e < TOL and ne < NORM_TOL):
                    raise AssertionError(f"{who} {n} at {name}: error {e}, "
                                         f"norm error {ne}")
        same_bits = all(torch.equal(g, b) for g, b in
                        zip(got["this_tree"], got["baseline"]))
        again = runs["this_tree"]()
        repeat_equal = all(torch.equal(g, b) for g, b in
                           zip(got["this_tree"], again))
        del want, got, again
        times = {who: [] for who in runs}
        by_kernel = {who: [] for who in runs}
        for _ in range(a.rounds):
            for who in ("baseline", "this_tree", "this_tree", "baseline"):
                ms, by = profile_calls(runs[who], ITERS)
                times[who].append(ms)
                by_kernel[who].append(by)
        cells = bh * -(-s // kscan.BWD_CHUNK) * dk * dv
        designs = {who: design_of(by[-1]) for who, by in by_kernel.items()}
        state, rate = {}, {}
        for who, design in designs.items():
            per = STATE_BYTES.get(design, {})
            state[who] = {k: b * cells for k, b in per.items()}
            state[who]["total"] = sum(b * cells for b in per.values())
            last = by_kernel[who][-1]
            rate[who] = {k: state[who][k] / (last[k] * 1e-3) / 1e12
                         for k in per if last.get(k)}
        bound, bound_by = RA.bound_ms(W.scan_bwd(*x[:5]))
        mean = {w: sum(t) / len(t) for w, t in times.items()}
        print(json.dumps({
            "study": "scan_bwd", "shape": name, "BH": bh, "S": s, "dk": dk,
            "dv": dv, "scale": scale, "dtype": "bfloat16",
            "device_ms": times, "mean_ms": mean,
            "device_ms_by_kernel": by_kernel,
            "this_over_baseline": mean["this_tree"] / mean["baseline"],
            "bound_ms": bound, "bound_by": bound_by,
            "state_bytes": state, "tb_per_s": rate,
            "bits_equal_to_baseline": same_bits,
            "two_calls_equal_bits": repeat_equal,
            "float32_route_bits_equal_to_baseline": f32_equal,
            "float32_shape": list(fb[:4]),
            "max_rel_and_norm_err_vs_plain": errs,
            "baseline": str(a.baseline), "designs": designs,
            "iters": ITERS,
            "card": card}), flush=True)
        del x
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
