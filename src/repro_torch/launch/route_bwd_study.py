"""K4's backward (``router_bwd_kernel``) against another build of it, on the
same inputs in one process: the device time of one launch of each, in
rounds of baseline, this tree, this tree, baseline.

  PYTHONPATH=src python -m repro_torch.launch.route_bwd_study \
      --baseline OTHER/src/repro_torch/csrc/moe_topk.cu [--rounds 3]

``--baseline`` is a ``moe_topk.cu`` of another tree (an earlier commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
It is compiled with this tree's flags into ``build/kernels/`` and its C
entry point ``moe_route_bwd`` (whose signature both trees share) is called
with ctypes; this tree's runs through ``kernels.moe_topk.moe_route_bwd``.
The shapes are ``chip_smoke.py``'s: a qwen2-moe training micro-batch (T
2048, E 64, 60 valid, k 4) and deepseek-v3's router (T 2048, E 256, k 8,
scale 2.5), bfloat16.  Each round times a profiler window of ``--iters``
calls of one build: the kernel's mean device time a launch.  Both builds
are first held against the plain version (``ref.moe_route_bwd_ref``).

Prints one JSON line per shape, with every round's times and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels import build, moe_topk as kmoe, ref
from .scan_study import card_line

SHAPES = {"qwen2-moe": (2048, 64, 4, 60, 1.0),
          "deepseek-v3": (2048, 256, 8, 256, 2.5)}
TOL = 3e-2                      # bf16, x max(1, max |plain|)


def baseline_fn(source: Path):
    """The ``moe_route_bwd`` entry point of ``source``, built with this
    tree's flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    path = build.BUILD_DIR / f"route_bwd_baseline-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(path),
                        str(source)], check=True, capture_output=True,
                       timeout=600)
    fn = ctypes.CDLL(str(path)).moe_route_bwd
    fn.argtypes = kmoe._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def call_baseline(fn, logits, idx, w, dw, dps, n_valid, scale):
    t, e = logits.shape
    out = torch.empty_like(logits)
    err = fn(logits.data_ptr(), idx.data_ptr(), w.data_ptr(), dw.data_ptr(),
             dps.data_ptr(), out.data_ptr(), t, e, idx.shape[1], n_valid,
             float(scale), logits.stride(0), out.stride(0),
             kmoe.DTYPES[logits.dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "baseline moe_route_bwd")
    return out


def device_ms(fn, iters: int) -> float:
    """Mean device time of one ``router_bwd_kernel`` launch over a
    profiler window of ``iters`` calls (after one call outside it)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.count and "router_bwd_kernel" in e.key]
    count = sum(e.count for e in mine)
    if not 0 < count <= iters:
        raise AssertionError(f"profiler saw {count} launches in {iters} calls")
    return sum(e.self_device_time_total for e in mine) / count / 1e3


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path, required=True)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--iters", type=int, default=50)
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("route_bwd_study needs a CUDA device")
    base = baseline_fn(a.baseline.resolve())
    card = card_line()
    for name, (t, e, k, n_valid, scale) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(910 + e)
        logits = torch.randn((t, e), generator=g, device="cuda").bfloat16()
        r = kmoe.moe_route(logits, k, capacity=t * k, n_valid=n_valid,
                           router_scale=scale)
        dw = torch.randn((t, k), generator=g, device="cuda")
        dps = torch.randn((e,), generator=g, device="cuda")
        args = (logits, r.idx, r.weights, dw, dps)
        runs = {
            "baseline": lambda: call_baseline(base, *args, n_valid, scale),
            "this_tree": lambda: kmoe.moe_route_bwd(
                *args, n_valid=n_valid, router_scale=scale)}
        want = ref.moe_route_bwd_ref(*args, n_valid=n_valid,
                                     router_scale=scale).float()
        errs = {}
        for who, fn in runs.items():
            errs[who] = (fn().float() - want).abs().max().item()
            if not errs[who] < TOL * max(1.0, want.abs().max().item()):
                raise AssertionError(f"{who} at {name}: error {errs[who]}")
        times = {"baseline": [], "this_tree": []}
        for _ in range(a.rounds):
            for who in ("baseline", "this_tree", "this_tree", "baseline"):
                times[who].append(device_ms(runs[who], a.iters))
        print(json.dumps({
            "study": "route_bwd", "shape": name, "T": t, "E": e, "k": k,
            "n_valid": n_valid, "router_scale": scale, "dtype": "bfloat16",
            "device_ms": times,
            "mean_ms": {w: sum(v) / len(v) for w, v in times.items()},
            "max_abs_err_vs_plain": errs, "baseline": str(a.baseline),
            "iters": a.iters, "card": card}), flush=True)


if __name__ == "__main__":
    main()
