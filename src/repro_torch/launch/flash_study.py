"""K1's bf16 forward against another build of it, on the same inputs in
one process: the device time of one launch of each and the wrapper's host
time a call, in rounds of baseline, this tree, this tree, baseline.

  PYTHONPATH=src python -m repro_torch.launch.flash_study \
      --baseline OTHER/src/repro_torch/csrc/flash_attention.cu [--rounds 2]

``--baseline`` is a ``flash_attention.cu`` of another tree (an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists), compiled with this tree's flags into ``build/kernels/`` beside the
``hopper.cuh`` next to it.  Its C entry point ``flash_attention_fwd``,
whose signature both trees share, is called through a copy of this tree's
wrapper (the same checks and allocations); this tree's runs through
``kernels.flash_attention.flash_attention``.  The shapes are
``chip_smoke.py``'s K1 timings (the serving admissions, MLA's, seamless's
encoder and cross-attention decode) and the training forward with its row
logsumexp (llama3.2-1b, B 2, S 4096).  Both builds are first held to the
plain version (``ref.grouped_flash_ref``, bf16 3e-2, lse 1e-4).  Each
round times a profiler window of ``--iters`` calls of one build (the
kernel's mean device time a launch, every kernel whose name holds
``flash_fwd``) and the wrapper's host microseconds a call over 1000
unsynchronised calls in runs of 100.  This tree's tensor-map encoding is
timed alone too (``tma_encode_us``).

Prints one JSON line per shape, with every round's numbers and the card's
name and power limit.

  PYTHONPATH=src python -m repro_torch.launch.flash_study --stamps \
      [--only mla seamless_encoder]

``--stamps`` builds ``csrc/flash_attention.cu`` with ``-DK1_STAMPS`` (a
library of its own under ``build/kernels/``) and prints, for each shape,
the SM cycles a consumer warpgroup spends in each phase of its work tiles
and key loop (``PHASES``), summed over one call and divided by the blocks,
beside the call's cycles a block; no baseline is needed.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels import build, flash_attention as kflash, ref
from .scan_study import card_line

# name: (B, Sq, Sk, H, KH, hd, dv, causal, return_lse)
SHAPES = {
    "llama": (8, 256, 256, 32, 8, 64, 64, True, False),
    "qwen2moe": (8, 256, 256, 16, 16, 128, 128, True, False),
    "stablelm": (8, 256, 256, 32, 32, 80, 80, True, False),
    "hymba": (8, 256, 256, 25, 5, 64, 64, True, False),
    "mla": (8, 256, 256, 128, 128, 192, 128, True, False),
    "seamless_encoder": (8, 1024, 1024, 16, 16, 64, 64, False, False),
    "cross_decode": (8, 1, 1024, 16, 16, 64, 64, False, False),
    "train_lse": (2, 4096, 4096, 32, 8, 64, 64, True, True),
}
TOL, LSE_TOL = 3e-2, 1e-4
STAMP_FLAGS = ("-DK1_STAMPS",)
# the kernel's STAMP(k) phases, in order
PHASES = ["work tile set-up", "Q tile", "key tile 0", "K/V tile landed",
          "turn", "issue", "scores landed", "softmax", "P V landed",
          "rescale, P", "last P V", "epilogue"]


def baseline_fn(source: Path):
    """The ``flash_attention_fwd`` entry point of ``source``, built with
    this tree's flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + (source.parent / "hopper.cuh").read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    path = build.BUILD_DIR / f"flash_baseline-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(path),
                        str(source)], check=True, capture_output=True,
                       timeout=600)
    fn = ctypes.CDLL(str(path)).flash_attention_fwd
    fn.argtypes = kflash._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def call_baseline(fn, q, k, v, causal: bool, return_lse: bool):
    """``kflash.flash_attention``'s body with the baseline's entry point."""
    kflash._check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kh, hdv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, h, hdv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), b, sq, sk, h, kh,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             float(hd ** -0.5), int(causal), 0, kflash.DTYPES[q.dtype], hd,
             hdv, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "baseline flash_attention_fwd")
    return (out, lse) if return_lse else out


def device_ms(fn, iters: int) -> tuple:
    """Mean device time of one K1 forward launch over a profiler window of
    ``iters`` calls (after one call outside it), and the kernel's name.
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
                and "flash_fwd" in e.key]
        count = sum(e.count for e in mine)
        if 0 < count <= iters:
            break
    else:
        raise AssertionError(f"profiler saw {count} launches in {iters} calls")
    return (sum(e.self_device_time_total for e in mine) / count / 1e3,
            sorted({e.key.split("(")[0][-48:] for e in mine}))


def host_us(fn, n: int = 1000, batch: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to return, over ``n``
    unsynchronised calls in runs of ``batch`` (drained between runs)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (n // batch * batch) * 1e6


def inputs(b, sq, sk, h, kh, hd, dv, seed: int) -> tuple:
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    q, k = randn(b, sq, h, hd), randn(b, sk, kh, hd)
    # MLA's V: a strided view, as the model passes it
    v = randn(b, sk, kh, 128 + dv)[..., 128:] if dv != hd else randn(
        b, sk, kh, dv)
    return q, k, v


def stamps(only, card: str) -> None:
    """Each shape's phase cycles from the -DK1_STAMPS build (see the
    module's doc), after two calls outside the count."""
    import numpy as np
    fn = build.function("flash_attention", "flash_attention_fwd",
                        kflash._ARGTYPES, STAMP_FLAGS)
    read = build.function("flash_attention", "flash_attention_stamps",
                          [ctypes.c_void_p], STAMP_FLAGS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (b, sq, sk, h, kh, hd, dv, causal, lse) in SHAPES.items():
        if only and name not in only:
            continue
        q, k, v = inputs(b, sq, sk, h, kh, hd, dv, 700)
        st = np.zeros((2, len(PHASES) + 1), np.uint64)
        for _ in range(2):
            call_baseline(fn, q, k, v, causal, lse)
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "flash_attention_stamps")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call_baseline(fn, q, k, v, causal, lse)
        end.record()
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "flash_attention_stamps")
        blocks = min(sms, -(-sq // 128) * h * b)
        per_block = st[:, :len(PHASES)].astype(np.float64) / blocks
        print(json.dumps({
            "study": "flash_fwd_stamps", "shape": name, "B": b, "Sq": sq,
            "Sk": sk, "H": h, "KH": kh, "hd": hd, "dv": dv, "causal": causal,
            "blocks": blocks, "key_loop_iterations_per_block": [
                float(x) / blocks for x in st[:, len(PHASES)]],
            "cycles_per_block": {
                f"warpgroup {w}": dict(zip(PHASES, per_block[w].round(1)))
                for w in range(2)},
            "cycles_per_block_sum": [float(x) for x in per_block.sum(1)],
            "call_ms": start.elapsed_time(end), "card": card}), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path)
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--only", nargs="*", default=None,
                   help="shape names (default: all)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_study needs a CUDA device")
    card = card_line()
    if a.stamps:
        return stamps(a.only, card)
    if a.baseline is None:
        raise SystemExit("flash_study: --baseline or --stamps")
    base = baseline_fn(a.baseline.resolve())
    for name, (b, sq, sk, h, kh, hd, dv, causal, lse) in SHAPES.items():
        if a.only and name not in a.only:
            continue
        q, k, v = inputs(b, sq, sk, h, kh, hd, dv, 700)
        runs = {
            "baseline": lambda: call_baseline(base, q, k, v, causal, lse),
            "this_tree": lambda: kflash.flash_attention(
                q, k, v, causal=causal, return_lse=lse)}
        want, plse = ref.grouped_flash_ref(q, k, v, causal=causal,
                                           return_lse=True)
        live = torch.isfinite(plse)
        errs = {}
        for who, fn in runs.items():
            got = fn()
            out = got[0] if lse else got
            errs[who] = (out.float() - want.float()).abs().max().item()
            if not errs[who] < TOL:
                raise AssertionError(f"{who} at {name}: error {errs[who]}")
            if lse:
                e = (got[1][live] - plse[live]).abs().max().item()
                errs[f"{who}_lse"] = e
                if not e < LSE_TOL:
                    raise AssertionError(f"{who} lse at {name}: error {e}")
        del want, plse
        times = {"baseline": [], "this_tree": []}
        hosts = {"baseline": [], "this_tree": []}
        kernels = {}
        for _ in range(a.rounds):
            for who in ("baseline", "this_tree", "this_tree", "baseline"):
                ms, kernels[who] = device_ms(runs[who], a.iters)
                times[who].append(ms)
                hosts[who].append(host_us(runs[who]))
        print(json.dumps({
            "study": "flash_fwd", "shape": name, "B": b, "Sq": sq, "Sk": sk,
            "H": h, "KH": kh, "hd": hd, "dv": dv, "causal": causal,
            "return_lse": lse, "dtype": "bfloat16", "device_ms": times,
            "mean_ms": {w: sum(x) / len(x) for w, x in times.items()},
            "host_us": hosts,
            "mean_host_us": {w: sum(x) / len(x) for w, x in hosts.items()},
            "tma_encode_us": kflash.tma_encode_us(q, k, v),
            "kernels": kernels, "max_abs_err_vs_plain": errs,
            "baseline": str(a.baseline), "iters": a.iters, "card": card}),
            flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
