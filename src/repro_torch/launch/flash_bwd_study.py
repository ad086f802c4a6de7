"""K1's bf16 backward against another build of it and against cuDNN, on
the same inputs in one process: the device time of one call of each
build's kernels, in rounds of baseline, this tree, this tree, baseline,
beside the library's backward and the call's bound.

  PYTHONPATH=src python -m repro_torch.launch.flash_bwd_study \\
      --baseline OTHER/src/repro_torch/csrc/flash_attention_bwd.cu \\
      [--rounds 2] [--only llama mla]

``--baseline`` is a ``flash_attention_bwd.cu`` of another tree (an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), compiled with this tree's flags into
``build/kernels/`` beside the ``hopper.cuh`` next to it.  Its C entry
point ``flash_attention_bwd`` is called with the interface its source
declares: the strided one where the signature takes strides, else the
packed one of the builds before it (the inputs here are packed, so both
read the same bytes); this tree's runs through
``kernels.flash_attention.flash_attention_bwd``.  The shapes are the
port's training shapes (``chip_smoke.py``'s ``FAMILY_STEPS`` and
llama3.2-1b at ``train_4k``'s length).  Both builds are first held to the
plain version (``ref.grouped_flash_bwd_ref``, the bf16 gates: 3e-2 of
max(1, max |plain|) and 1e-2 in norm) and to each other (whether their
bits are equal).  Each round times a profiler window of ``--iters`` calls
of one build: the device ms a call summed over its kernels (each kernel's
mean a launch times its launches a call) and by kernel.  The library's
backward is SDPA's (``torch.autograd.grad`` of
``scaled_dot_product_attention``; its forward outside the timing; a
window is an explicit boolean mask), timed the same way over all the
kernels its calls launch, with its backend named.  ``bound_ms`` is
``kernels.work.flash_bwd`` over the card's peak (``roofline.analysis``).

Prints one JSON line per shape with every round's numbers and the card's
name and power limit.

  PYTHONPATH=src python -m repro_torch.launch.flash_bwd_study --stamps \
      [--only llama]

``--stamps`` builds ``csrc/flash_attention_bwd.cu`` with ``-DK1B_STAMPS``
(a library of its own) and prints, for each shape, the SM cycles a
consumer warpgroup of each kernel spends in each phase of its ring tiles
and work tiles (``PHASES``), summed over one call and divided by the
blocks, beside its ring tiles a block; no baseline is needed.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels import build, flash_attention as kflash, ref, work as W
from ..roofline import analysis as RA
from .scan_study import card_line

# name: (B, Sq, Sk, H, KH, hd, dv, causal, window)
SHAPES = {
    "llama": (2, 4096, 4096, 32, 8, 64, 64, True, 0),
    "mla": (1, 2048, 2048, 128, 128, 192, 128, True, 0),
    "qwen2moe": (2, 1024, 1024, 16, 16, 128, 128, True, 0),
    "hymba": (2, 2048, 2048, 25, 5, 64, 64, True, 1024),
    "seamless_encoder": (4, 1024, 1024, 16, 16, 64, 64, False, 0),
    "seamless_cross": (4, 512, 1024, 16, 16, 64, 64, False, 0),
    "internvl2": (4, 1024, 1024, 14, 2, 64, 64, True, 0),
}
TOL, NORM_TOL = 3e-2, 1e-2
STAMP_FLAGS = ("-DK1B_STAMPS",)
# the kernels' STAMP(k) phases, in order
PHASES = ["K/V (dQ: Q, dO) landed", "ring tile landed", "issue S, dP",
          "S landed", "P", "dP landed", "dS, packing", "issue dV, dK (dQ)",
          "dV, dK (dQ) landed", "release, skipped tiles",
          "work tile set-up, epilogue"]
# the packed C interface of the builds before the strided one
_PACKED_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                    + [ctypes.c_float] + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])


def baseline_call(source: Path):
    """A function (q, k, v, o, lse, do, causal, window, scale) -> (dq, dk,
    dv) on the ``flash_attention_bwd`` entry point of ``source``, built
    with this tree's flags."""
    digest = hashlib.sha256(source.read_bytes()
                            + (source.parent / "hopper.cuh").read_bytes()
                            + " ".join(build.NVCC_FLAGS).encode())
    path = build.BUILD_DIR / f"flash_bwd_baseline-{digest.hexdigest()[:16]}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(path),
                        str(source)], check=True, capture_output=True,
                       timeout=600)
    sig = re.search(r'extern "C" int flash_attention_bwd\((.*?)\)',
                    source.read_text(), re.S)
    strided = sig is not None and "long long" in sig.group(1)
    fn = ctypes.CDLL(str(path)).flash_attention_bwd
    fn.argtypes = kflash._BWD_ARGTYPES if strided else _PACKED_ARGTYPES
    fn.restype = ctypes.c_int

    def call(q, k, v, o, lse, do, causal, window, scale):
        b, sq, h, hd = q.shape
        sk, kh, hdv = k.shape[1], k.shape[2], v.shape[3]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        scratch = torch.empty(
            (2, b, h, -(-sq // kflash.BWD_ROW_PAD) * kflash.BWD_ROW_PAD),
            dtype=torch.float32, device=q.device)
        strides = [t.stride(i) for t in (q, k, v, o, do) for i in range(3)]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, sk, h,
                 kh, *(strides if strided else ()), float(scale),
                 int(causal), int(window), kflash.DTYPES[q.dtype], hd, hdv,
                 torch.cuda.current_stream(q.device).cuda_stream)
        build.check(err, "baseline flash_attention_bwd")
        return dq, dk, dv
    return call, strided


def profile_calls(fn, iters: int, match) -> tuple:
    """(device ms a call summed over the CUDA kernels whose name ``match``
    accepts, {kernel: ms a call}) from a profiler window over ``iters``
    calls after one outside it; up to three windows until one holds at
    least ``iters`` launches of each such kernel (the profiler can lose a
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
                and match(e.key)]
        if mine and min(e.count for e in mine) >= iters:
            break
    by = {}
    for e in mine:
        short = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
        short = re.split(r"[<(]", short)[0].split("::")[-1][:60]
        by[short] = by.get(short, 0.0) + (e.self_device_time_total / e.count
                                          / 1e3 * round(e.count / iters))
    return sum(by.values()), by


def inputs(b, sq, sk, h, kh, hd, dv, seed: int) -> tuple:
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    return (randn(b, sq, h, hd), randn(b, sk, kh, hd), randn(b, sk, kh, dv),
            randn(b, sq, h, dv))


def library_call(q, k, v, do, causal: bool, window: int, scale: float):
    """SDPA's backward on (B, heads, S, hd) copies of the inputs, its
    forward run once here: causal top-left (the port's at Sq = Sk), a
    window as a boolean mask."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if window > 0:
        i = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
        j = torch.arange(sk, device="cuda")[None, :]
        mask = (j <= i) & (j > i - window)
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True, scale=scale)
    dot = do.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def stamps(only, card: str) -> None:
    """Each shape's phase cycles from the -DK1B_STAMPS build (see the
    module's doc), after two calls outside the count."""
    import numpy as np
    read = build.function("flash_attention_bwd", "flash_attention_bwd_stamps",
                          [ctypes.c_void_p], STAMP_FLAGS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (b, sq, sk, h, kh, hd, dv, causal, window) in SHAPES.items():
        if only and name not in only:
            continue
        scale = hd ** -0.5
        q, k, v, do = inputs(b, sq, sk, h, kh, hd, dv, 900)
        o, lse = kflash.flash_attention(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_lse=True)

        def call():
            return kflash._backward(q, k, v, o, lse, do, causal, window,
                                    scale, STAMP_FLAGS, ())
        st = np.zeros((2, 2, len(PHASES) + 1), np.uint64)
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "flash_attention_bwd_stamps")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        build.check(read(st.ctypes.data), "flash_attention_bwd_stamps")
        parts = 2 if hd != dv else 1
        blocks = [min(sms, parts * -(-sk // 128) * kh * b),
                  min(sms, -(-sq // 128) * h * b)]
        out = {}
        for kern, label in enumerate(("dkdv", "dq")):
            per = st[kern, :, :len(PHASES)].astype(np.float64) / blocks[kern]
            out[label] = {
                "blocks": blocks[kern],
                "ring_tiles_per_block": [float(x) / blocks[kern]
                                         for x in st[kern, :, len(PHASES)]],
                "cycles_per_block": {
                    f"warpgroup {w}": dict(zip(PHASES, per[w].round(1)))
                    for w in range(2)},
                "cycles_per_block_sum": [float(x) for x in per.sum(1)]}
        print(json.dumps({
            "study": "flash_bwd_stamps", "shape": name, "B": b, "Sq": sq,
            "Sk": sk, "H": h, "KH": kh, "hd": hd, "dv": dv, "causal": causal,
            "window": window, **out, "call_ms": start.elapsed_time(end),
            "card": card}), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path)
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--only", nargs="*", default=None,
                   help="shape names (default: all)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_study needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    if a.stamps:
        return stamps(a.only, card)
    if a.baseline is None:
        raise SystemExit("flash_bwd_study: --baseline or --stamps")
    build.build(("flash_attention_bwd",))
    base, strided = baseline_call(a.baseline.resolve())
    for name, (b, sq, sk, h, kh, hd, dv, causal, window) in SHAPES.items():
        if a.only and name not in a.only:
            continue
        scale = hd ** -0.5
        q, k, v, do = inputs(b, sq, sk, h, kh, hd, dv, 900)
        o, lse = kflash.flash_attention(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_lse=True)
        runs = {
            "baseline": lambda: base(q, k, v, o, lse, do, causal, window,
                                     scale),
            "this_tree": lambda: kflash.flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal, window=window,
                scale=scale)}
        po, plse = ref.grouped_flash_ref(q, k, v, causal=causal,
                                         window=window, scale=scale,
                                         return_lse=True)
        want = ref.grouped_flash_bwd_ref(q, k, v, po, plse, do,
                                         causal=causal, window=window,
                                         scale=scale)
        errs, got = {}, {}
        for who, fn in runs.items():
            got[who] = fn()
            for n, g, w in zip(("dq", "dk", "dv"), got[who], want):
                w = w.float()
                e = ((g.float() - w).abs().max()
                     / max(1.0, w.abs().max().item())).item()
                ne = ((g.float() - w).norm() / w.norm()).item()
                errs[f"{who}_{n}"] = [e, ne]
                if not (e < TOL and ne < NORM_TOL):
                    raise AssertionError(f"{who} {n} at {name}: error {e}, "
                                         f"norm error {ne}")
        same_bits = {who: all(torch.equal(x, y) for x, y in
                              zip(got["baseline"], g))
                     for who, g in got.items() if who != "baseline"}
        del want, po, plse, got
        lib = library_call(q, k, v, do, causal, window, scale)
        times = {who: [] for who in (*runs, "library")}
        by_kernel = {}
        order = ("baseline", "this_tree", "this_tree", "baseline")
        for _ in range(a.rounds):
            for who in order:
                ms, by_kernel[who] = profile_calls(
                    runs[who], a.iters, lambda key: "bwd_" in key)
                times[who].append(ms)
            ms, by_kernel["library"] = profile_calls(lib, a.iters,
                                                     lambda key: True)
            times["library"].append(ms)
        bound, bound_by = RA.bound_ms(W.flash_bwd(q, k, v, causal=causal,
                                                  window=window))
        mean = {w: sum(x) / len(x) for w, x in times.items()}
        print(json.dumps({
            "study": "flash_bwd", "shape": name, "B": b, "Sq": sq, "Sk": sk,
            "H": h, "KH": kh, "hd": hd, "dv": dv, "causal": causal,
            "window": window, "dtype": "bfloat16", "device_ms": times,
            "mean_ms": mean, "device_ms_by_kernel": by_kernel,
            "this_over_library": mean["this_tree"] / mean["library"],
            "this_over_baseline": mean["this_tree"] / mean["baseline"],
            "bound_ms": bound, "bound_by": bound_by,
            "bits_equal_to_baseline": same_bits,
            "baseline_interface": "strided" if strided else "packed",
            "max_rel_and_norm_err_vs_plain": errs,
            "baseline": str(a.baseline), "iters": a.iters, "card": card}),
            flush=True)
        del lib
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
