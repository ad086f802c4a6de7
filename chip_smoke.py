#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's serving and training paths -- the UFS live scheduler, the
continuous-batching engine and the models at their published widths:
llama3.2-1b (dense GQA), qwen2-moe-a2.7b (MoE), xlstm-350m (mLSTM and
sLSTM blocks), hymba-1.5b (attention and SSD heads side by side,
sliding-window attention in 29 of 32 layers), internvl2-1b (the VLM
backbone, text only through the engine), deepseek-v3-671b (MLA and MoE, 5
of its 61 layers) and, at model level, seamless-m4t-medium (encoder over
stub frames, cross-attention in every decoder layer) -- on the card; trains
llama3.2-1b (AdamW, K1's backward kernel) and drives the scheduled
training driver's crash and resume; trains every other family (MoE, xLSTM,
hymba, MLA, enc-dec, VLM) through the backward kernels of K1 (MLA's 192 /
128 too), K3 and K4; and holds each hand-written Hopper kernel against its
plain PyTorch version.
Phases, each printed on its own line and each fatal:

1. device   -- the card's name and power limit, compute capability 9.0
2. build    -- compile the CUDA kernels from ``src/repro_torch/csrc``;
               ptxas must report no spill in the mLSTM scan, and its
               tensor-core kernels' SASS must hold HGMMA (cuobjdump); K1's
               backward: registers and spill stores of each bf16 wgmma
               kernel at each head dim, and HGMMA in each one's SASS; no
               spill in K3's backward (``csrc/mlstm_scan_bwd.cu``)
3. kernels  -- each kernel against its plain version over the serving
               shapes and the reference test shapes: attention (K1, K2)
               float32 to 1e-4 and bfloat16 to 3e-2; the MoE router (K4)
               with its dispatch plan: indices, slots, slot tokens and
               counts identical, weights to 1e-6, probability sums to 1e-5
               relative; the mLSTM scan (K3)
               float32 to 1e-3 and bfloat16 to 3e-2 of max(1, max |plain|).
               CUDA-event times of back-to-back calls of the kernel, the
               plain version and (for attention) one library call, SDPA,
               whose backend is named, and the kernel's own device time
               from the profiler (K1 and K2: each call is one launch, and
               no other kernel runs; K3: the sum over the one to three
               launches of its plan), beside the kernel's bound;
               K1 and K2 at llama3.2-1b's, qwen2-moe-a2.7b's, stablelm-3b's
               (head dim 80) and hymba-1.5b's shapes, K1 at deepseek-v3's
               MLA admission (query-key dim 192, value dim 128) and
               seamless's encoder, K1 beside K2 at seamless's
               cross-attention decode (one query over 1024 positions), K3
               at xlstm-350m's admission and bulk-prefill shapes under both
               of its plans (single pass, chunk-parallel) and at hymba's
               SSD heads, K4 at qwen2-moe's decode and admission shapes (one
               launch a call); K1's backward against its plain version on
               dq, dk, dv (float32 1e-4, bf16 3e-2, of max(1, max |plain|),
               and the norm of the error within 1e-4 (float32) and 1e-2
               (bf16) of the plain gradient's) at the training shape
               (llama3.2-1b, B=2, S=4096) and the mask and head-dim edges,
               the plain gradient taken from the plain forward's output
               and logsumexp; the forward's row logsumexp on its live rows
               to 1e-5 (float32) and 1e-4 (bf16); its times beside SDPA's
               backward, with each of its three kernels' own device time;
               the backward kernels of this slice (``kernels.parity.bwd2``)
               against their plain gradients at the same gates: K3's at
               xlstm's dk = dv = 512, hymba's SSD heads, a ragged S and S
               below one chunk, on rows with |a| on both sides of 1; K4's
               at T 8, a qwen2-moe micro-batch (T 2048, E 64, 60 valid, k
               4) and deepseek's E 256 / k 8, with and without the
               probability sums' gradient; K1's at MLA's (192, 128) and
               hymba's training shape (window 1024); each timed at its
               training shape beside its bound (SDPA's backward at 192 /
               128; no PyTorch call for K3's and K4's), the profiler
               seeing bf16 K3 and K1 at 192 / 128 run their wgmma kernels
               and none of the CUDA-core ones
4. model    -- float32, kernel path against the plain path (logits to
               1e-3, greedy tokens identical) over prefill_batch on ragged
               prompts and 8 decode steps: llama3.2-1b and xlstm-350m at
               full size, qwen2-moe-a2.7b (default capacity factors) and
               stablelm-3b at full width with 4 of their 24 and 32 layers
               (in float32 all of qwen2-moe is 60 GB), hymba-1.5b at full
               width on prompts up to 1300 tokens at S_max 2048, so that
               the ring of its windowed layers (1024) wraps: with 4 layers
               to 1e-3, at full depth tokens identical, its logits' error
               printed beside the plain path's own noise floor;
               seamless-m4t-medium (frames from a seed) and internvl2-1b (a
               256-token vision prefix from a seed, prompts of 260-400
               tokens) at full size; deepseek-v3-671b at full width with
               one dense and one MoE layer; then one training loss and
               gradient of llama3.2-1b at full width with 2 layers (B=2,
               S=1024), kernel path against plain path: loss to 1e-5,
               every gradient leaf to 1e-3 of its own max |plain|; the same
               for every other family at full width with 2 layers
               (``FAMILY_CHECKS``), its backward kernels launched
5. engine   -- the engine's tokens equal a direct prefill + decode loop, for
               each of those at the sizes above but seamless (the engine
               passes no frames; hymba at full depth; the MoE models at
               capacity factor 64, where no expert overflows; xlstm and
               hymba on a prompt of one whole length bucket, so no pad
               token enters a recurrent state or a ring)
6. serving  -- per model, at full width and depth in bfloat16 (deepseek-v3:
               3 dense and 2 MoE layers) (the models with recurrent heads
               or a stub frontend first print their prefill_batch logits,
               kernel path against plain path, as max abs error): 8
               time-sensitive requests and 2 background bulk prefills under
               UFS; every request must finish, and the kernels of that path
               must have been launched on it (counts set to 0 just before);
               seamless-m4t-medium's path at model level: prefill_batch of 8
               prompts over their frames and 31 decode steps, its kernels'
               counts set to 0 just before and read just after; llama3.2-1b
               served once more beside serve's background-train lane,
               which must take a step, with K1's backward launched
7. training -- bf16 llama3.2-1b at full size, S=4096, B=4 in 2 micro-
               batches, remat: 4 AdamW steps, losses finite and falling,
               K1's forward and backward launched (counts set to 0 just
               before); step wall and busy ms, tokens/s, peak memory and
               the model-flops share; then ``launch/train.py --scheduled``
               at full width with 2 layers: a crash after step 4,
               ``--resume`` and an uninterrupted run give the same losses,
               and the scheduled save of step 2 equals the unscheduled one;
               then ``train.families``: 4 bf16 AdamW steps of every other
               family (``FAMILY_STEPS``: xlstm, hymba, seamless, internvl2
               at full size, qwen2-moe at 3 and deepseek at 1 layer of full
               width), losses finite and falling, its backward kernels
               launched (the profiler: bf16 K1 and K3 backward on their
               wgmma kernels), the same measures; and the crash / ``--resume``
               drill for qwen2-moe at full width with 2 layers

Then a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # ||got - plain|| / ||plain||
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
ROUTER_TOL = 1e-6                  # weights; indices must be identical
ROUTE_SUM_RTOL = 1e-5              # prob_sum; slots and counts identical
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}   # bf16: x max(1, |ref|)
MODEL_TOL = 1e-3


def hgmma_counts(build, path) -> dict:
    """HGMMA (tensor-core) instructions in each kernel of a built library's
    SASS (cuobjdump), by mangled kernel name."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            hgmma[name] = 0
        elif name and "HGMMA" in ln:
            hgmma[name] += 1
    return hgmma


def ptxas_by_kernel(log_: str, pattern, name) -> dict:
    """ptxas's registers a thread and spill stores of each kernel whose
    mangled name the regex ``pattern`` matches, from a build's
    ``-Xptxas=-v`` log: {name(match): {"registers": n,
    "spill_store_bytes": n}}."""
    out, key = {}, None
    for ln in log_.splitlines():
        if "Compiling entry function" in ln:
            m = pattern.search(ln)
            key = name(m) if m else None
        elif key and (m := re.search(r"(\d+) bytes spill stores", ln)):
            out.setdefault(key, {})["spill_store_bytes"] = int(m.group(1))
        elif key and (m := re.search(r"Used (\d+) registers", ln)):
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


# K3's backward on the tensor cores (bf16): the state walk forward <1> and
# in reverse <-1> (mangled ILi1E, ILin1E), the normaliser, the gradient
SCAN_BWD_WGMMA = re.compile(r"(scan_bwd_\w+?_wgmma_kernel)(?:ILi(n?)(\d+)E)?")
SCAN_BWD_WGMMA_KERNELS = 4


def scan_bwd_name(m) -> str:
    return m.group(1) + (f"<{'-' if m.group(2) else ''}{m.group(3)}>"
                         if m.group(3) else "")


def check_scan_build(build, built) -> None:
    """ptxas reports no spill in the mLSTM scan or its backward (when this
    run built them), and the SASS of the scan's bf16 kernels and of its
    backward's bf16 kernels (``scan_bwd_*_wgmma_kernel``) holds tensor-core
    instructions (HGMMA); each backward wgmma kernel's registers and spill
    stores are printed."""
    path, _, log_ = built["mlstm_scan"]
    bwd_path, _, bwd_log = built["mlstm_scan_bwd"]
    spills = [ln.strip() for ln in (log_ + bwd_log).splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    hgmma = hgmma_counts(build, path)
    wgmma = {n: c for n, c in hgmma.items() if "mlstm_wgmma_kernel" in n}
    bwd_hgmma = {scan_bwd_name(m): c
                 for n, c in hgmma_counts(build, bwd_path).items()
                 if (m := SCAN_BWD_WGMMA.search(n))}
    log("build.mlstm_scan", spill_lines=spills, hgmma_per_kernel=wgmma,
        built_here=bool(log_), bwd_built_here=bool(bwd_log),
        bwd_registers=[ln.strip() for ln in bwd_log.splitlines()
                       if "registers" in ln],
        bwd_wgmma_ptxas=ptxas_by_kernel(bwd_log, SCAN_BWD_WGMMA,
                                        scan_bwd_name),
        bwd_hgmma_per_kernel=bwd_hgmma)
    if spills or not wgmma or not all(wgmma.values()):
        raise AssertionError(f"mlstm_scan: spills {spills}, HGMMA {hgmma}")
    if len(bwd_hgmma) != SCAN_BWD_WGMMA_KERNELS or not all(bwd_hgmma.values()):
        raise AssertionError(f"mlstm_scan_bwd: HGMMA {bwd_hgmma}")


# K1's backward on the tensor cores: each kernel at each (query-key dim,
# value dim) it is built for -- the five equal dims and MLA's (192, 128)
BWD_WGMMA = re.compile(r"(flash_bwd_\w+?_wgmma_kernel)ILi(\d+)ELi(\d+)E")
BWD_WGMMA_KERNELS = 2 * 6


def bwd_name(m) -> str:
    return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"


def check_bwd_build(build, built) -> None:
    """K1's backward: ptxas's registers a thread and spill stores of each
    bf16 `wgmma` kernel at each pair of dims (when this run built it), and
    HGMMA in each one's SASS, MLA's (192, 128) included."""
    path, _, log_ = built["flash_attention_bwd"]
    ptxas = ptxas_by_kernel(log_, BWD_WGMMA, bwd_name)
    hgmma = {bwd_name(m): c
             for n, c in hgmma_counts(build, path).items()
             if (m := BWD_WGMMA.search(n))}
    log("build.flash_attention_bwd", ptxas=ptxas, hgmma_per_kernel=hgmma,
        built_here=bool(log_))
    if len(hgmma) != BWD_WGMMA_KERNELS or not all(hgmma.values()):
        raise AssertionError(f"flash_attention_bwd: HGMMA {hgmma}")


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, kernel: str, iters: int, min_count: int = 1):
    """A profiler window over ``iters`` calls of ``fn`` (after one call
    outside it).  The profiler can lose device events -- a whole window's,
    or some launches of some kernels -- so windows are tried, at least two
    and up to five, until one holds at least ``min_count`` launches of
    each kernel whose name contains ``kernel``, and as many such kernels as
    any window tried; that window is returned, else the last one.  The
    callers check what the window holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        windows.append((prof, [e.count for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA
                               and e.count and kernel in e.key]))
        if len(windows) < 2:
            continue
        widest = max(len(counts) for _, counts in windows)
        for p, counts in windows:
            if len(counts) == widest and min(counts, default=0) >= min_count:
                return p
    return prof


def device_ms(fn, kernel: str, iters: int = 20, alone: bool = False) -> float:
    """Mean device time of one launch of the CUDA kernel whose name contains
    ``kernel``, from a profiler window over ``iters`` calls of ``fn``: the
    kernel alone, without the host time between launches that a
    back-to-back event timing of a short kernel measures.  The window must
    hold at least one launch of it and at most one a call (the profiler can
    drop an event); with ``alone``, no other kernel may run in it, so each
    call is that one launch."""
    from torch.autograd import DeviceType
    prof = profiled(fn, kernel, iters)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]
    mine = [e for e in rows if kernel in e.key]
    count = sum(e.count for e in mine)
    if not 0 < count <= iters:
        raise AssertionError(f"profiler saw {count} launches of {kernel} in "
                             f"{iters} calls")
    others = sorted(e.key for e in rows if kernel not in e.key)
    if alone and others:
        raise AssertionError(f"calls of {kernel} also ran {others}")
    return sum(e.self_device_time_total for e in mine) / count / 1e3


def device_ms_per_call(fn, kernel: str, iters: int = 5,
                       max_per_call: int = 3) -> tuple:
    """Device time of one call of ``fn`` summed over the launches of every
    CUDA kernel whose name contains ``kernel``, those launches per call,
    and each such kernel's grid, from a profiler window over ``iters``
    calls.  Each kernel name counts its mean time a launch times its
    launches a call (rounded, as the profiler can drop an event); a call
    must launch one to ``max_per_call`` of them."""
    from torch.autograd import DeviceType
    prof = profiled(fn, kernel, iters, min_count=iters)
    mine = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count and kernel in e.key]
    per_call = {e.key: round(e.count / iters) for e in mine}
    n = sum(per_call.values())
    if not 0 < n <= max_per_call:
        raise AssertionError(f"profiler saw {per_call} launches of {kernel} "
                             f"a call in {iters} calls")
    ms = sum(e.self_device_time_total / e.count * per_call[e.key]
             for e in mine) / 1e3
    return ms, n, kernel_grids(prof, kernel)


def device_ms_by_kernel(fn, kernel: str, iters: int = 5) -> dict:
    """Device ms a call of each CUDA kernel whose name contains ``kernel``,
    by the kernel's identifier (template arguments dropped), from a
    profiler window over ``iters`` calls of ``fn``: its mean time a launch
    times its launches a call (rounded, as in ``device_ms_per_call``)."""
    from torch.autograd import DeviceType
    prof = profiled(fn, kernel, iters, min_count=iters)
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count and kernel in e.key:
            short = re.search(r"\w*" + kernel + r"\w*", e.key).group(0)
            out[short] = (out.get(short, 0.0)
                          + e.self_device_time_total / e.count / 1e3
                          * max(1, round(e.count / iters)))
    return out


def kernel_grids(prof, kernel: str) -> dict:
    """The launch grid of each kernel whose name contains ``kernel``, as
    the profiler's trace of the device records it: {short name: [x, y, z]}.
    """
    path = ROOT / "build" / "profile_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    grids = {}
    for e in events:
        name, grid = e.get("name", ""), e.get("args", {}).get("grid")
        if str(e.get("cat")).lower() == "kernel" and kernel in name and grid:
            grids[name[name.index(kernel):].split("(")[0]] = grid
    if not grids:
        raise AssertionError(f"the profiler's trace holds no {kernel} launch "
                             "with a grid")
    return grids


def free_device_memory() -> None:
    """Free what the models of a finished phase held: the engine and its
    scheduler threads keep them in reference cycles, which ``del`` alone
    does not break."""
    gc.collect()
    torch.cuda.empty_cache()


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


# ---------------------------------------------------------------- phase 3
def flash_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps, per batch row and head."""
    offs = sk - sq if causal else 0
    n = 0
    for i in range(sq):
        hi = min(sk, i + offs + 1) if causal else sk
        lo = max(0, i + offs - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def flash_bound_ms(q, k, v, causal, window) -> tuple:
    """q, k and v read once and the output written once, each at its own
    head dim; 2 dk operations a kept (query, key) pair for Q K^T and 2 dv
    for P V, at the inputs' peak rate."""
    b, sq, h, dk = q.shape
    sk, dv = k.shape[1], v.shape[3]
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + b * sq * h * dv) * es
    ops = 2 * b * h * (dk + dv) * flash_pairs(sq, sk, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def decode_bound_ms(q, k, lengths) -> tuple:
    b, _, h, hd = q.shape
    kh = k.shape[2]
    es = q.element_size()
    live = int(lengths.clamp(max=k.shape[1]).sum())
    nbytes = 2 * q.numel() * es + 2 * live * kh * hd * es + lengths.numel() * 4
    ops = 4 * h * hd * live
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(ref, kflash, kdecode) -> dict:
    """Parity of both kernels over their shapes, then times at the serving
    shapes.  Returns the per-kernel entries of the kernels line."""
    flash_shapes = [
        # b, sq, sk, h, kh, hd, causal, window
        (8, 256, 256, 32, 8, 64, True, 0),    # llama3.2-1b admission batch
        (2, 64, 200, 8, 2, 64, True, 48),     # one 64-row tile, Sq != Sk, window
        (1, 500, 500, 14, 2, 128, True, 0),   # ragged, G = 7, hd 128
        (2, 200, 200, 4, 1, 16, True, 64),    # hd 16, window
        (1, 500, 500, 32, 8, 64, True, 0),    # ragged bulk prefill
        (8, 256, 256, 14, 2, 64, True, 0),    # qwen2-0.5b, G = 7
        (8, 256, 256, 16, 16, 128, True, 0),  # qwen2-moe-a2.7b admission
        (1, 500, 500, 16, 16, 128, True, 0),  # qwen2-moe bulk prefill
        (1, 512, 512, 32, 8, 64, True, 128),  # sliding window
        (2, 64, 256, 32, 8, 64, False, 0),    # non-causal, Sq != Sk
        (4, 256, 256, 1, 1, 64, True, 0),     # reference test shapes, BH form
        (2, 128, 256, 1, 1, 32, True, 0),
        (1, 512, 512, 1, 1, 128, True, 0),
        (3, 128, 128, 1, 1, 16, True, 0),
        (8, 256, 256, 32, 32, 80, True, 0),   # stablelm-3b admission, hd 80
        (2, 300, 300, 32, 32, 80, True, 100), # hd 80, ragged, window
        (1, 500, 500, 32, 32, 80, True, 0),   # stablelm bulk prefill
        (8, 256, 256, 25, 5, 64, True, 1024), # hymba-1.5b admission, G = 5
        (1, 1300, 1300, 25, 5, 64, True, 1024),  # hymba past its window
        # deepseek-v3 MLA: query-key dim 192, value dim 128 (a 9th entry),
        # V a strided view as the model passes it
        (8, 256, 256, 128, 128, 192, True, 0, 128),   # admission
        (1, 500, 500, 128, 128, 192, True, 0, 128),   # ragged bulk prefill
        (2, 100, 100, 4, 4, 192, True, 0, 128),       # a small MLA, H = 4
        # seamless-m4t-medium (H = KH = 16, hd 64), unmasked
        (8, 1024, 1024, 16, 16, 64, False, 0),  # encoder self-attention
        (8, 256, 1024, 16, 16, 64, False, 0),   # cross-attention prefill
        (8, 1, 1024, 16, 16, 64, False, 0),     # cross-attention decode
        (8, 37, 1024, 16, 16, 64, False, 0),    # ragged Sq = 37, one tile
    ]
    decode_shapes = [
        # b, s, h, kh, hd, lengths
        (8, 1024, 32, 8, 64, [700] * 8),      # llama3.2-1b decode step
        (8, 1024, 32, 8, 64, [1, 64, 65, 300, 511, 700, 1000, 1024]),
        (8, 1024, 14, 2, 64, [700, 3, 1024, 250, 64, 65, 900, 128]),
        (8, 1024, 16, 16, 128, [700] * 8),    # qwen2-moe-a2.7b decode step
        (8, 1024, 16, 16, 128, [1, 64, 65, 300, 511, 700, 1000, 1024]),
        (6, 512, 1, 1, 64, [i * (512 // 6) + 1 for i in range(6)]),
        (2, 2048, 1, 1, 128, [i * 1024 + 1 for i in range(2)]),
        (8, 256, 1, 1, 32, [i * 32 + 1 for i in range(8)]),
        # split edges of the plan at S_max 1024 (chunks of 128 for llama,
        # 256 for qwen2-moe), S_max itself; G = 16 (the largest group)
        (8, 1024, 32, 8, 64, [127, 128, 129, 1024, 1, 255, 256, 257]),
        (8, 1024, 16, 16, 128, [255, 256, 257, 1024, 1, 511, 512, 513]),
        (6, 512, 32, 2, 64, [1, 63, 64, 65, 300, 512]),
        # stablelm-3b (hd 80, G = 1; chunks of 512), hymba-1.5b (G = 5;
        # chunks of 128 at S_max 1024, the global layers at 2048)
        (8, 1024, 32, 32, 80, [700] * 8),
        (8, 1024, 32, 32, 80, [1, 64, 65, 300, 511, 700, 1000, 1024]),
        (8, 1024, 32, 32, 80, [511, 512, 513, 1024, 1, 255, 256, 257]),
        (8, 1024, 25, 5, 64, [1024, 700, 1, 500, 64, 65, 900, 128]),
        (8, 1024, 25, 5, 64, [127, 128, 129, 1024, 1, 255, 256, 257]),
        (8, 2048, 25, 5, 64, [2048, 1300, 1, 255, 256, 257, 1024, 1025]),
    ]
    errs = {"flash": {}, "decode": {}}
    for dt in (torch.float32, torch.bfloat16):
        worst_f = worst_d = 0.0
        for i, (b, sq, sk, h, kh, hd, causal, window, *dv) in enumerate(
                flash_shapes):
            q = randn((b, sq, h, hd), dt, 10 + i)
            k = randn((b, sk, kh, hd), dt, 20 + i)
            v = (randn((b, sk, kh, 128 + dv[0]), dt, 30 + i)[..., 128:] if dv
                 else randn((b, sk, kh, hd), dt, 30 + i))
            out = kflash.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.grouped_flash_ref(q, k, v, causal=causal, window=window)
            err = (out.float() - want.float()).abs().max().item()
            if not err < TOL[dt]:
                raise AssertionError(f"flash_attention {dt} shape "
                                     f"{flash_shapes[i]}: max err {err}")
            worst_f = max(worst_f, err)
        for i, (b, s, h, kh, hd, lens) in enumerate(decode_shapes):
            q = randn((b, 1, h, hd), dt, 40 + i)
            k = randn((b, s, kh, hd), dt, 50 + i)
            v = randn((b, s, kh, hd), dt, 60 + i)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = kdecode.decode_attention(q, k, v, lengths)
            want = ref.grouped_decode_ref(q, k, v, lengths)
            err = (out.float() - want.float()).abs().max().item()
            if not err < TOL[dt]:
                raise AssertionError(f"decode_attention {dt} shape "
                                     f"{decode_shapes[i][:5]}: max err {err}")
            worst_d = max(worst_d, err)
        name = str(dt).replace("torch.", "")
        errs["flash"][name], errs["decode"][name] = worst_f, worst_d
    torch.cuda.synchronize()
    log("kernels.parity", shapes_flash=len(flash_shapes),
        shapes_decode=len(decode_shapes), max_abs_err=errs,
        tolerance={"float32": TOL[torch.float32],
                   "bfloat16": TOL[torch.bfloat16]})

    # Times at the serving shapes, bfloat16 as served: llama3.2-1b's, then
    # under a suffix qwen2-moe-a2.7b's, stablelm-3b's (hd 80) and
    # hymba-1.5b's; K1 alone at deepseek-v3's MLA admission (192 / 128)
    # and seamless-m4t-medium's encoder, and K1 beside K2 on the same
    # inputs at seamless's cross-attention decode (Sq = 1 over the 1024
    # encoder positions).
    flash, decode = time_flash(ref, kflash, 8, 256, 32, 8, 64), \
        time_decode(ref, kdecode, 8, 1024, 700, 32, 8, 64)
    for key, d in (("flash_attention", flash), ("decode_attention", decode)):
        log("kernels.time", kernel=key, **d)

    def add(key, d, tag, more):
        log("kernels.time", kernel=key, tag=tag, **more)
        d.update({f"{k}_{tag}": v for k, v in more.items()})

    for tag, h, kh, hd in (("qwen2moe", 16, 16, 128), ("stablelm", 32, 32, 80),
                           ("hymba", 25, 5, 64)):
        add("flash_attention", flash, tag,
            time_flash(ref, kflash, 8, 256, h, kh, hd))
        add("decode_attention", decode, tag,
            time_decode(ref, kdecode, 8, 1024, 700, h, kh, hd))
    add("flash_attention", flash, "mla",
        time_flash(ref, kflash, 8, 256, 128, 128, 192, dv=128))
    add("flash_attention", flash, "seamless_encoder",
        time_flash(ref, kflash, 8, 1024, 16, 16, 64, causal=False))
    add("flash_attention", flash, "cross_decode",
        time_flash(ref, kflash, 8, 1024, 16, 16, 64, causal=False, sq=1,
                   seed=80))
    add("decode_attention", decode, "cross_decode",
        time_decode(ref, kdecode, 8, 1024, 1024, 16, 16, 64))
    flash["max_abs_err_f32"] = errs["flash"]["float32"]
    decode["max_abs_err_f32"] = errs["decode"]["float32"]
    return {"flash_attention": flash, "decode_attention": decode}


def sdpa_backend(fn) -> tuple:
    """Which of SDPA's backends ``fn`` (one default SDPA call) ran, from the
    names of the kernels a profiler window over one call saw: cudnn,
    flash, efficient (memory-efficient) or math, and those names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count})
    low = " ".join(names).lower()
    if not names:
        backend = "not seen"
    elif "cudnn" in low:
        backend = "cudnn"
    elif "flash" in low:
        backend = "flash"
    elif "fmha" in low or "memeff" in low or "efficient" in low:
        backend = "efficient"
    else:
        backend = "math"
    return backend, [n[:80] for n in names[:4]]


def time_flash(ref, kflash, b, s, h, kh, hd, dv=None, causal=True,
               sq=None, seed=70) -> dict:
    """K1 in bfloat16 at one shape (Sk = s, Sq = ``sq`` or s; ``dv``: a
    value dim of its own, V a strided view as MLA passes it; q, k and v
    drawn from ``seed`` and the two seeds after it): CUDA-event times of
    the kernel, the plain version and SDPA (its backend named), and the
    wgmma kernel's own device time and launches a call (one)."""
    F = torch.nn.functional
    dt = torch.bfloat16
    sq = sq or s
    q = randn((b, sq, h, hd), dt, seed)
    k = randn((b, s, kh, hd), dt, seed + 1)
    v = (randn((b, s, kh, 128 + dv), dt, seed + 2)[..., 128:] if dv
         else randn((b, s, kh, hd), dt, seed + 2))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def call():
        return kflash.flash_attention(q, k, v, causal=causal)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True, scale=hd ** -0.5)
    d = {
        "ms": cuda_ms(call),
        "plain_ms": cuda_ms(lambda: ref.grouped_flash_ref(q, k, v,
                                                          causal=causal)),
        "library_ms": cuda_ms(library),
        "device_ms": device_ms(call, "flash_fwd_wgmma", alone=True),
    }
    _, d["launches_per_call"], _ = device_ms_per_call(
        call, "flash_fwd_wgmma", max_per_call=1)
    d["library_backend"], d["library_kernels"] = sdpa_backend(library)
    d["bound_ms"], d["bound_by"] = flash_bound_ms(q, k, v, causal, 0)
    d["shape"] = (f"B={b} Sq={sq} Sk={s} H={h} KH={kh} hd={hd}"
                  f"{f' dv={dv}' if dv else ''} "
                  f"{'causal' if causal else 'unmasked'} bf16")
    d["max_abs_err"] = (call().float() - ref.grouped_flash_ref(
        q, k, v, causal=causal).float()).abs().max().item()
    return d


def time_decode(ref, kdecode, b, smax, live, h, kh, hd) -> dict:
    """K2 in bfloat16 at one decode-step shape, all rows ``live`` long: as
    ``time_flash``; the profiler must see exactly one K2 launch a call."""
    F = torch.nn.functional
    dt = torch.bfloat16
    q = randn((b, 1, h, hd), dt, 80)
    k, v = (randn((b, smax, kh, hd), dt, 81 + j) for j in range(2))
    lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = (torch.arange(smax, device="cuda")[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    d = {
        "ms": cuda_ms(lambda: kdecode.decode_attention(q, k, v, lengths)),
        "plain_ms": cuda_ms(lambda: ref.grouped_decode_ref(q, k, v, lengths)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        "device_ms": device_ms(
            lambda: kdecode.decode_attention(q, k, v, lengths),
            "decode_split_kernel", alone=True),
    }
    _, d["launches_per_call"], _ = device_ms_per_call(
        lambda: kdecode.decode_attention(q, k, v, lengths),
        "decode_split_kernel", max_per_call=1)
    d["bound_ms"], d["bound_by"] = decode_bound_ms(q, k, lengths)
    d["n_split"], d["chunk"] = kdecode.split_plan(smax, b, kh)
    d["shape"] = f"B={b} S_max={smax} live={live} H={h} KH={kh} hd={hd} bf16"
    got = kdecode.decode_attention(q, k, v, lengths)
    d["max_abs_err"] = (got.float() - ref.grouped_decode_ref(
        q, k, v, lengths).float()).abs().max().item()
    return d


def flash_bwd_bound_ms(q, k, causal, window, hdv=None) -> tuple:
    """K1's backward: q, k, v, o, dO and lse read once, dq, dk and dv
    written once; 6 dk + 4 dv operations a kept (query, key) pair (S and
    dP recomputed, dV, dQ and dK), at the inputs' peak rate.  ``hdv``: the
    value dim where it is not the query-key dim (MLA)."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    hdv = hd if hdv is None else hdv
    es = q.element_size()
    nbytes = ((2 * b * sq * h + 2 * b * sk * kh) * hd
              + (2 * b * sq * h + 2 * b * sk * kh) * hdv) * es + b * h * sq * 4
    ops = b * h * (6 * hd + 4 * hdv) * flash_pairs(sq, sk, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def norm_err(got, want) -> float:
    """||got - want|| / ||want||: unlike an error of max |want|, it fails
    when a part of the tensor is wrong, however small its entries."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def backward_phase(ref, kflash) -> dict:
    """K1's backward against ``ref.grouped_flash_bwd_ref`` on dq, dk and dv
    (float32 1e-4, bf16 3e-2, of max(1, max |plain|); and the error's norm
    within ``NORM_TOL`` of the plain gradient's), the plain gradient taken
    from the plain forward's output and logsumexp, so that a wrong kernel
    logsumexp shows; the forward's row logsumexp against the plain one on
    its live rows (``LSE_TOL``), over the training shape and the mask and
    head-dim edges; then times at the training shape, llama3.2-1b at
    ``train_4k``'s sequence length, bf16.  Returns the kernels-line
    entry."""
    shapes = [
        # b, sq, sk, h, kh, hd, causal, window
        (2, 4096, 4096, 32, 8, 64, True, 0),  # llama3.2-1b training, 4k
        (1, 1024, 1024, 8, 8, 128, True, 0),  # hd 128, G = 1
        (2, 512, 512, 8, 2, 64, True, 8),     # window 8
        (2, 300, 300, 8, 2, 64, False, 0),    # unmasked, ragged
        (2, 200, 500, 8, 2, 64, True, 0),     # Sq < Sk, causal
        (1, 777, 777, 8, 2, 64, True, 0),     # ragged S
        (2, 300, 300, 4, 2, 16, True, 0),     # hd 16
        (2, 300, 300, 4, 2, 32, True, 0),     # hd 32
        (2, 300, 300, 8, 8, 80, True, 0),     # hd 80
    ]
    errs, norm_errs, lse_errs = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        worst = worst_norm = worst_lse = 0.0
        for i, (b, sq, sk, h, kh, hd, causal, window) in enumerate(shapes):
            q = randn((b, sq, h, hd), dt, 500 + i)
            k = randn((b, sk, kh, hd), dt, 520 + i)
            v = randn((b, sk, kh, hd), dt, 540 + i)
            do = randn((b, sq, h, hd), dt, 560 + i)
            o, lse = kflash.flash_attention(q, k, v, causal=causal,
                                            window=window, return_lse=True)
            got = kflash.flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=causal, window=window)
            po, plse = ref.grouped_flash_ref(q, k, v, causal=causal,
                                             window=window, return_lse=True)
            live = torch.isfinite(plse)
            if not torch.equal(live, torch.isfinite(lse)):
                raise AssertionError(f"lse {dt} at {shapes[i]}: rows with "
                                     "no key differ from the plain version")
            e = (lse[live] - plse[live]).abs().max().item()
            if not e < LSE_TOL[dt]:
                raise AssertionError(f"lse {dt} at {shapes[i]}: error {e}")
            worst_lse = max(worst_lse, e)
            want = ref.grouped_flash_bwd_ref(q, k, v, po, plse, do,
                                             causal=causal, window=window)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                w = w.float()
                err = ((g.float() - w).abs().max()
                       / max(1.0, w.abs().max().item())).item()
                nerr = norm_err(g, w)
                if not (err < TOL[dt] and nerr < NORM_TOL[dt]):
                    raise AssertionError(
                        f"flash_attention_bwd {dt} {name} shape {shapes[i]}: "
                        f"error {err}, norm error {nerr}")
                worst, worst_norm = max(worst, err), max(worst_norm, nerr)
            del got, want, po, plse
        key = str(dt).replace("torch.", "")
        errs[key], norm_errs[key], lse_errs[key] = worst, worst_norm, worst_lse
    torch.cuda.synchronize()
    log("kernels.parity.k1_bwd", shapes=len(shapes),
        max_rel_err=errs, max_norm_err=norm_errs, lse_max_abs_err=lse_errs,
        tolerance={"float32": "1e-4 x max(1, max|plain|)",
                   "bfloat16": "3e-2 x max(1, max|plain|)",
                   "norm": {"float32": NORM_TOL[torch.float32],
                            "bfloat16": NORM_TOL[torch.bfloat16]},
                   "lse": {"float32": LSE_TOL[torch.float32],
                           "bfloat16": LSE_TOL[torch.bfloat16]}})

    # Times at the training shape, bf16; SDPA's backward alone (its
    # forward outside the timing, causal top-left, which equals the port's
    # at Sq = Sk) as the library call.
    F = torch.nn.functional
    dt = torch.bfloat16
    b, s, h, kh, hd = 2, 4096, 32, 8, 64
    q, k, v, do = (randn(shape, dt, 600 + j) for j, shape in enumerate(
        ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd), (b, s, h, hd))))
    o, lse = kflash.flash_attention(q, k, v, return_lse=True)

    def call():
        return kflash.flash_attention_bwd(q, k, v, o, lse, do)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    d = {"ms": cuda_ms(call, iters=10, warmup=2),
         "plain_ms": cuda_ms(lambda: ref.grouped_flash_bwd_ref(
             q, k, v, o, lse, do), iters=3, warmup=1),
         "library_ms": cuda_ms(library, iters=10, warmup=2)}
    d["device_ms"], d["launches_per_call"], d["grid"] = device_ms_per_call(
        call, "bwd_d", iters=3, max_per_call=3)
    d["device_ms_by_kernel"] = device_ms_by_kernel(call, "bwd_d", iters=5)
    d["design"] = ("bf16: bwd_delta_kernel (D, lse log2 e), "
                   "flash_bwd_dkdv_wgmma_kernel (128 keys a block, wgmma "
                   "S^T, dP^T, dV, dK), flash_bwd_dq_wgmma_kernel (128 "
                   "queries a block, wgmma S, dP, dQ); float32 on the CUDA "
                   "cores (bwd_dkdv_kernel, bwd_dq_kernel)")
    d["library_backend"], d["library_kernels"] = sdpa_backend(library)
    d["bound_ms"], d["bound_by"] = flash_bwd_bound_ms(q, k, True, 0)
    d["kept_pairs"] = b * h * flash_pairs(s, s, True, 0)
    d["fwd_lse_device_ms"] = device_ms(
        lambda: kflash.flash_attention(q, k, v, return_lse=True),
        "flash_fwd_wgmma", iters=5, alone=True)
    d["fwd_device_ms"] = device_ms(lambda: kflash.flash_attention(q, k, v),
                                   "flash_fwd_wgmma", iters=5, alone=True)
    # The forward with its row logsumexp: its bound (2 dk + 2 dv
    # operations a kept pair; q, k, v read, o and lse written), and the
    # library's flash forward that returns the logsumexp, on K and V
    # repeated to the query heads outside the timing
    fb = b * h * 4 * hd * flash_pairs(s, s, True, 0) / PEAK_OPS[dt] * 1e3
    fbytes = ((2 * q.numel() + 2 * k.numel()) * q.element_size()
              + b * h * s * 4) / HBM_BYTES_PER_S * 1e3
    d["fwd_lse_bound_ms"] = max(fb, fbytes)
    d["fwd_lse_bound_by"] = "operations" if fb >= fbytes else "bytes"
    kr, vr = (t.repeat_interleave(h // kh, dim=1) for t in (kt, vt))
    d["fwd_lse_library_ms"] = cuda_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt.detach(), kr.detach(), vr.detach(), 0.0, True, False),
        iters=10, warmup=2)
    d["fwd_lse_library"] = ("aten._scaled_dot_product_flash_attention "
                            "(returns the logsumexp), K, V repeated to 32 "
                            "heads")
    del kr, vr
    got = call()
    po, plse = ref.grouped_flash_ref(q, k, v, return_lse=True)
    want = ref.grouped_flash_bwd_ref(q, k, v, po, plse, do)
    d["max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                           for g, w in zip(got, want))
    d["norm_err"] = max(norm_err(g, w) for g, w in zip(got, want))
    d["max_abs_err_f32"] = errs["float32"]
    d["shape"] = f"B={b} S={s} H={h} KH={kh} hd={hd} causal bf16 (train_4k)"
    log("kernels.time", kernel="flash_attention_bwd", **d)
    return d


def router_bound_ms(logits, top_k: int, cap: int) -> tuple:
    """Each logit read once; weights, indices and slots (T, k), the slot
    tokens (E, C), the probability sums and counts (E,) written once; (5 +
    2k) float32 operations a logit (mask, max, exp, sum, divide; a compare
    and a select per argmax pass), at the float32 rate: the reference
    computes the router in float32."""
    t, e = logits.shape
    nbytes = (logits.numel() * logits.element_size() + t * top_k * 12
              + e * cap * 4 + e * 8)
    ops = t * e * (5 + 2 * top_k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def route_errors(got, want) -> tuple:
    """(integer outputs identical, weights' max abs error, probability
    sums' max relative error) of a ``Route`` against the plain one."""
    ints = all(torch.equal(getattr(got, n), getattr(want, n))
               for n in ("idx", "slot", "slot_tok", "counts"))
    w_err = (got.weights - want.weights).abs().max().item()
    rel = ((got.prob_sum - want.prob_sum).abs()
           / want.prob_sum.abs().clamp(min=1e-30))
    rel = torch.where(got.prob_sum == want.prob_sum, 0.0, rel)
    return ints, w_err, rel.max().item()


def scan_bound_ms(q, v) -> tuple:
    """q, k, v read once, out written once, the two float32 gates read
    once; 4 dk dv operations a step for q C and the update of C, at the
    peak rate of the inputs' type (bf16 tensor cores, float32 CUDA cores)."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * v.numel()) * es + 2 * bh * s * 4
    ops = 4 * bh * s * dk * dv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_inputs(bh, s, dk, dv, dtype, seed):
    F = torch.nn.functional
    q = (randn((bh, s, dk), torch.float32, seed) * 0.5).to(dtype)
    k = (randn((bh, s, dk), torch.float32, seed + 1) * 0.5).to(dtype)
    v = randn((bh, s, dv), dtype, seed + 2)
    logf = F.logsigmoid(randn((bh, s), torch.float32, seed + 3) + 2.0)
    i = torch.sigmoid(randn((bh, s), torch.float32, seed + 4))
    return q, k, v, logf, i


def router_scan_phase(ref, kmoe, kscan, capacity) -> dict:
    """Parity of K4 and K3 over their shapes, then times at the serving
    shapes.  Returns the per-kernel entries of the kernels line."""
    worst_w, worst_rel = {}, {}
    n_router = n_route = 0
    for dt in (torch.float32, torch.bfloat16):
        worst = worst_r = 0.0
        for t in (8, 512, 2048, 500, 8192):
            for j, (e, k, n_valid) in enumerate(((64, 4, 60), (256, 8, 256),
                                                 (16, 2, 16))):
                logits = randn((t, e), dt, 100 + t + j)
                w, idx = kmoe.moe_topk(logits, k, n_valid)
                rw, ridx = ref.moe_topk_ref(logits, k, n_valid)
                err = (w - rw).abs().max().item()
                if not (torch.equal(idx, ridx) and err < ROUTER_TOL):
                    raise AssertionError(
                        f"moe_topk {dt} T={t} E={e} k={k} n_valid={n_valid}: "
                        f"indices equal {torch.equal(idx, ridx)}, max err {err}")
                worst = max(worst, err)
                n_router += 1
                # the dispatch plan at capacities that drop pairs (0.5), at
                # the prefill (1.25) and decode (2.0) defaults
                for cap in sorted({capacity(t, k, cf, e)
                                   for cf in (0.5, 1.25, 2.0)}):
                    got = kmoe.moe_route(logits, k, capacity=cap,
                                         n_valid=n_valid)
                    ints, w_err, rel = route_errors(got, ref.moe_route_ref(
                        logits, k, capacity=cap, n_valid=n_valid))
                    if not (ints and w_err < ROUTER_TOL
                            and rel <= ROUTE_SUM_RTOL):
                        raise AssertionError(
                            f"moe_route {dt} T={t} E={e} k={k} C={cap}: "
                            f"integers identical {ints}, weights err {w_err},"
                            f" prob_sum rel err {rel}")
                    worst, worst_r = max(worst, w_err), max(worst_r, rel)
                    n_route += 1
        worst_w[str(dt).replace("torch.", "")] = worst
        worst_rel[str(dt).replace("torch.", "")] = worst_r
    scan_shapes = [
        # bh, s, dk, dv, scale
        (32, 64, 512, 512, None),      # xlstm-350m admission, B=8 H=4
        (32, 256, 512, 512, None),
        (32, 1024, 512, 512, None),
        (4, 500, 512, 512, None),      # xlstm bulk prefill, B=1
        (200, 256, 16, 64, 1.0),       # hymba-1.5b SSD heads, B=8 H=25
        (2, 256, 32, 32, None),        # reference test shapes
        (4, 128, 16, 64, None),
        (1, 512, 64, 64, None),
    ]
    worst_s = {}
    for dt in (torch.float32, torch.bfloat16):
        worst = 0.0
        for j, (bh, s, dk, dv, scale) in enumerate(scan_shapes):
            q, k, v, logf, i = scan_inputs(bh, s, dk, dv, dt, 200 + 10 * j)
            out = kscan.mlstm_scan(q, k, v, logf, i, scale=scale)
            want = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale)
            err = (out.float() - want.float()).abs().max().item()
            tol = SCAN_TOL[dt] * (1.0 if dt == torch.float32 else
                                  max(1.0, want.float().abs().max().item()))
            if not err < tol:
                raise AssertionError(f"mlstm_scan {dt} shape {scan_shapes[j]}:"
                                     f" max err {err} (tolerance {tol})")
            worst = max(worst, err)
        worst_s[str(dt).replace("torch.", "")] = worst
    torch.cuda.synchronize()
    log("kernels.parity.k3k4", cases_router=n_router, cases_route=n_route,
        shapes_scan=len(scan_shapes),
        chunk_len_f32={dk: kscan.chunk_len(dk) for dk in (16, 32, 64, 512)},
        plans_bf16={str(sh[:4]): kscan.scan_plan(*sh[:4]).design
                    for sh in scan_shapes},
        max_abs_err={"moe_topk": worst_w, "mlstm_scan": worst_s},
        max_rel_err_prob_sum=worst_rel,
        tolerance={"moe_topk": "indices, slots, slot tokens, counts "
                               "identical; weights 1e-6; prob_sum 1e-5 rel",
                   "mlstm_scan": "float32 1e-3, bfloat16 3e-2 x max(1, |ref|)"})

    # Times at the serving shapes, bfloat16 as served.  The router runs at
    # every MoE layer of every decode step (T = 8, one slot an expert at the
    # decode capacity factor 2.0) and admission prefill (T = 8 x 256, 160
    # slots at 1.25); the scan at admission (B = 8 x H = 4 row-heads, S =
    # 256) and bulk prefill (B = 1, S = 500).  K4's "ms" and "device_ms"
    # time the whole plan (``moe_route``), one launch a call; the
    # "_topk_only" entry is the same kernel with the plan switched off.
    dt = torch.bfloat16
    router = {}
    for tag, t, cf in (("", 8, 2.0), ("_prefill", 2048, 1.25)):
        logits = randn((t, 64), dt, 300 + t)
        cap = capacity(t, 4, cf, 64)
        route = (lambda logits=logits, cap=cap: kmoe.moe_route(
            logits, 4, capacity=cap, n_valid=60))
        router["capacity" + tag] = cap
        router["ms" + tag] = cuda_ms(route)
        router["plain_ms" + tag] = cuda_ms(lambda: ref.moe_route_ref(
            logits, 4, capacity=cap, n_valid=60))
        router["device_ms" + tag] = device_ms(route, "router_kernel",
                                              alone=True)
        _, n, router["grid" + tag] = device_ms_per_call(
            route, "router_kernel", max_per_call=1)
        router["launches_per_call" + tag] = n
        router["device_ms_topk_only" + tag] = device_ms(
            lambda: kmoe.moe_topk(logits, 4, 60), "router_kernel", alone=True)
        b, by = router_bound_ms(logits, 4, cap)
        router["bound_ms" + tag] = b
        if not tag:
            router["bound_by"] = by
            _, w_err, _ = route_errors(route(), ref.moe_route_ref(
                logits, 4, capacity=cap, n_valid=60))
            router["max_abs_err"] = w_err
    router["shape"] = ("T=8 C=1 (decode; _prefill: T=2048 C=160) E=64 k=4 "
                       "n_valid=60 bf16, whole plan")
    router["library_ms"] = None

    # K3 under its own plan ("ms", "device_ms") and under each plan forced
    # ("*_single", "*_chunk_parallel"), at both shapes.
    scan = {}
    for tag, (bh, s) in (("", (32, 256)), ("_bulk", (4, 500))):
        q, k, v, logf, i = scan_inputs(bh, s, 512, 512, dt, 400 + s)
        own = kscan.scan_plan(bh, s, 512, 512)
        scan["plan" + tag] = own.design
        for design in ("single", "chunk_parallel"):
            call = (lambda design=design: kscan.mlstm_scan(q, k, v, logf, i,
                                                           design=design))
            scan[f"ms{tag}_{design}"] = cuda_ms(call, iters=20, warmup=3)
            (scan[f"device_ms{tag}_{design}"],
             scan[f"launches_per_call{tag}_{design}"],
             scan[f"grid{tag}_{design}"]) = device_ms_per_call(call, "mlstm_")
            got = call()
            want = ref.mlstm_chunkwise_ref(q, k, v, logf, i)
            err = (got.float() - want.float()).abs().max().item()
            if not err < SCAN_TOL[dt] * max(1.0, want.float().abs().max().item()):
                raise AssertionError(f"mlstm_scan {design} at BH={bh} S={s}: "
                                     f"max err {err}")
        for key in ("ms", "device_ms", "launches_per_call", "grid"):
            scan[key + tag] = scan[f"{key}{tag}_{own.design}"]
        scan["plain_ms" + tag] = cuda_ms(
            lambda: ref.mlstm_chunkwise_ref(q, k, v, logf, i), iters=20, warmup=3)
        b, by = scan_bound_ms(q, v)
        scan["bound_ms" + tag] = b
        if not tag:
            scan["bound_by"] = by
            got = kscan.mlstm_scan(q, k, v, logf, i)
            want = ref.mlstm_chunkwise_ref(q, k, v, logf, i)
            scan["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    # At hymba's admission shape (B = 8 x H = 25 SSD heads, dk 16, dv 64,
    # scale 1.0), under its own plan.
    q, k, v, logf, i = scan_inputs(200, 256, 16, 64, dt, 240)
    hymba = (lambda: kscan.mlstm_scan(q, k, v, logf, i, scale=1.0))
    scan["plan_hymba"] = kscan.scan_plan(200, 256, 16, 64).design
    scan["ms_hymba"] = cuda_ms(hymba, iters=20, warmup=3)
    (scan["device_ms_hymba"], scan["launches_per_call_hymba"],
     scan["grid_hymba"]) = device_ms_per_call(hymba, "mlstm_")
    scan["plain_ms_hymba"] = cuda_ms(lambda: ref.mlstm_chunkwise_ref(
        q, k, v, logf, i, scale=1.0), iters=20, warmup=3)
    scan["bound_ms_hymba"], scan["bound_by_hymba"] = scan_bound_ms(q, v)
    want = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=1.0).float()
    scan["max_abs_err_hymba"] = (hymba().float() - want).abs().max().item()
    if not scan["max_abs_err_hymba"] < SCAN_TOL[dt] * max(
            1.0, want.abs().max().item()):
        raise AssertionError(f"mlstm_scan at hymba's shape: max err "
                             f"{scan['max_abs_err_hymba']}")
    # At the bulk shape the chunk-parallel design's (a) local states and (c)
    # outputs each launch at least 128 blocks, by the traced grids.
    blocks = {n: int(np.prod(g))
              for n, g in scan["grid_bulk_chunk_parallel"].items()
              if "wgmma" in n}
    if len(blocks) != 2 or min(blocks.values()) < 128:
        raise AssertionError(f"mlstm_scan chunk-parallel at the bulk shape "
                             f"launched {blocks} blocks")
    scan["shape"] = ("BH=32 S=256 dk=dv=512 (B=8 H=4 admission; _bulk: BH=4 "
                     "S=500, B=1 bulk prefill; _hymba: BH=200 S=256 dk=16 "
                     "dv=64 scale 1.0) bf16")
    scan["library_ms"] = None
    torch.cuda.synchronize()
    for name, d in (("moe_topk", router), ("mlstm_scan", scan)):
        log("kernels.time", kernel=name, **d)
    router["max_abs_err_f32"] = worst_w["float32"]
    scan["max_abs_err_f32"] = worst_s["float32"]
    return {"moe_topk": router, "mlstm_scan": scan}


def scan_bwd_bound_ms(q, v) -> tuple:
    """K3's backward: q, k, v, dh and the two float32 gates read once, dq,
    dk, dv and the two gate gradients written once; 8 dk dv operations a
    step (twice the forward's 4 dk dv), at the inputs' peak rate."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    es = q.element_size()
    nbytes = (4 * q.numel() + 3 * v.numel()) * es + 4 * bh * s * 4
    ops = 8 * bh * s * dk * dv
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def router_bwd_bound_ms(logits, top_k: int) -> tuple:
    """K4's backward: the logits read and their gradient written once, the
    picks, weights and their gradient (T, k) and the probability sums'
    gradient (E,) read once; about 10 float32 operations a logit (the
    softmax again, p o g, its sum, the gradient), at the float32 rate."""
    t, e = logits.shape
    nbytes = 2 * logits.numel() * logits.element_size() + 12 * t * top_k + 4 * e
    ops = 10 * t * e
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def scan_bwd_inputs(bh, s, dk, dv, dtype, seed, qk: float, ssd: bool):
    """q, k scaled by ``qk`` (so that some rows have |a| > 1 and others
    not), v, dh; the gates logsigmoid / sigmoid, or hymba's SSD gates
    (decay -dt, input weight dt, dt = softplus)."""
    F = torch.nn.functional
    q = (randn((bh, s, dk), torch.float32, seed) * qk).to(dtype)
    k = (randn((bh, s, dk), torch.float32, seed + 1) * qk).to(dtype)
    v = randn((bh, s, dv), dtype, seed + 2)
    dh = randn((bh, s, dv), dtype, seed + 3)
    g = randn((bh, s), torch.float32, seed + 4)
    if ssd:
        dt = F.softplus(g * 1.5)
        return q, k, v, -dt, dt, dh
    return (q, k, v, F.logsigmoid(g + 2.0),
            torch.sigmoid(randn((bh, s), torch.float32, seed + 5)), dh)


def normaliser_share(q, k, logf, i, scale) -> float:
    """The share of rows with |a_t| > 1, a_t = q~_t . n_t, by the
    step-by-step recurrence of n in float32."""
    q, k = q.float() * scale, k.float()
    n = torch.zeros_like(k[:, 0])
    above = 0
    for t in range(q.shape[1]):
        n = logf[:, t, None].exp() * n + i[:, t, None] * k[:, t]
        above += int(((q[:, t] * n).sum(-1).abs() > 1).sum())
    return above / (q.shape[0] * q.shape[1])


def grad_errors(got, want) -> tuple:
    """The worst max error over max(1, max |plain|) and the worst norm
    error of each output, where an output's plain gradient is exactly 0
    the kernel's must be exactly 0 too (norm error 0, else inf)."""
    worst = worst_norm = 0.0
    for g, w in zip(got, want):
        w = w.float()
        worst = max(worst, ((g.float() - w).abs().max()
                            / max(1.0, w.abs().max().item())).item())
        if w.norm() == 0:
            worst_norm = max(worst_norm, 0.0 if (g == 0).all() else np.inf)
        else:
            worst_norm = max(worst_norm, norm_err(g, w))
    return worst, worst_norm


# bf16 backward kernels on the tensor cores, and the CUDA-core kernels
# they replaced on the bf16 path (float32 still runs those): K3's, and K1's
# at MLA's (192, 128)
SCAN_BWD_BF16 = ("scan_bwd_walk_wgmma_kernel", "scan_bwd_norm_wgmma_kernel",
                 "scan_bwd_grad_wgmma_kernel")
SCAN_BWD_F32 = ("scan_bwd_outer_kernel", "scan_bwd_carry_kernel",
                "scan_bwd_norm_kernel", "scan_bwd_grad_kernel")
FLASH_BWD_BF16 = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel")
FLASH_BWD_F32 = ("bwd_dkdv_kernel", "bwd_dq_kernel")


def check_ran(names, want: tuple, not_want: tuple, what: str) -> None:
    """Every kernel of ``want`` and none of ``not_want`` among the kernel
    names the profiler saw."""
    missing = [n for n in want if n not in names]
    stale = [n for n in not_want if n in names]
    if missing or stale:
        raise AssertionError(f"{what}: the profiler saw {sorted(names)}; "
                             f"missing {missing}, not wanted {stale}")


def backward2_phase(ref, kflash, kscan, kmoe, capacity) -> dict:
    """The backward kernels this slice adds, against their plain versions
    (float32 1e-4, bf16 3e-2, of max(1, max |plain|), and the error's norm
    within ``NORM_TOL`` of the plain gradient's): K3's backward at xlstm's
    dk = dv = 512, hymba's SSD heads (dk 16, dv 64, scale 1.0), a ragged S
    and S below one chunk, with rows on both sides of |a| = 1; K4's at
    decode, at a qwen2-moe training micro-batch and at deepseek's E 256 /
    k 8, with and without the probability sums' gradient; K1's at MLA's
    (192, 128) and at hymba's training shape (window 1024).  Then each
    timed at its training shape in bf16, where K3 (xlstm's 16 x 2048 and
    hymba's 50 x 2048) and K1 at (192, 128) (deepseek's B 1, S 2048, 128
    heads) are held to the same bf16 bounds again.  Returns the
    kernels-line entries."""
    F = torch.nn.functional
    out = {}
    # ---- K3
    scan_shapes = [
        # bh, s, dk, dv, scale, qk, ssd
        (4, 256, 512, 512, None, 1.0, False),   # xlstm-350m heads
        (50, 256, 16, 64, 1.0, 0.5, True),      # hymba's SSD heads
        (2, 150, 512, 512, None, 1.0, False),   # ragged S
        (3, 37, 16, 64, 1.0, 0.5, True),        # S below one chunk
    ]
    errs, shares = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).replace("torch.", "")
        worst = worst_norm = 0.0
        for j, (bh, s, dk, dv, scale, qk, ssd) in enumerate(scan_shapes):
            q, k, v, logf, i, dh = scan_bwd_inputs(bh, s, dk, dv, dt,
                                                   700 + 10 * j, qk, ssd)
            got = kscan.mlstm_scan_bwd(q, k, v, logf, i, dh, scale=scale)
            want = ref.mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh,
                                               scale=scale)
            e, ne = grad_errors(got, want)
            if not (e < TOL[dt] and ne < NORM_TOL[dt]):
                raise AssertionError(f"mlstm_scan_bwd {dt} {scan_shapes[j]}: "
                                     f"error {e}, norm error {ne}")
            worst, worst_norm = max(worst, e), max(worst_norm, ne)
            if dt == torch.float32:
                shares[str(scan_shapes[j][:4])] = normaliser_share(
                    q, k, logf, i, dk ** -0.5 if scale is None else scale)
        errs[key] = (worst, worst_norm)
    if not all(0 < x < 1 for x in shares.values()):
        raise AssertionError(f"mlstm_scan_bwd: rows with |a| > 1 by shape "
                             f"{shares}; both branches must run")
    # ---- K4
    route_shapes = [(8, 64, 4, 60, 1.0), (2048, 64, 4, 60, 1.0),
                    (2048, 256, 8, 256, 2.5)]
    rerrs = {}
    for dt in (torch.float32, torch.bfloat16):
        worst = worst_norm = 0.0
        for j, (t, e, k, n_valid, rs) in enumerate(route_shapes):
            logits = randn((t, e), dt, 800 + j)
            r = kmoe.moe_route(logits, k, capacity=capacity(t, k, 1.25, e),
                               n_valid=n_valid, router_scale=rs)
            dw = randn((t, k), torch.float32, 810 + j)
            dps = randn((e,), torch.float32, 820 + j)
            for sums in (dps, None):
                got = kmoe.moe_route_bwd(logits, r.idx, r.weights, dw, sums,
                                         n_valid=n_valid, router_scale=rs)
                want = ref.moe_route_bwd_ref(logits, r.idx, r.weights, dw,
                                             sums, n_valid=n_valid,
                                             router_scale=rs)
                er, ne = grad_errors([got], [want])
                if not (er < TOL[dt] and ne < NORM_TOL[dt]
                        and (got[:, n_valid:] == 0).all()):
                    raise AssertionError(f"moe_route_bwd {dt} "
                                         f"{route_shapes[j]}: error {er}, "
                                         f"norm error {ne}")
                worst, worst_norm = max(worst, er), max(worst_norm, ne)
        rerrs[str(dt).replace("torch.", "")] = (worst, worst_norm)
    # ---- K1 at (192, 128) and at hymba's training shape
    flash_shapes = [
        # b, s, h, kh, hd, hdv, window, scale
        (1, 1024, 32, 32, 192, 128, 0, 192 ** -0.5),   # MLA, causal
        (2, 2048, 25, 5, 64, 64, 1024, None),          # hymba training
    ]
    ferrs = {}
    for dt in (torch.float32, torch.bfloat16):
        worst = worst_norm = 0.0
        for j, (b, s, h, kh, hd, hdv, window, sc) in enumerate(flash_shapes):
            q = randn((b, s, h, hd), dt, 830 + j)
            k = randn((b, s, kh, hd), dt, 840 + j)
            v = randn((b, s, kh, hdv), dt, 850 + j)
            do = randn((b, s, h, hdv), dt, 860 + j)
            o, lse = kflash.flash_attention(q, k, v, window=window, scale=sc,
                                            return_lse=True)
            got = kflash.flash_attention_bwd(q, k, v, o, lse, do,
                                             window=window, scale=sc)
            po, plse = ref.grouped_flash_ref(q, k, v, window=window, scale=sc,
                                             return_lse=True)
            want = ref.grouped_flash_bwd_ref(q, k, v, po, plse, do,
                                             window=window, scale=sc)
            e, ne = grad_errors(got, want)
            if not (e < TOL[dt] and ne < NORM_TOL[dt]):
                raise AssertionError(f"flash_attention_bwd {dt} "
                                     f"{flash_shapes[j]}: error {e}, norm "
                                     f"error {ne}")
            worst, worst_norm = max(worst, e), max(worst_norm, ne)
            del got, want, po, plse
        ferrs[str(dt).replace("torch.", "")] = (worst, worst_norm)
    torch.cuda.synchronize()
    log("kernels.parity.bwd2", mlstm_scan_bwd=errs, moe_route_bwd=rerrs,
        flash_attention_bwd_192_128_and_hymba=ferrs,
        scan_rows_above_1_by_shape=shares,
        shapes={"mlstm_scan_bwd": [list(x[:4]) for x in scan_shapes],
                "moe_route_bwd": route_shapes, "flash": flash_shapes},
        tolerance={"max": "f32 1e-4, bf16 3e-2, x max(1, max|plain|)",
                   "norm": {"float32": NORM_TOL[torch.float32],
                            "bfloat16": NORM_TOL[torch.bfloat16]}})

    # ---- times at the training shapes, bf16
    dt = torch.bfloat16
    # K3: xlstm-350m at B = 4 (16 row-heads), S = 2048; hymba's SSD heads
    # at B = 2 (50 row-heads), S = 2048 (train.families' shapes)
    d = {}
    for tag, (bh, s, dk, dv, scale, qk, ssd) in (
            ("", (16, 2048, 512, 512, None, 1.0, False)),
            ("_hymba", (50, 2048, 16, 64, 1.0, 0.5, True))):
        q, k, v, logf, i, dh = scan_bwd_inputs(bh, s, dk, dv, dt, 900, qk, ssd)

        def call(q=q, k=k, v=v, logf=logf, i=i, dh=dh, scale=scale):
            return kscan.mlstm_scan_bwd(q, k, v, logf, i, dh, scale=scale)
        d["ms" + tag] = cuda_ms(call, iters=5, warmup=2)
        d["plain_ms" + tag] = cuda_ms(lambda: ref.mlstm_chunkwise_bwd_ref(
            q, k, v, logf, i, dh, scale=scale), iters=2, warmup=1)
        (d["device_ms" + tag], d["launches_per_call" + tag],
         d["grid" + tag]) = device_ms_per_call(call, "scan_bwd", iters=3,
                                              max_per_call=7)
        d["device_ms_by_kernel" + tag] = device_ms_by_kernel(call, "scan_bwd",
                                                             iters=3)
        check_ran(d["device_ms_by_kernel" + tag], SCAN_BWD_BF16,
                  SCAN_BWD_F32, f"mlstm_scan_bwd bf16 BH {bh} dk {dk}")
        d["bound_ms" + tag], by = scan_bwd_bound_ms(q, v)
        if not tag:
            d["bound_by"] = by
        # held at the training shape too: many chunks through the carries
        got = call()
        want = ref.mlstm_chunkwise_bwd_ref(q, k, v, logf, i, dh, scale=scale)
        d["max_abs_err" + tag] = max((g.float() - w.float()).abs().max().item()
                                     for g, w in zip(got, want))
        e, d["norm_err" + tag] = grad_errors(got, want)
        if not (e < TOL[dt] and d["norm_err" + tag] < NORM_TOL[dt]):
            raise AssertionError(f"mlstm_scan_bwd {dt} BH {bh} S {s} dk {dk} "
                                 f"dv {dv}: error {e}, norm error "
                                 f"{d['norm_err' + tag]}")
        del got, want
    d["library_ms"] = None
    d["library"] = "none: no PyTorch call computes the scan or its gradient"
    d["max_abs_err_f32"] = errs["float32"][0]
    d["shape"] = ("BH=16 S=2048 dk=dv=512 (xlstm-350m, B=4 H=4; _hymba: "
                  "BH=50 S=2048 dk=16 dv=64 scale 1.0) bf16")
    log("kernels.time", kernel="mlstm_scan_bwd", **d)
    out["mlstm_scan_bwd"] = d
    free_device_memory()

    # K4: one qwen2-moe training micro-batch (B = 2 x S = 1024 tokens);
    # deepseek's E 256 / k 8 at 2048 tokens
    d = {}
    for tag, (t, e, k, n_valid, rs) in (("", (2048, 64, 4, 60, 1.0)),
                                        ("_deepseek", (2048, 256, 8, 256,
                                                       2.5))):
        logits = randn((t, e), dt, 910 + e)
        r = kmoe.moe_route(logits, k, capacity=capacity(t, k, 1.25, e),
                           n_valid=n_valid, router_scale=rs)
        dw = randn((t, k), torch.float32, 911)
        dps = randn((e,), torch.float32, 912)

        def call(logits=logits, r=r, dw=dw, dps=dps, n_valid=n_valid, rs=rs):
            return kmoe.moe_route_bwd(logits, r.idx, r.weights, dw, dps,
                                      n_valid=n_valid, router_scale=rs)
        d["ms" + tag] = cuda_ms(call)
        d["plain_ms" + tag] = cuda_ms(lambda: ref.moe_route_bwd_ref(
            logits, r.idx, r.weights, dw, dps, n_valid=n_valid,
            router_scale=rs))
        d["device_ms" + tag] = device_ms(call, "router_bwd_kernel", alone=True)
        d["bound_ms" + tag], by = router_bwd_bound_ms(logits, k)
        if not tag:
            d["bound_by"] = by
            d["max_abs_err"] = (call().float() - ref.moe_route_bwd_ref(
                logits, r.idx, r.weights, dw, dps, n_valid=n_valid,
                router_scale=rs).float()).abs().max().item()
    d["library_ms"] = None
    d["library"] = "none: no PyTorch call computes the router's gradient"
    d["max_abs_err_f32"] = rerrs["float32"][0]
    d["shape"] = ("T=2048 E=64 n_valid=60 k=4 (qwen2-moe training micro-"
                  "batch; _deepseek: T=2048 E=256 k=8 scale 2.5) bf16")
    log("kernels.time", kernel="moe_route_bwd", **d)
    out["moe_route_bwd"] = d

    # K1 at (192, 128): deepseek-v3's training shape (B = 1, S = 2048, 128
    # heads); SDPA's backward on the same inputs as the library call
    b, s, h = 1, 2048, 128
    sc = 192 ** -0.5
    q, k = (randn((b, s, h, 192), dt, 920 + j) for j in range(2))
    v, do = (randn((b, s, h, 128), dt, 922 + j) for j in range(2))
    o, lse = kflash.flash_attention(q, k, v, scale=sc, return_lse=True)

    def call():
        return kflash.flash_attention_bwd(q, k, v, o, lse, do, scale=sc)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=sc)
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(sdpa_out, (qt, kt, vt), dot,
                                   retain_graph=True)
    d = {"ms": cuda_ms(call, iters=3, warmup=1),
         "plain_ms": cuda_ms(lambda: ref.grouped_flash_bwd_ref(
             q, k, v, o, lse, do, scale=sc), iters=2, warmup=1),
         "library_ms": cuda_ms(library, iters=10, warmup=2)}
    d["library_backend"], d["library_kernels"] = sdpa_backend(library)
    d["device_ms"], d["launches_per_call"], d["grid"] = device_ms_per_call(
        call, "bwd_d", iters=3, max_per_call=3)
    d["device_ms_by_kernel"] = device_ms_by_kernel(call, "bwd_d", iters=3)
    check_ran(d["device_ms_by_kernel"], FLASH_BWD_BF16, FLASH_BWD_F32,
              "flash_attention_bwd bf16 (192, 128)")
    d["bound_ms"], d["bound_by"] = flash_bwd_bound_ms(q, k, True, 0, hdv=128)
    got = call()
    po, plse = ref.grouped_flash_ref(q, k, v, scale=sc, return_lse=True)
    want = ref.grouped_flash_bwd_ref(q, k, v, po, plse, do, scale=sc)
    d["max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                           for g, w in zip(got, want))
    e, d["norm_err"] = grad_errors(got, want)
    if not (e < TOL[dt] and d["norm_err"] < NORM_TOL[dt]):
        raise AssertionError(f"flash_attention_bwd {dt} (192, 128) B {b} S {s} "
                             f"H {h}: error {e}, norm error {d['norm_err']}")
    d["max_abs_err_f32"] = ferrs["float32"][0]
    d["design"] = ("bf16: bwd_delta_kernel, flash_bwd_dkdv_wgmma_kernel<192, "
                   "128> (dV and dK blocks apart), flash_bwd_dq_wgmma_kernel"
                   "<192, 128> on wgmma; float32: bwd_dkdv_kernel, "
                   "bwd_dq_kernel on the CUDA cores")
    d["shape"] = "B=1 S=2048 H=KH=128 dk=192 dv=128 causal bf16 (deepseek-v3)"
    del got, want, po, plse, sdpa_out, qt, kt, vt
    # hymba's training shape (bf16 runs the wgmma kernels at hd 64)
    b, s, h, kh = 2, 2048, 25, 5
    q, do = (randn((b, s, h, 64), dt, 930 + j) for j in range(2))
    k, v = (randn((b, s, kh, 64), dt, 932 + j) for j in range(2))
    o, lse = kflash.flash_attention(q, k, v, window=1024, return_lse=True)

    def hymba():
        return kflash.flash_attention_bwd(q, k, v, o, lse, do, window=1024)
    d["device_ms_hymba"], _, _ = device_ms_per_call(hymba, "bwd_d", iters=3,
                                                    max_per_call=3)
    d["bound_ms_hymba"], _ = flash_bwd_bound_ms(q, k, True, 1024)
    d["shape_hymba"] = "B=2 S=2048 H=25 KH=5 hd=64 window 1024 bf16"
    log("kernels.time", kernel="flash_attention_bwd_mla", **d)
    out["flash_attention_bwd_mla"] = d
    free_device_memory()
    return out


# ------------------------------------------------------------ phases 4, 5
@contextlib.contextmanager
def plain_kernels(ops, ref):
    """Swap every kernel for its plain version, on the card.  Used only
    here, to hold the kernel path against the plain path."""
    names = ("grouped_flash", "grouped_decode", "mlstm_scan", "moe_topk",
             "moe_route")
    plain = (ref.grouped_flash_ref, ref.grouped_decode_ref,
             ref.mlstm_chunkwise_ref, ref.moe_topk_ref, ref.moe_route_ref)
    saved = [getattr(ops, n) for n in names]
    for n, f in zip(names, plain):
        setattr(ops, n, f)
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(ops, n, f)


def stub_inputs(cfg, b: int, seed: int) -> dict:
    """The stub frontends' inputs for ``b`` rows, from a seed: an
    enc-dec's audio frames (b, encoder_len, d_model), N(0, 1), and a VLM's
    vision embeddings (b, vision_tokens, d_model) at the token embeddings'
    scale, 0.02; none for other families."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.vision_tokens:
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.vision_tokens, cfg.d_model))).astype(np.float32)
    return out


def run_ragged(model, params, prompts, smax: int, steps: int):
    """prefill_batch on right-padded prompts (with the family's stub
    inputs from seed 4), then greedy decode steps at the shared position
    the engine uses.  Returns the logits of every step and the greedy
    tokens."""
    lengths = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), int(lengths.max())), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    logits, caches = model.prefill_batch(
        params, {"tokens": toks, "lengths": lengths,
                 **stub_inputs(model.cfg, len(prompts), 4)}, smax)
    out, tokens = [logits[:, 0]], []
    pos = int(lengths.max())
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1)
        tokens.append(tok.cpu())
        logits, caches = model.decode_step(params, caches, tok[:, None], pos)
        out.append(logits[:, 0])
        pos += 1
    tokens.append(logits[:, -1].argmax(-1).cpu())
    return torch.stack(out), torch.stack(tokens)


def model_phase(model, params, ops, ref, vocab: int,
                lengths=(37, 64, 100, 128), smax: int = 256,
                held: bool = True) -> None:
    """Float32 kernel path against plain path over ``run_ragged``: logits
    within MODEL_TOL (``held``) and greedy tokens identical, the error
    printed beside the noise floor (see below).  A run that is not
    ``held`` holds the tokens only."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]
    lk, tk = run_ragged(model, params, prompts, smax, 8)
    with plain_kernels(ops, ref):
        lp, tp = run_ragged(model, params, prompts, smax, 8)
    err = (lk - lp).abs().max().item()
    floor = noise_floor(model, params, ops, ref, prompts, smax, lp)
    finite = bool(torch.isfinite(lk).all())
    cfg = model.cfg
    log("model", arch=cfg.name, dtype="float32", layers=cfg.n_layers,
        encoder_layers=cfg.encoder_layers, first_k_dense=cfg.first_k_dense,
        stub_inputs=sorted(stub_inputs(cfg, 1, 4)),
        d_model=cfg.d_model, head_dim=cfg.hd,
        prompt_lengths=list(lengths), smax=smax,
        window=cfg.sliding_window, logits_shape=list(lk.shape),
        max_abs_err=err, tolerance=MODEL_TOL if held else None,
        noise_floor=floor, tokens_identical=bool(torch.equal(tk, tp)),
        finite=finite)
    if not (finite and (err < MODEL_TOL or not held) and torch.equal(tk, tp)):
        raise AssertionError(f"{cfg.name}: kernel path disagrees with "
                             f"the plain path: max err {err}, tokens "
                             f"{tk.tolist()} vs {tp.tolist()}")


def noise_floor(model, params, ops, ref, prompts, smax: int, lp) -> float:
    """How far the plain path's own logits move when its token embeddings
    are scaled by 1 + 1e-6 N(0, 1), a few float32 roundings: the error a
    kernel path that sums in another order cannot be told apart from."""
    from repro_torch.models import layers
    embed = layers.embed

    def noisy(p, tokens):
        x = embed(p, tokens)
        g = torch.Generator(device=x.device).manual_seed(5)
        return x * (1 + 1e-6 * torch.randn(x.shape, generator=g,
                                           device=x.device))

    layers.embed = noisy
    try:
        with plain_kernels(ops, ref):
            ln, _ = run_ragged(model, params, prompts, smax, 8)
    finally:
        layers.embed = embed
    return (ln - lp).abs().max().item()


def engine_phase(model, params, build_kernel, InferenceEngine, Request,
                 vocab: int, prompt_len: int = 50) -> None:
    prompt = np.random.default_rng(2).integers(0, vocab, prompt_len) \
        .astype(np.int32)
    logits, caches = model.prefill(params, {"tokens": prompt[None]}, 256)
    direct = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    while len(direct) < 4:
        logits, caches = model.decode_step(
            params, caches, torch.tensor([[direct[-1]]], device=model.device),
            pos)
        direct.append(int(logits[0, -1].argmax()))
        pos += 1
    kernel = build_kernel("live", policy="ufs", n_slots=1)
    engine = InferenceEngine(model, params, kernel, max_batch=2, max_len=256)
    kernel.start()
    engine.start()
    try:
        req = engine.submit(Request(prompt=prompt, max_new_tokens=4))
        done = req.done_event.wait(timeout=120)
    finally:
        engine.stop()
        kernel.stop()
    torch.cuda.synchronize()
    log("engine", arch=model.cfg.name, prompt_len=prompt_len,
        capacity_factor=model.capacity_factor, direct=direct,
        engine=req.tokens, finished=done, ok=req.ok)
    if not (done and req.ok and req.tokens[:4] == direct):
        raise AssertionError(f"{model.cfg.name}: engine tokens {req.tokens} "
                             f"!= direct {direct}")


def train_check_phase(ops, ref, Model, trainer, get_arch) -> None:
    """Float32 training check: llama3.2-1b at full width with 2 layers,
    one ``train_loss`` and its gradient on B=2, S=1024 (remat on, as the
    config has it), kernel path (K1 and its backward) against the plain
    path: loss to 1e-5, every gradient leaf to 1e-3 of its own max
    |plain| (at init the leaves are far below 1, so a floor of 1 would
    hold nothing)."""
    from repro_torch.models.weights import tree_leaves
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), dtype="float32",
                              n_layers=2)
    model = Model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 1025)), device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = trainer.value_and_grad(model, params, batch)
    with plain_kernels(ops, ref):
        ploss, pgrads = trainer.value_and_grad(model, params, batch)
    errs = [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(tree_leaves(grads), tree_leaves(pgrads))]
    loss_err = abs(loss.item() - ploss.item())
    log("train.check", arch=cfg.name, dtype="float32", layers=cfg.n_layers,
        batch=[2, 1024], remat=cfg.remat, loss=loss.item(),
        loss_err=loss_err, grad_leaves=len(errs), grad_max_rel_err=max(errs),
        tolerance={"loss": 1e-5, "grads": "1e-3 x max|plain leaf|"})
    if not (loss_err < 1e-5 and max(errs) < MODEL_TOL):
        raise AssertionError(f"training check: loss error {loss_err}, "
                             f"gradient errors {errs}")


# ---------------------------------------------------------------- phase 6
def bf16_prefill_phase(model, params, ops, ref, vocab: int,
                       lengths=(64, 100, 128, 180, 200, 220, 240, 256)) -> None:
    """bfloat16 prefill_batch of 8 ragged prompts (with the family's stub
    inputs) at full width and depth, kernel path against plain path: the
    logits' max abs error is printed (the float32 check of phase 4 is the
    one held to a tolerance).  Beside it, as the yardstick of what bfloat16
    alone moves, both paths against the plain path of a float32 copy of the
    model on the same weights."""
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import tree_map
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]
    lengths = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), int(lengths.max())), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    batch = {"tokens": toks, "lengths": lengths,
             **stub_inputs(model.cfg, len(prompts), 5)}
    lk, _ = model.prefill_batch(params, batch, 256)
    with plain_kernels(ops, ref):
        lp, _ = model.prefill_batch(params, batch, 256)
    model32 = Model(dataclasses.replace(model.cfg, dtype="float32"),
                    device="cuda")
    params32 = tree_map(lambda t: t.float(), params)
    with plain_kernels(ops, ref):
        l32, _ = model32.prefill_batch(params32, batch, 256)
    del model32, params32
    lk, lp = lk.float(), lp.float()
    finite = bool(torch.isfinite(lk).all())
    log("model.bf16_prefill", arch=model.cfg.name, dtype="bfloat16",
        prompt_lengths=lengths.tolist(), stub_inputs=sorted(
            stub_inputs(model.cfg, 1, 5)),
        logits_shape=list(lk.shape), max_abs_err=(lk - lp).abs().max().item(),
        max_abs_plain=lp.abs().max().item(),
        kernel_vs_float32_plain=(lk - l32).abs().max().item(),
        plain_vs_float32_plain=(lp - l32).abs().max().item(), finite=finite)
    if not finite:
        raise AssertionError(f"{model.cfg.name}: bf16 prefill_batch logits "
                             "are not finite")


def model_path_phase(model, params, counters, required, vocab: int) -> dict:
    """An encoder-decoder's path at model level (the engine passes no
    frames), bfloat16 at full width and depth: prefill_batch of 8 ragged
    prompts over their stub frames, then 31 greedy decode steps (the
    serving phase's 32 new tokens), with every count in ``counters`` set to
    0 just before and read just after; each kernel in ``required`` must
    have been launched, the logits must be finite and the tokens in the
    vocabulary."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, int(rng.integers(64, 257)))
               .astype(np.int32) for _ in range(8)]
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, tokens = run_ragged(model, params, prompts, 1024, 31)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: c.count for name, c in counters.items()}
    finite = bool(torch.isfinite(logits).all())
    in_vocab = bool(((tokens >= 0) & (tokens < vocab)).all())
    log("model.path", arch=model.cfg.name, dtype="bfloat16",
        prompt_lengths=[len(p) for p in prompts], decode_steps=31,
        wall_s=wall, launches=launches, finite=finite, in_vocab=in_vocab)
    if not (finite and in_vocab):
        raise AssertionError(f"{model.cfg.name}: logits finite {finite}, "
                             f"tokens in the vocabulary {in_vocab}")
    if not all(launches[n] > 0 for n in required):
        raise AssertionError(f"{model.cfg.name}: a kernel of its path was "
                             f"not launched: {launches}")
    return launches


def tree_bytes(tree, under: str | None = None) -> int:
    """Bytes of the tensors in a parameter tree; with ``under``, only of
    those below a dict key of that name."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v, None if k == under else under)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v, under) for v in tree)
    return 0 if under else tree.numel() * tree.element_size()


def pct(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def serving_phase(model, params, core, InferenceEngine, Request, counters,
                  required, vocab: int, background_train=None) -> dict:
    """The serving traffic on one model; every count in ``counters`` is set
    to 0 just before and read just after, and each kernel in ``required``
    must have been launched.  ``background_train`` (``serve.background_train``)
    adds the background training lane, which must take a step."""
    kernel = core.build_kernel("live", policy="ufs", n_slots=1)
    engine = InferenceEngine(model, params, kernel, max_batch=8, max_len=1024)
    rng = np.random.default_rng(0)
    bulk_prompts = [rng.integers(0, vocab, 500).astype(np.int32)
                    for _ in range(2)]
    ts_prompts = [rng.integers(0, vocab, int(rng.integers(64, 257)))
                  .astype(np.int32) for _ in range(8)]
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()     # weights and cache pool
    # A decode step of this design reads every weight but the embedding
    # table (8 rows of it), every routed expert's too (one slot an expert),
    # and takes at least those bytes over the card's memory rate.  A design
    # that read only the experts a step routes to would read at most
    # min(E, 8 k) of each MoE layer's E.
    step_bytes = tree_bytes(params) - tree_bytes(params["embed"]["table"])
    routed_bytes = step_bytes
    if model.cfg.moe is not None:
        e = model.cfg.moe.routed_total()
        reached = min(e, engine.max_batch * model.cfg.moe.top_k)
        routed_bytes -= tree_bytes(params, under="experts") * (1 - reached / e)
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    kernel.start()
    engine.start()
    lane = background_train(model, kernel) if background_train else None
    try:
        bulk = [engine.submit(Request(prompt=p, tier="background",
                                      max_new_tokens=32)) for p in bulk_prompts]
        ts = []
        for p in ts_prompts:
            ts.append(engine.submit(Request(prompt=p, max_new_tokens=32)))
            time.sleep(0.02)
        reqs = bulk + ts
        deadline = time.monotonic() + 120
        for r in reqs:
            r.done_event.wait(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        engine.stop()
        kernel.stop()
    torch.cuda.synchronize()
    launches = {name: c.count for name, c in counters.items()}
    bad = [(r.rid, r.error, len(r.tokens)) for r in reqs
           if not (r.ok and len(r.tokens) == 32
                   and all(0 <= t < vocab for t in r.tokens))]
    first = min(r.first_token for r in reqs if r.first_token is not None)
    last = max(r.finished for r in reqs if r.finished is not None)
    decode_tokens = sum(len(r.tokens) - 1 for r in reqs)
    ttft = [r.first_token - r.submitted for r in ts if r.first_token]
    itl = [b - a for r in ts for a, b in zip(r.token_times, r.token_times[1:])]
    result = {
        "requests": len(reqs), "ok": sum(r.ok for r in reqs),
        "wall_s": last - t0,
        "decode_tokens_per_s": decode_tokens / (last - first),
        "ttft_p50_ms": pct(ttft, 50) * 1e3, "ttft_p99_ms": pct(ttft, 99) * 1e3,
        "itl_p50_ms": pct(itl, 50) * 1e3, "itl_p99_ms": pct(itl, 99) * 1e3,
        "bulk_ttft_ms": [(r.first_token - r.submitted) * 1e3 for r in bulk
                         if r.first_token],
        "n_layers": model.cfg.n_layers,
        "decode_step_weight_bytes": step_bytes,
        "decode_step_weight_read_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
        "decode_step_routed_weight_read_ms":
            routed_bytes / HBM_BYTES_PER_S * 1e3,
        "launches": launches,
        "memory_allocated_at_start_bytes": held_before,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "engine": engine.stats.summary(),
    }
    if lane is not None:
        result["background_train_steps"] = lane["steps"]
        result["background_train_losses"] = lane["losses"]
    log("serving", arch=model.cfg.name, dtype="bfloat16",
        background_train=lane is not None, **result)
    print(core.KernelReport.from_kernel(kernel).pretty(), flush=True)
    if bad:
        raise AssertionError(f"requests that did not finish ok: {bad}")
    if not all(launches[n] > 0 for n in required):
        raise AssertionError(f"{model.cfg.name}: a kernel of its path was "
                             f"not launched while serving: {launches}")
    if lane is not None and not (lane["steps"] >= 1 and all(
            np.isfinite(lane["losses"]))):
        raise AssertionError(f"background train lane: {lane['steps']} "
                             f"steps, losses {lane['losses']}")
    return launches


# ---------------------------------------------------------------- phase 7
def busy_ms(fn, top: int = 10, named: tuple = ()) -> tuple:
    """Device time of every kernel in a profiler window over one call, the
    ``top`` kernels by device time: [name, ms, launches], and for each
    string of ``named`` the kernels whose name holds it: {string: [ms,
    launches]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count),
                  key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in rows) / 1e3,
            [[e.key[:90], e.self_device_time_total / 1e3, e.count]
             for e in rows[:top]],
            {n: [sum(e.self_device_time_total for e in rows if n in e.key)
                 / 1e3, sum(e.count for e in rows if n in e.key)]
             for n in named})


def active_params(cfg, params) -> int:
    """Parameters a token's forward touches: every leaf but the input
    embedding (the tied table counts once, as the unembedding), the
    encoder's aside, routed experts at top_k of their number."""
    from repro_torch.models.weights import tree_leaves
    n = 0
    for key, sub in params.items():
        if key == "encoder" or (key == "embed" and not cfg.tie_embeddings):
            continue
        n += sum(t.numel() for t in tree_leaves(sub))
    if cfg.moe is not None:
        routed = sum(t.numel() for seg in params["segments"]
                     if isinstance(seg, dict) and "ffn" in seg
                     and "experts" in seg["ffn"]
                     for t in tree_leaves(seg["ffn"]["experts"]))
        n -= routed - routed * cfg.moe.top_k // cfg.moe.routed_total()
    return n


def model_flops(cfg, params, b: int, s: int) -> float:
    """Model flops of one training step on b x s tokens: 6 a token per
    parameter it touches (``active_params``; the encoder's over its
    frames); 6 (dk + dv) a head for each kept (query, key) pair of every
    attention layer (Q K^T and P V, forward and backward): causal pairs,
    at most ``window`` keys in a windowed layer, the encoder's
    encoder_len^2 and the cross layers' S x encoder_len; and 12 dk dv a
    step per head of every scan (4 forward, 8 backward).  remat's
    recomputation is not counted."""
    from repro_torch.models.weights import tree_leaves
    flops = 6.0 * active_params(cfg, params) * b * s
    if cfg.mla is not None:
        dk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dk = dv = cfg.hd
    per_pair = 6.0 * (dk + dv) * cfg.n_heads * b
    if "encoder" in params:
        n_enc = sum(t.numel() for t in tree_leaves(params["encoder"]))
        flops += 6.0 * n_enc * b * cfg.encoder_len
        flops += per_pair * (cfg.encoder_len ** 2 * cfg.encoder_layers
                             + s * cfg.encoder_len * cfg.n_layers)
    if cfg.family == "ssm":
        hd = cfg.ssm.expand * cfg.d_model // cfg.n_heads
        n_m = cfg.n_layers - (cfg.n_layers // cfg.ssm.slstm_every
                              if cfg.ssm.slstm_every else 0)
        return flops + 12.0 * hd * hd * cfg.n_heads * b * s * n_m
    for layer in range(cfg.n_layers):
        w = 0 if layer in cfg.global_attn_layers else cfg.sliding_window
        flops += per_pair * flash_pairs(s, s, True, w)
    if cfg.family == "hybrid":
        n = cfg.ssm.state_dim
        flops += 12.0 * n * cfg.hd * cfg.n_heads * b * s * cfg.n_layers
    return flops


def run_steps(step, box: dict, batch, n: int, count, named: tuple) -> dict:
    """``n`` training steps of ``step`` on one batch, each timed on the
    host, peak memory reset just before, and the launch counts read by
    ``count()`` just after; then one more step in a profiler window
    (``busy_ms``).  The state lives only in ``box["state"]``, replaced
    step by step, so no older state outlives its step (the depth cuts of
    ``FAMILY_STEPS`` leave no room for one).  Returns the readings."""
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        box["state"], metrics = step(box["state"], batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    del metrics
    launches = count()
    peak = torch.cuda.max_memory_allocated()

    def one():
        box["state"], _ = step(box["state"], batch)
    busy, top, by_name = busy_ms(one, named=named)
    return {"launches": launches, "losses": losses, "walls": walls,
            "wall": float(np.median(walls[1:])), "peak": peak,
            "busy": busy, "top": top, "named": by_name}


def training_phase(Model, trainer, optimizer, get_arch, kflash) -> dict:
    """bf16 llama3.2-1b at full width and depth, S = 4096 (``train_4k``),
    B = 4 in two micro-batches, remat on: 4 AdamW steps on one fixed
    batch from ``SyntheticTokens``.  Every loss finite, the 4th below the
    1st; K1's forward and backward launches, set to 0 just before, both
    above 0.  Returns the launches."""
    from repro_torch.data.pipeline import SyntheticTokens
    cfg = get_arch("llama3.2-1b")
    b, s = 4, 4096
    model = Model(cfg, device="cuda")
    tcfg = trainer.TrainConfig(grad_accum=2, opt=optimizer.OptimizerConfig(
        lr=1e-4, warmup_steps=0, total_steps=4))
    box = {"state": trainer.init_state(
        model, tcfg, torch.Generator(device="cuda").manual_seed(0))}
    raw = SyntheticTokens(cfg.vocab_size, seed=0).batch(0, 0, b, s)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in raw.items()}
    step = trainer.make_train_step(model, tcfg)
    kflash.launches.reset()
    kflash.bwd_launches.reset()
    r = run_steps(step, box, batch, 4,
                  lambda: {"flash_attention": kflash.launches.count,
                           "flash_attention_bwd": kflash.bwd_launches.count},
                  ("flash_fwd", "bwd_d"))
    launches = r["launches"]
    losses, wall = r["losses"], r["wall"]
    flops = model_flops(cfg, box["state"]["params"], b, s)
    result = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
              "batch": b, "seq": s, "grad_accum": 2, "remat": cfg.remat,
              "losses": losses, "step_wall_ms": r["walls"],
              "step_wall_ms_median_2_4": wall, "step_busy_ms": r["busy"],
              "step_top_kernels": r["top"],
              "step_k1_ms_launches": {"forward": r["named"]["flash_fwd"],
                                      "backward": r["named"]["bwd_d"]},
              "tokens_per_s": b * s / wall * 1e3,
              "max_memory_allocated_bytes": r["peak"],
              "model_flops_per_step": flops,
              "model_flops_share_of_989_tflops": flops / (wall / 1e3) / 989e12,
              "launches": launches}
    log("train.steps", **result)
    if not (all(np.isfinite(losses)) and losses[3] < losses[0]):
        raise AssertionError(f"training losses {losses}")
    if not all(c > 0 for c in launches.values()):
        raise AssertionError(f"K1 launches on the training path: {launches}")
    del model, box, r, step
    return launches


# Each family's training cut: (arch, replace kwargs, batch B, S).  The
# float32 check runs full width at 2 layers; the bf16 steps at the depths
# the card holds with AdamW (see ``FAMILY_STEPS``).
FAMILY_CHECKS = [
    ("qwen2-moe-a2.7b", {"n_layers": 2}, 1, 1024),
    # its first 2 layers, both dense (of its 3): MLA at 192 / 128
    ("deepseek-v3-671b", {"n_layers": 2, "first_k_dense": 2}, 1, 512),
    ("xlstm-350m", {"n_layers": 2, "slstm_every": 2}, 2, 512),
    # a global layer, then a windowed one; S past the window
    ("hymba-1.5b", {"n_layers": 2, "global_attn_layers": (0,)}, 1, 1280),
    ("seamless-m4t-medium", {"n_layers": 2, "encoder_layers": 2}, 2, 256),
    ("internvl2-1b", {"n_layers": 2}, 2, 512),
]


def family_cfg(get_arch, arch: str, cut: dict, dtype: str):
    cfg = get_arch(arch)
    cut = dict(cut)
    if "slstm_every" in cut:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, slstm_every=cut.pop("slstm_every")))
    return dataclasses.replace(cfg, dtype=dtype, **cut)


def family_batch(cfg, b: int, s: int, seed: int, dtype) -> dict:
    """Tokens and labels from ``SyntheticTokens``, and the family's stub
    frames or vision embeddings from a seed."""
    from repro_torch.data.pipeline import SyntheticTokens
    raw = SyntheticTokens(cfg.vocab_size, seed=seed).batch(0, 0, b, s)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in raw.items()}
    if cfg.encoder_layers:
        batch["frames"] = randn((b, cfg.encoder_len, cfg.d_model), dtype,
                                seed + 1)
    if cfg.vision_tokens:
        batch["vision_embeds"] = randn((b, cfg.vision_tokens, cfg.d_model),
                                       dtype, seed + 2)
    return batch


def bwd_counters() -> dict:
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import mlstm_scan as kscan
    from repro_torch.kernels import moe_topk as kmoe
    return {"flash_attention": kflash.launches,
            "flash_attention_bwd": kflash.bwd_launches,
            "mlstm_scan": kscan.launches, "mlstm_scan_bwd": kscan.bwd_launches,
            "moe_topk": kmoe.launches, "moe_route_bwd": kmoe.bwd_launches}


def family_kernels(cfg) -> tuple:
    """The backward kernels a family's training must launch."""
    need = []
    if cfg.family != "ssm":
        need.append("flash_attention_bwd")
    if cfg.ssm is not None:
        need.append("mlstm_scan_bwd")
    if cfg.moe is not None and cfg.n_layers > cfg.first_k_dense:
        need.append("moe_route_bwd")
    return tuple(need)


def train_check_families_phase(ops, ref, Model, trainer, get_arch) -> dict:
    """Float32 training check of every other family at full width with 2
    layers (``FAMILY_CHECKS``), as llama's: one ``train_loss`` and its
    gradient, kernel path (the forward kernels and their backward kernels)
    against the plain path: loss to 1e-5, every gradient leaf to 1e-3 of
    its own max |plain|; the family's backward kernels launched."""
    from repro_torch.models.weights import tree_leaves
    counters = bwd_counters()
    out = {}
    for j, (arch, cut, b, s) in enumerate(FAMILY_CHECKS):
        t0 = time.monotonic()
        cfg = family_cfg(get_arch, arch, cut, "float32")
        model = Model(cfg, device="cuda")
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        batch = family_batch(cfg, b, s, 40 + j, torch.float32)
        for c in counters.values():
            c.reset()
        loss, grads = trainer.value_and_grad(model, params, batch)
        launches = {n: c.count for n, c in counters.items()}
        with plain_kernels(ops, ref):
            ploss, pgrads = trainer.value_and_grad(model, params, batch)
        errs = [((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
                for g, w in zip(tree_leaves(grads), tree_leaves(pgrads))
                if w.numel()]
        loss_err = abs(loss.item() - ploss.item())
        need = family_kernels(cfg)
        out[arch] = {"loss": loss.item(), "loss_err": loss_err,
                     "grad_leaves": len(errs), "grad_max_rel_err": max(errs),
                     "launches": launches}
        log("train.check", arch=arch, dtype="float32", layers=cfg.n_layers,
            cut=cut, batch=[b, s], remat=cfg.remat, loss=loss.item(),
            loss_err=loss_err, grad_leaves=len(errs),
            grad_max_rel_err=max(errs), launches=launches,
            backward_kernels=need, seconds=time.monotonic() - t0,
            tolerance={"loss": 1e-5, "grads": "1e-3 x max|plain leaf|"})
        if not (loss_err < 1e-5 and max(errs) < MODEL_TOL):
            raise AssertionError(f"training check {arch}: loss error "
                                 f"{loss_err}, gradient errors {errs}")
        if not all(launches[n] > 0 for n in need):
            raise AssertionError(f"training check {arch}: backward kernels "
                                 f"{need}, launches {launches}")
        del model, params, grads, pgrads, batch
        free_device_memory()
    return out


# bf16 AdamW steps of every other family: (arch, cut, B, S, what the cut
# is).  AdamW keeps float32 m and v, and a step is out of place (the state
# of step N stays whole while step N + 1's is built), so a parameter costs
# 2 (bf16) + 2 (gradient) + 8 (m, v) + 10 (the new parameter, m and v)
# = 22 bytes at the step's peak.
FAMILY_STEPS = [
    ("xlstm-350m", {}, 4, 2048, "full size"),
    ("hymba-1.5b", {}, 2, 2048, "full size; S past the 1024 window"),
    ("seamless-m4t-medium", {}, 4, 512, "full size, frames (4, 1024, 1024)"),
    ("internvl2-1b", {}, 4, 1024, "full size, 256 vision embeddings"),
    # 3 x 605 M + 622 M of embeddings = 2.44 B parameters, 53.6 GB at 22
    # bytes; 4 layers (3.04 B, 66.9 GB) leave too little of the 80 GB for
    # the largest leaf's float32 update (3.7 GB) and the activations
    ("qwen2-moe-a2.7b", {"n_layers": 3}, 2, 1024,
     "full width, 3 of 24 layers (AdamW state: 22 bytes a parameter)"),
    # its first layer: 583 M + 2 x 927 M of embeddings = 2.44 B, 53.6 GB;
    # 2 layers (3.02 B, 66.4 GB) ran out of the card's 79.2 GiB in the
    # update; one MoE layer (11.3 B) would need 250 GB: E 256 / k 8 is
    # held by the kernel check
    ("deepseek-v3-671b", {"n_layers": 1, "first_k_dense": 1}, 1, 2048,
     "full width, its first layer (dense FFN, MLA); no MoE layer"),
]
# AdamW's learning rate; deepseek's first step at 1e-4 (its FFN reads
# 18432 features) threw the loss from 12.29 to 30.70 before it fell
FAMILY_LR = {"deepseek-v3-671b": 1e-5}


def train_families_phase(Model, trainer, optimizer, get_arch) -> dict:
    """bf16 training of every other family (``FAMILY_STEPS``): 4 AdamW
    steps on one batch, remat as configured.  Losses finite and falling;
    the family's backward kernels (and their forwards) launched, counts
    set to 0 just before.  Step wall and busy ms, tokens/s, model-flops
    share and peak memory.  Returns each family's launches."""
    counters = bwd_counters()
    out = {}
    for j, (arch, cut, b, s, why) in enumerate(FAMILY_STEPS):
        t0 = time.monotonic()
        cfg = family_cfg(get_arch, arch, cut, "bfloat16")
        model = Model(cfg, device="cuda")
        tcfg = trainer.TrainConfig(opt=optimizer.OptimizerConfig(
            lr=FAMILY_LR.get(arch, 1e-4), warmup_steps=0, total_steps=4))
        box = {"state": trainer.init_state(
            model, tcfg, torch.Generator(device="cuda").manual_seed(0))}
        batch = family_batch(cfg, b, s, 60 + j, torch.bfloat16)
        step = trainer.make_train_step(model, tcfg)
        for c in counters.values():
            c.reset()
        named = ("scan_bwd", "router_bwd", "bwd_d", *SCAN_BWD_BF16,
                 *SCAN_BWD_F32, *FLASH_BWD_BF16, *FLASH_BWD_F32)
        r = run_steps(step, box, batch, 4,
                      lambda: {n: c.count for n, c in counters.items()},
                      named)
        launches = r["launches"]
        losses, wall = r["losses"], r["wall"]
        flops = model_flops(cfg, box["state"]["params"], b, s)
        need = family_kernels(cfg)
        result = {"arch": arch, "cut": why, "layers": cfg.n_layers,
                  "dtype": cfg.dtype, "batch": b, "seq": s,
                  "lr": tcfg.opt.lr,
                  "remat": cfg.remat, "losses": losses,
                  "step_wall_ms": r["walls"], "step_wall_ms_median_2_4": wall,
                  "step_busy_ms": r["busy"], "step_top_kernels": r["top"],
                  "step_bwd_kernels_ms_launches": r["named"],
                  "tokens_per_s": b * s / wall * 1e3,
                  "max_memory_allocated_bytes": r["peak"],
                  "model_flops_per_step": flops,
                  "model_flops_share_of_989_tflops":
                      flops / (wall / 1e3) / 989e12,
                  "launches": launches, "backward_kernels": need,
                  "seconds": time.monotonic() - t0}
        log("train.families", **result)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{arch} training losses {losses}")
        if not all(launches[n] > 0 for n in need):
            raise AssertionError(f"{arch} training: backward kernels {need}, "
                                 f"launches {launches}")
        # the bf16 backward kernels the step ran, by the profiler: the
        # tensor-core ones and none of the CUDA-core ones
        want, stale = (), ()
        if "mlstm_scan_bwd" in need:
            want, stale = want + SCAN_BWD_BF16, stale + SCAN_BWD_F32
        if "flash_attention_bwd" in need:
            want, stale = want + FLASH_BWD_BF16, stale + FLASH_BWD_F32

        def one():
            box["state"], _ = step(box["state"], batch)
        seen = r["named"]
        for _ in range(2):      # a window that lost device events: again
            if all(seen[n][1] for n in want):
                break
            seen = busy_ms(one, named=named)[2]
        check_ran({n for n, (_, c) in seen.items() if c}, want, stale,
                  f"{arch} training")
        log("train.families.kernels", arch=arch,
            bwd_kernels_ms_launches={n: v for n, v in seen.items() if v[1]})
        out[arch] = launches
        del model, box, r, step, batch
        free_device_memory()
    return out


def scheduled_train_phase(train) -> dict:
    """``launch/train.py --scheduled`` at llama3.2-1b's full width with 2
    layers: 6 steps with a checkpoint every 2 and a crash after 4, then
    ``--resume``, then an uninterrupted unscheduled run.  Losses 5-6 of the
    resumed run equal the uninterrupted run's, 1-4 of the crashed run too;
    the scheduled save of step 2 (which runs after later steps) equals the
    unscheduled one, leaf for leaf by the manifests' sha256.  The
    checkpoints live in a temporary directory under ``build/``, removed
    after."""
    import shutil
    import tempfile
    base = ["--arch", "llama3.2-1b", "--n-layers", "2", "--steps", "6",
            "--batch", "2", "--seq", "256", "--ckpt-every", "2",
            "--log-every", "1", "--device", "cuda"]
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build")
    try:
        sched, plain = f"{tmp}/scheduled", f"{tmp}/plain"
        t0 = time.monotonic()
        first = train.run(train.parse_args(
            base + ["--ckpt-dir", sched, "--scheduled", "--fail-at", "4"]))
        second = train.run(train.parse_args(
            base + ["--ckpt-dir", sched, "--scheduled", "--resume"]))
        whole = train.run(train.parse_args(base + ["--ckpt-dir", plain]))
        wall = time.monotonic() - t0

        def manifest(d, step):
            m = json.loads((Path(d) / f"step_{step:08d}" / "manifest.json")
                           .read_text())
            return [(e["shape"], e["dtype"], e["sha256"]) for e in m["leaves"]]
        same_ckpt = manifest(sched, 2) == manifest(plain, 2)
        ckpt_bytes = sum(f.stat().st_size for f in
                         (Path(plain) / "step_00000002").iterdir())
        result = {"failed_at": first["failed_at"],
                  "resumed_from": second["start_step"],
                  "losses_crashed": first["losses"],
                  "losses_resumed": second["losses"],
                  "losses_uninterrupted": whole["losses"],
                  "step2_checkpoint_equal": same_ckpt,
                  "checkpoint_bytes": ckpt_bytes, "wall_s": wall}
        log("train.scheduled", **result)
        if not (first["failed_at"] == 4 and second["start_step"] == 4
                and all(second["losses"][i] == whole["losses"][i]
                        for i in (5, 6))
                and all(first["losses"][i] == whole["losses"][i]
                        for i in (1, 2, 3, 4)) and same_ckpt):
            raise AssertionError(f"scheduled crash and resume: {result}")
    finally:
        shutil.rmtree(tmp)
    return result


def scheduled_moe_phase(train) -> dict:
    """``launch/train.py --scheduled`` for qwen2-moe-a2.7b at full width
    with 2 layers (bf16): 3 steps, a checkpoint at step 2 and a crash after
    it, then ``--resume``, then an uninterrupted run without checkpoints.
    Losses 1-2 of the crashed run and 3 of the resumed run equal the
    uninterrupted run's: the routing and its gradient (the dispatch
    gather's included) repeat bit for bit.  The resumed run stops after
    step 3 by ``--fail-at`` too, so it writes no final checkpoint: one save
    and one restore of the 18.3 GB state (bf16 parameters, float32 m and
    v), under ``build/``, removed after.  Each run's state is dropped
    before the next starts (two do not fit the card beside each other)."""
    import shutil
    import tempfile
    base = ["--arch", "qwen2-moe-a2.7b", "--n-layers", "2", "--steps", "3",
            "--batch", "2", "--seq", "256", "--log-every", "1", "--device",
            "cuda"]
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-moe-", dir=ROOT / "build")
    try:
        t0 = time.monotonic()
        ck = ["--ckpt-dir", tmp, "--ckpt-every", "2", "--scheduled"]
        first = train.run(train.parse_args(base + ck + ["--fail-at", "2"]))
        del first["state"]
        free_device_memory()
        t1 = time.monotonic()
        second = train.run(train.parse_args(
            base + ck + ["--resume", "--fail-at", "3"]))
        del second["state"]
        free_device_memory()
        t2 = time.monotonic()
        whole = train.run(train.parse_args(base))
        del whole["state"]
        ckpt_bytes = sum(f.stat().st_size for f in
                         (Path(tmp) / "step_00000002").iterdir())
        result = {"arch": "qwen2-moe-a2.7b", "layers": 2,
                  "failed_at": first["failed_at"],
                  "resumed_from": second["start_step"],
                  "losses_crashed": first["losses"],
                  "losses_resumed": second["losses"],
                  "losses_uninterrupted": whole["losses"],
                  "checkpoint_bytes": ckpt_bytes,
                  "wall_s": {"crashed": t1 - t0, "resumed": t2 - t1,
                             "uninterrupted": time.monotonic() - t2}}
        log("train.scheduled", **result)
        if not (first["failed_at"] == 2 and second["start_step"] == 2
                and second["failed_at"] == 3
                and second["losses"][3] == whole["losses"][3]
                and all(first["losses"][i] == whole["losses"][i]
                        for i in (1, 2))):
            raise AssertionError(f"scheduled MoE crash and resume: {result}")
    finally:
        shutil.rmtree(tmp)
    return result


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    from repro_torch import core
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention as kdecode
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import mlstm_scan as kscan
    from repro_torch.kernels import moe_topk as kmoe
    from repro_torch.launch import serve, train
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import InferenceEngine, Request
    from repro_torch.training import optimizer, trainer

    t_start = time.monotonic()
    seconds = {}     # each phase's seconds, in run order

    def done(phase: str, t0: float, **fields) -> None:
        """Log the phase's ".done" line and keep its seconds."""
        key = phase + (f" {fields['arch']}" if "arch" in fields else "")
        seconds[key] = time.monotonic() - t0
        log(phase + ".done", seconds=seconds[key], **fields)

    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log("device", nvidia_smi=card, torch_name=torch.cuda.get_device_name(0),
        capability=list(cap), torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, the kernels are "
                             "built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    built = build.build()
    ptxas = {name: [ln.strip() for ln in log_.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, (_, _, log_) in built.items()}
    log("build", seconds=time.monotonic() - t0,
        per_source={n: s for n, (_, s, _) in built.items()}, ptxas=ptxas)
    seconds["build"] = time.monotonic() - t0
    check_scan_build(build, built)
    check_bwd_build(build, built)

    t0 = time.monotonic()
    timed = kernel_phase(ref, kflash, kdecode)
    done("kernels", t0)

    t0 = time.monotonic()
    timed["flash_attention_bwd"] = backward_phase(ref, kflash)
    free_device_memory()
    done("kernels.bwd", t0)

    t0 = time.monotonic()
    timed.update(router_scan_phase(ref, kmoe, kscan, capacity))
    done("kernels.k3k4", t0)

    t0 = time.monotonic()
    timed.update(backward2_phase(ref, kflash, kscan, kmoe, capacity))
    done("kernels.bwd2", t0)

    # Float32 checks: kernel path against plain path, engine against a
    # direct loop (prompt_len None: none).  qwen2-moe keeps 4 of its 24
    # layers and stablelm-3b 4 of its 32 (full width).  hymba-1.5b runs
    # prompts up to 1300 tokens at S_max 2048, so its windowed layers' ring
    # (1024) wraps and its global layers' cache does not: held to MODEL_TOL
    # with 4 layers (global, two windowed, global), and at full depth with
    # its tokens held and its error printed beside the noise floor.  At
    # full depth, embeddings moved by 1e-6 move the plain path's float32
    # logits by more than MODEL_TOL (PERF.md), so no kernel that sums in
    # another order can be held to it there.
    #
    # seamless-m4t-medium (12 + 12 layers, frames (4, 1024, 1024)) and
    # internvl2-1b (24 layers, a 256-token vision prefix, prompts of 260-400
    # tokens) run at full width and depth, held to MODEL_TOL.
    # deepseek-v3-671b runs at full width with one dense and one MoE layer
    # (55.8 GB in float32).  The engine check is text only (the engine
    # passes only tokens); seamless, which needs frames, has none.
    long = {"lengths": (300, 700, 1100, 1300), "smax": 2048}
    vlm = {"lengths": (260, 300, 350, 400), "smax": 512}
    checks = [("llama3.2-1b", {}, 50, {}),
              ("xlstm-350m", {}, 64, {}),
              ("qwen2-moe-a2.7b", {"n_layers": 4}, 50, {}),
              ("stablelm-3b", {"n_layers": 4}, 50, {}),
              ("hymba-1.5b", {"n_layers": 4, "global_attn_layers": (0, 3)},
               None, long),
              ("hymba-1.5b", {}, 64, {**long, "held": False}),
              ("seamless-m4t-medium", {}, None, {}),
              ("internvl2-1b", {}, 50, vlm),
              ("deepseek-v3-671b", {"n_layers": 2, "first_k_dense": 1}, 50,
               {})]
    for name, cut, prompt_len, ragged in checks:
        cfg = get_arch(name)
        t0 = time.monotonic()
        model = Model(dataclasses.replace(cfg, dtype="float32", **cut),
                      device="cuda")
        params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
        model_phase(model, params, ops, ref, cfg.vocab_size, **ragged)
        if cfg.moe is not None:
            model.capacity_factor = 64.0     # no expert overflows
        if prompt_len is not None:
            engine_phase(model, params, core.build_kernel, InferenceEngine,
                         Request, cfg.vocab_size, prompt_len)
        del model, params
        free_device_memory()
        done("model", t0, arch=name)

    t0 = time.monotonic()
    train_check_phase(ops, ref, Model, trainer, get_arch)
    free_device_memory()
    train_check_families_phase(ops, ref, Model, trainer, get_arch)
    done("train.check", t0)

    # Serving, bfloat16, full width and depth (deepseek-v3-671b: its 3
    # dense layers and 2 of its 58 MoE layers, 53.2 GB, as the card's 80 GB
    # allow); each path's own kernels must run on it.  seamless-m4t-medium's
    # path runs at model level (prefill_batch over frames, then decode
    # steps), as the engine passes no frames.  The models with recurrent
    # heads and the two with stub frontends first print their bf16
    # prefill_batch logits, kernel path against plain path.
    counters = {"flash_attention": kflash.launches,
                "flash_attention_bwd": kflash.bwd_launches,
                "decode_attention": kdecode.launches,
                "mlstm_scan": kscan.launches, "moe_topk": kmoe.launches}
    attn = ("flash_attention", "decode_attention")
    vlm_lengths = (256, 272, 288, 304, 320, 352, 384, 400)
    # arch, path label, cut, kernels the path must launch, and whether
    # serve's background-train lane runs beside it
    paths = [("llama3.2-1b", "llama3.2-1b", {}, attn, False),
             ("llama3.2-1b", "llama3.2-1b+background-train", {},
              attn + ("flash_attention_bwd",), True),
             ("qwen2-moe-a2.7b", "qwen2-moe-a2.7b", {}, attn + ("moe_topk",),
              False),
             ("xlstm-350m", "xlstm-350m", {}, ("mlstm_scan",), False),
             ("hymba-1.5b", "hymba-1.5b", {}, attn + ("mlstm_scan",), False),
             ("seamless-m4t-medium", "seamless-m4t-medium", {}, attn, False),
             ("internvl2-1b", "internvl2-1b", {}, attn, False),
             ("deepseek-v3-671b", "deepseek-v3-671b", {"n_layers": 5},
              ("flash_attention", "moe_topk"), False)]
    by_path = {}
    for arch, name, cut, required, train_lane in paths:
        cfg = dataclasses.replace(get_arch(arch), **cut)
        t0 = time.monotonic()
        model = Model(cfg, device="cuda")
        params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
        if cfg.ssm is not None or cfg.encoder_layers or cfg.vision_tokens:
            bf16_prefill_phase(model, params, ops, ref, cfg.vocab_size,
                               **({"lengths": vlm_lengths}
                                  if cfg.vision_tokens else {}))
        if cfg.encoder_layers:
            by_path[name] = model_path_phase(model, params, counters,
                                             required, cfg.vocab_size)
        else:
            by_path[name] = serving_phase(
                model, params, core, InferenceEngine, Request, counters,
                required, cfg.vocab_size,
                background_train=serve.background_train if train_lane
                else None)
        del model, params
        free_device_memory()
        done("serving", t0, arch=name,
             total_seconds=time.monotonic() - t_start)

    # Training, bf16: llama3.2-1b at full size for 4 steps, then the
    # scheduled driver's crash and resume at full width with 2 layers.
    t0 = time.monotonic()
    by_path["llama3.2-1b training"] = training_phase(
        Model, trainer, optimizer, get_arch, kflash)
    free_device_memory()
    done("train.steps", t0)
    t0 = time.monotonic()
    scheduled_train_phase(train)
    free_device_memory()
    done("train.scheduled", t0,
         total_seconds=time.monotonic() - t_start)

    # Training of every other family, bf16 (FAMILY_STEPS), then the
    # scheduled driver's crash and resume for qwen2-moe at 2 layers.
    t0 = time.monotonic()
    for arch, launches in train_families_phase(
            Model, trainer, optimizer, get_arch).items():
        by_path[f"{arch} training"] = {
            **launches, "flash_attention_bwd_mla": launches[
                "flash_attention_bwd"] if arch == "deepseek-v3-671b" else 0}
    done("train.families", t0,
         total_seconds=time.monotonic() - t_start)
    t0 = time.monotonic()
    scheduled_moe_phase(train)
    free_device_memory()
    done("train.scheduled_moe", t0,
         total_seconds=time.monotonic() - t_start)

    # Each kernel's launches are read on its own slice's path: K1, K2 on
    # llama3.2-1b, K4 on qwen2-moe, K3 on xlstm, K1's backward on the
    # training steps; every path is listed
    # (hymba-1.5b's runs K1, K2 and K3; seamless-m4t-medium's and
    # internvl2-1b's K1 and K2; deepseek-v3-671b's K1 at 192 / 128 and K4).
    own = {"flash_attention": "llama3.2-1b", "decode_attention": "llama3.2-1b",
           "moe_topk": "qwen2-moe-a2.7b", "mlstm_scan": "xlstm-350m",
           "flash_attention_bwd": "llama3.2-1b training",
           "mlstm_scan_bwd": "xlstm-350m training",
           "moe_route_bwd": "qwen2-moe-a2.7b training",
           "flash_attention_bwd_mla": "deepseek-v3-671b training"}
    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:102"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:70"),
               "mlstm_scan": ("src/repro_torch/csrc/mlstm_scan.cu",
                              "src/repro/kernels/mlstm_scan.py:86"),
               "moe_topk": ("src/repro_torch/csrc/moe_topk.cu",
                            "src/repro/kernels/moe_topk.py:53"),
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "no Pallas kernel: the reference differentiates "
                   "`_flash_xla`, src/repro/kernels/ops.py:39"),
               "flash_attention_bwd_mla": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "no Pallas kernel: the reference differentiates "
                   "`_flash_xla` at dk 192 / dv 128, "
                   "src/repro/kernels/ops.py:39"),
               "mlstm_scan_bwd": (
                   "src/repro_torch/csrc/mlstm_scan_bwd.cu",
                   "no Pallas kernel: the reference differentiates "
                   "`_mlstm_xla`, src/repro/kernels/ops.py:128"),
               "moe_route_bwd": (
                   "src/repro_torch/csrc/moe_topk.cu",
                   "no Pallas kernel: the reference differentiates "
                   "`ref.moe_topk_ref` through src/repro/kernels/ops.py:189 "
                   "(router_bwd_kernel)")}
    tolerance = {
        "flash_attention": (f"bf16 {TOL[torch.bfloat16]:g}, "
                            f"f32 {TOL[torch.float32]:g} max abs"),
        "mlstm_scan": "bf16 3e-2 x max(1, max|plain|), f32 1e-3 max abs",
        "moe_topk": ("indices, slots, slot tokens, counts identical; "
                     "weights 1e-6 max abs; prob_sum 1e-5 relative"),
        "flash_attention_bwd": ("dq, dk, dv: bf16 3e-2, f32 1e-4, x max(1, "
                                "max|plain|), and ||err|| / ||plain|| bf16 "
                                "1e-2, f32 1e-4; lse f32 1e-5, bf16 1e-4")}
    tolerance["decode_attention"] = tolerance["flash_attention"]
    for name in ("flash_attention_bwd_mla", "mlstm_scan_bwd", "moe_route_bwd"):
        tolerance[name] = ("bf16 3e-2, f32 1e-4, x max(1, max|plain|), and "
                           "||err|| / ||plain|| bf16 1e-2, f32 1e-4")
    kernels = []
    for name, d in timed.items():
        extra = {k: v for k, v in d.items() if k not in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "shape", "max_abs_err_f32")}
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": by_path[own[name]][name],
            "max_abs_err": d["max_abs_err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "max_abs_err_f32": d["max_abs_err_f32"],
            "tolerance": tolerance[name], "shape": d["shape"],
            "launches_path": own[name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()
                                 if name in c},
            **extra, "card": card})
    log("phase_seconds", total=time.monotonic() - t_start,
        build=seconds["build"], by_phase=seconds)
    print(json.dumps({"kernels": kernels, "not_ported": []}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
