#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's serving path -- the UFS live scheduler, the
continuous-batching engine and llama3.2-1b at its published width and depth
-- on the card, and holds each hand-written Hopper kernel against its plain
PyTorch version.  Phases, each printed on its own line and each fatal:

1. device   -- the card's name and power limit, compute capability 9.0
2. build    -- compile the CUDA kernels from ``src/repro_torch/csrc``
3. kernels  -- each kernel against its plain version (float32 to 1e-4,
               bfloat16 to 3e-2) over the serving shapes and the reference
               test shapes; CUDA-event times of the kernel, the plain
               version and one library call beside the kernel's bound
4. model    -- full-width llama3.2-1b in float32: prefill_batch on ragged
               prompts and 8 decode steps, kernel path against the plain path
               (logits to 1e-3, greedy tokens identical)
5. engine   -- the engine's tokens equal a direct prefill + decode loop
6. serving  -- 8 time-sensitive requests and 2 background bulk prefills
               under UFS in bfloat16; every request must finish, and both
               kernels must have been launched on this path

Then a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
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
MODEL_TOL = 1e-3


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


def flash_bound_ms(q, k, causal, window) -> tuple:
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es   # q, out, k, v
    ops = 4 * b * h * hd * flash_pairs(sq, sk, causal, window)
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
    F = torch.nn.functional
    flash_shapes = [
        # b, sq, sk, h, kh, hd, causal, window
        (8, 256, 256, 32, 8, 64, True, 0),    # llama3.2-1b admission batch
        (1, 500, 500, 32, 8, 64, True, 0),    # ragged bulk prefill
        (8, 256, 256, 14, 2, 64, True, 0),    # qwen2-0.5b, G = 7
        (1, 512, 512, 32, 8, 64, True, 128),  # sliding window
        (2, 64, 256, 32, 8, 64, False, 0),    # non-causal, Sq != Sk
        (4, 256, 256, 1, 1, 64, True, 0),     # reference test shapes, BH form
        (2, 128, 256, 1, 1, 32, True, 0),
        (1, 512, 512, 1, 1, 128, True, 0),
        (3, 128, 128, 1, 1, 16, True, 0),
    ]
    decode_shapes = [
        # b, s, h, kh, hd, lengths
        (8, 1024, 32, 8, 64, [700] * 8),      # llama3.2-1b decode step
        (8, 1024, 32, 8, 64, [1, 64, 65, 300, 511, 700, 1000, 1024]),
        (8, 1024, 14, 2, 64, [700, 3, 1024, 250, 64, 65, 900, 128]),
        (6, 512, 1, 1, 64, [i * (512 // 6) + 1 for i in range(6)]),
        (2, 2048, 1, 1, 128, [i * 1024 + 1 for i in range(2)]),
        (8, 256, 1, 1, 32, [i * 32 + 1 for i in range(8)]),
    ]
    errs = {"flash": {}, "decode": {}}
    for dt in (torch.float32, torch.bfloat16):
        worst_f = worst_d = 0.0
        for i, (b, sq, sk, h, kh, hd, causal, window) in enumerate(flash_shapes):
            q = randn((b, sq, h, hd), dt, 10 + i)
            k = randn((b, sk, kh, hd), dt, 20 + i)
            v = randn((b, sk, kh, hd), dt, 30 + i)
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

    # Times at the serving shapes, bfloat16 as served.
    dt = torch.bfloat16
    b, s, h, kh, hd = 8, 256, 32, 8, 64
    q, k, v = (randn((b, s, n, hd), dt, 70 + j)
               for j, n in enumerate((h, kh, kh)))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flash = {
        "ms": cuda_ms(lambda: kflash.flash_attention(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: ref.grouped_flash_ref(q, k, v, causal=True)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
    }
    flash["bound_ms"], flash["bound_by"] = flash_bound_ms(q, k, True, 0)
    flash["shape"] = f"B={b} S={s} H={h} KH={kh} hd={hd} causal bf16"
    got = kflash.flash_attention(q, k, v, causal=True)
    flash["max_abs_err"] = (got.float() - ref.grouped_flash_ref(
        q, k, v, causal=True).float()).abs().max().item()

    b, smax, live = 8, 1024, 700
    q = randn((b, 1, h, hd), dt, 80)
    k, v = (randn((b, smax, kh, hd), dt, 81 + j) for j in range(2))
    lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = (torch.arange(smax, device="cuda")[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    decode = {
        "ms": cuda_ms(lambda: kdecode.decode_attention(q, k, v, lengths)),
        "plain_ms": cuda_ms(lambda: ref.grouped_decode_ref(q, k, v, lengths)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
    }
    decode["bound_ms"], decode["bound_by"] = decode_bound_ms(q, k, lengths)
    decode["shape"] = f"B={b} S_max={smax} live={live} H={h} KH={kh} hd={hd} bf16"
    got = kdecode.decode_attention(q, k, v, lengths)
    decode["max_abs_err"] = (got.float() - ref.grouped_decode_ref(
        q, k, v, lengths).float()).abs().max().item()
    torch.cuda.synchronize()
    for name, d in (("flash_attention", flash), ("decode_attention", decode)):
        log("kernels.time", kernel=name, **d)
    flash["max_abs_err_f32"] = errs["flash"]["float32"]
    decode["max_abs_err_f32"] = errs["decode"]["float32"]
    return {"flash_attention": flash, "decode_attention": decode}


# ------------------------------------------------------------ phases 4, 5
@contextlib.contextmanager
def plain_attention(ops, ref):
    """Swap both kernels for their plain versions, on the card.  Used only
    here, to hold the kernel path against the plain path."""
    saved = ops.grouped_flash, ops.grouped_decode
    ops.grouped_flash, ops.grouped_decode = (ref.grouped_flash_ref,
                                             ref.grouped_decode_ref)
    try:
        yield
    finally:
        ops.grouped_flash, ops.grouped_decode = saved


def run_ragged(model, params, prompts, smax: int, steps: int):
    """prefill_batch on right-padded prompts, then greedy decode steps at
    the shared position the engine uses.  Returns the logits of every step
    and the greedy tokens."""
    lengths = np.array([len(p) for p in prompts], np.int32)
    toks = np.zeros((len(prompts), int(lengths.max())), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    logits, caches = model.prefill_batch(
        params, {"tokens": toks, "lengths": lengths}, smax)
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


def model_phase(model, params, ops, ref, vocab: int) -> None:
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (37, 64, 100, 128)]
    lk, tk = run_ragged(model, params, prompts, 256, 8)
    with plain_attention(ops, ref):
        lp, tp = run_ragged(model, params, prompts, 256, 8)
    err = (lk - lp).abs().max().item()
    finite = bool(torch.isfinite(lk).all())
    log("model", arch=model.cfg.name, dtype="float32", layers=model.cfg.n_layers,
        d_model=model.cfg.d_model, logits_shape=list(lk.shape),
        max_abs_err=err, tolerance=MODEL_TOL,
        tokens_identical=bool(torch.equal(tk, tp)), finite=finite)
    if not (finite and err < MODEL_TOL and torch.equal(tk, tp)):
        raise AssertionError(f"kernel path disagrees with the plain path: "
                             f"max err {err}, tokens {tk.tolist()} vs "
                             f"{tp.tolist()}")


def engine_phase(model, params, build_kernel, InferenceEngine, Request,
                 vocab: int) -> None:
    prompt = np.random.default_rng(2).integers(0, vocab, 50).astype(np.int32)
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
    log("engine", direct=direct, engine=req.tokens, finished=done, ok=req.ok)
    if not (done and req.ok and req.tokens[:4] == direct):
        raise AssertionError(f"engine tokens {req.tokens} != direct {direct}")


# ---------------------------------------------------------------- phase 6
def pct(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def serving_phase(model, params, core, InferenceEngine, Request, counters,
                  vocab: int) -> dict:
    kernel = core.build_kernel("live", policy="ufs", n_slots=1)
    engine = InferenceEngine(model, params, kernel, max_batch=8, max_len=1024)
    rng = np.random.default_rng(0)
    bulk_prompts = [rng.integers(0, vocab, 500).astype(np.int32)
                    for _ in range(2)]
    ts_prompts = [rng.integers(0, vocab, int(rng.integers(64, 257)))
                  .astype(np.int32) for _ in range(8)]
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    kernel.start()
    engine.start()
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
        "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "engine": engine.stats.summary(),
    }
    log("serving", arch=model.cfg.name, dtype="bfloat16", **result)
    print(core.KernelReport.from_kernel(kernel).pretty(), flush=True)
    if bad:
        raise AssertionError(f"requests that did not finish ok: {bad}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched on the serving "
                             f"path: {launches}")
    return launches


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
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import InferenceEngine, Request

    t_start = time.monotonic()
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

    t0 = time.monotonic()
    timed = kernel_phase(ref, kflash, kdecode)
    log("kernels.done", seconds=time.monotonic() - t0)

    cfg = get_arch("llama3.2-1b")
    t0 = time.monotonic()
    model = Model(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    model_phase(model, params, ops, ref, cfg.vocab_size)
    engine_phase(model, params, core.build_kernel, InferenceEngine, Request,
                 cfg.vocab_size)
    del model, params
    torch.cuda.empty_cache()
    log("model.done", seconds=time.monotonic() - t0)

    t0 = time.monotonic()
    model = Model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    counters = {"flash_attention": kflash.launches,
                "decode_attention": kdecode.launches}
    launches = serving_phase(model, params, core, InferenceEngine, Request,
                             counters, cfg.vocab_size)
    log("serving.done", seconds=time.monotonic() - t0,
        total_seconds=time.monotonic() - t_start)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:102"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:70")}
    kernels = []
    for name, d in timed.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": d["max_abs_err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            "max_abs_err_f32": d["max_abs_err_f32"],
            "tolerance": (f"bf16 {TOL[torch.bfloat16]:g}, "
                          f"f32 {TOL[torch.float32]:g} max abs"),
            "shape": d["shape"], "card": card})
    not_ported = [
        {"name": "mlstm_scan", "replaces": "src/repro/kernels/mlstm_scan.py:86",
         "status": "not ported"},
        {"name": "moe_topk", "replaces": "src/repro/kernels/moe_topk.py:53",
         "status": "not ported"},
    ]
    print(json.dumps({"kernels": kernels, "not_ported": not_ported}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
