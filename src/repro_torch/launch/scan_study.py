"""Where the mLSTM scan (K3) spends its time on the card, which of its two
bfloat16 designs is faster where, and what its bf16 roundings cost.

  PYTHONPATH=src python -m repro_torch.launch.scan_study stamps [--bh 32 --s 256]
  PYTHONPATH=src python -m repro_torch.launch.scan_study plans \
      [--dk 16 --dv 64 --bhs 25,50,100,200 --ss 64,128,256,500,1024,2048]
  PYTHONPATH=src python -m repro_torch.launch.scan_study rounding

``stamps``: builds ``csrc/mlstm_scan.cu`` with ``-DMLSTM_STAMPS`` (a
library of its own under ``build/kernels/``), runs the single pass once at
(BH, S, 512, 512) and prints, for the first block's two warpgroups, the SM
cycles of each phase of the kernel in every chunk.

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

Each prints one JSON line per measurement, with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..kernels import build, ref
from ..kernels import mlstm_scan as kscan

STAMP_FLAGS = ("-DMLSTM_STAMPS",)
STAMP_CHUNKS = 16          # the kernel's STAMP_CHUNKS
PHASES = ["top of chunk", "issue copies", "gates, C copy, barrier", "scan",
          "wait for tiles", "scores", "mask, q.n, w o V, barrier", "Q C",
          "S V, store", "prefetch Q, V", "carry issue, n", "carry wait"]
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
    for _ in range(3):
        kscan.run(q, k, v, logf, ig, design="single", flags=STAMP_FLAGS)
    torch.cuda.synchronize()
    read = build.function("mlstm_scan", "mlstm_stamps", [ctypes.c_void_p],
                          STAMP_FLAGS)
    st = np.zeros((2, STAMP_CHUNKS, len(PHASES)), np.uint64)
    build.check(read(st.ctypes.data), "mlstm_stamps")
    st = st.astype(np.int64)
    n = min(kscan.scan_plan(bh, s, d, d).n_chunks, STAMP_CHUNKS)
    for w in range(2):
        prev = [st[w, c - 1, -1] if c else st[w, 0, 0] for c in range(n)]
        phases = {name: [int(st[w, c, j] - (st[w, c, j - 1] if j else prev[c]))
                         for c in range(n)]
                  for j, name in enumerate(PHASES)}
        print(json.dumps({"study": "stamps", "bh": bh, "s": s, "dk": d,
                          "dv": d, "warpgroup": w, "block": [0, 0],
                          "cycles_per_chunk": phases,
                          "cycles_total": int(st[w, n - 1, -1] - st[w, 0, 0]),
                          "card": card}), flush=True)


def device_ms(fn, iters: int = 5) -> float:
    """Device time of one call of ``fn``, summed over its K3 kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "mlstm_" in e.key
               ) / iters / 1e3


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
    ap.add_argument("study", choices=("stamps", "plans", "rounding"))
    ap.add_argument("--bh", type=int, default=32)
    ap.add_argument("--s", type=int, default=256)
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
    if args.study == "stamps":
        stamps(args.bh, args.s, card)
    elif args.study == "plans":
        plans(card, args.dk, args.dv, args.bhs, args.ss)
    else:
        rounding(card)


if __name__ == "__main__":
    main()
