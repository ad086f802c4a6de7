#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's serving and training paths -- the UFS live scheduler, the
continuous-batching engine and the models at their published widths:
llama3.2-1b (dense GQA), qwen2-0.5b (GQA, G = 7, QKV bias), granite-8b
(dense GQA, hd 128), qwen2-moe-a2.7b (MoE), xlstm-350m (mLSTM and sLSTM
blocks), hymba-1.5b (attention and SSD heads side by side,
sliding-window attention in 29 of 32 layers), internvl2-1b (the VLM
backbone, text only through the engine), deepseek-v3-671b (MLA and MoE, 5
of its 61 layers) and, at model level, seamless-m4t-medium (encoder over
stub frames, cross-attention in every decoder layer) -- on the card; trains
llama3.2-1b (AdamW, K1's backward kernel) and drives the scheduled
training driver's crash and resume; trains every other family (MoE, xLSTM,
hymba, MLA, enc-dec, VLM) through the backward kernels of K1 (MLA's 192 /
128 too), K3 and K4; prices three llama3.2-1b steps on the card's
roofline; drives the distributed layer on one NCCL rank and both ported
examples; and holds each hand-written Hopper kernel against its plain
PyTorch version.
Phases, each printed on its own line and each fatal:

1. device   -- the card's name and power limit, compute capability 9.0
2. build    -- compile the CUDA kernels from ``src/repro_torch/csrc``;
               ptxas must report no spill in the mLSTM scan, and its
               tensor-core kernels' SASS must hold HGMMA (cuobjdump): the
               single pass ``mlstm_tma_kernel`` at each of its four panel
               counts (registers and spill stores of each, its register
               split kept, no trap in the production build's SASS and one
               in its watchdog build's) and the chunk-parallel kernels; K1's
               bf16 backward (``flash_bwd_dkdv_tma_kernel``,
               ``flash_bwd_dq_tma_kernel``): registers and spill stores (0)
               of each at each pair of dims, no wgmma serialised nor
               setmaxnreg dropped, HGMMA in each one's SASS, its watchdog
               build's ptxas beside it; no
               spill in K3's backward (``csrc/mlstm_scan_bwd.cu``), its
               warp-specialised kernels' register split kept (no wgmma
               serialised or waited on by ptxas, no setmaxnreg dropped),
               no trap in the production build's SASS and one in the
               watchdog build's; K1's
               bf16 forward (``flash_fwd_tma_kernel``): registers, spill
               stores and serialised wgmma by ptxas, HGMMA in the SASS of
               each of its six instantiations; K2's kernels
               (``decode_mma_kernel``, bf16, and ``decode_split_kernel``):
               registers and spill stores (0) of each instantiation, and
               of the bf16 kernel's build made to spill (its spill lines)
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
               launches of its plan), beside the kernel's bound; for K1
               and K2 also the wrapper's host microseconds a call over 1000
               unsynchronised calls (``host_us``), for K1 those of its
               tensor maps' encoding alone, for K2 the live K/V bytes a
               call reads and their rate, and the registers and spill
               stores of each;
               K1 and K2 at llama3.2-1b's, qwen2-moe-a2.7b's, stablelm-3b's
               (head dim 80) and hymba-1.5b's shapes, K1 at deepseek-v3's
               MLA admission (query-key dim 192, value dim 128) and
               seamless's encoder, K1 beside K2 at seamless's
               cross-attention decode (one query over 1024 positions), K3
               at xlstm-350m's admission and bulk-prefill shapes under both
               of its plans (single pass, chunk-parallel), at hymba's
               SSD heads and, forward alone, at both families' training
               shapes (xlstm 16 x 2048, dk = dv = 512; hymba 50 x 2048, dk
               16, dv 64: CUDA-event ms, plain ms, device ms; held to the
               bf16 gate there in the parity phase too), its single pass's
               watchdog build against the production bits
               (``kernels.parity.k3_watchdog``), K2's build made to spill
               against the plain version and the production bits at G 1,
               8 and 16 and 1 to 16 clusters (``kernels.parity.k2_spill``),
               K4 at qwen2-moe's decode and admission shapes (one
               launch a call); K1's backward against its plain version on
               dq, dk, dv (float32 1e-4, bf16 3e-2, of max(1, max |plain|),
               and the norm of the error within 1e-4 (float32) and 1e-2
               (bf16) of the plain gradient's) at the training shape
               (llama3.2-1b, B=2, S=4096) and the mask and head-dim edges,
               the plain gradient taken from the plain forward's output
               and logsumexp; the forward's row logsumexp on its live rows
               to 1e-5 (float32) and 1e-4 (bf16); its times beside SDPA's
               backward, with each of its three kernels' own device time;
               its watchdog build against the plain version and the
               production build's bits (``kernels.parity.k1_bwd_watchdog``);
               its device ms by kernel and grids at every training shape
               (``flash_bwd_study.SHAPES``) beside its bound and the library's
               backward (``kernels.time.k1_bwd_shape``); K3's backward's
               watchdog build likewise (``kernels.parity.k3_bwd_watchdog``);
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
5b. distributed -- a one-rank NCCL group (one card): llama3.2-1b at full
               width through ``Model.shardmap_attn`` (K1 on the rank's
               heads, ``all_reduce`` over the model axis), prefill logits
               against the plain mixer (float32 to 1e-3, bf16 printed),
               K1's launches and the all-reduces counted on that path;
               ``compressed_psum`` equal to the local int8 round trip
5c. sharded -- the sharded program run for real on a one-rank NCCL
               group ((1, 1) mesh; (1, 1, 1) for the pod axis): states,
               batches and caches placed by ``sharding.device_put``, K1-K4
               and their backward kernels under ``local_map``;
               llama3.2-1b bf16 at full size (4 x 4096, 2 micro-batches,
               remat), xlstm-350m (full) and qwen2-moe-a2.7b (3 of 24
               layers, experts over the model axis): 2 steps against 2
               plain steps from the same state, losses within the bf16
               gate, launches equal, placements kept, wall and busy ms of
               both; llama at 2 layers in float32 (losses and parameters
               to 1e-4) with the elastic drill (the state after step 1
               saved sharded, files byte-identical to an unsharded save,
               restored onto the mesh: step 2's loss bit for bit; as a
               plain state: 1e-6 relative); llama's float32 prefill and
               8 decode steps against the plain path (1e-3, tokens
               identical, K2 launched)
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
               which must take a step, with K1's backward launched;
               qwen2-0.5b (hd 64, G = 7, QKV bias) and granite-8b (hd
               128) at full width and depth; before llama3.2-1b is
               served, the ``roofline`` lines of its decode step (B 8,
               S_max 1024, 700 live) and ``prefill_batch`` (8 x 256)
6b. examples -- ``examples/mixed_serving_torch.py`` as it runs by
               default (qwen2-0.5b, full size, the training lane): 8 of 8
               requests, a lane step, K1, K2 and K1's backward launched;
               ``examples/train_100m_torch.py`` for 20 steps, a crash after
               15 and a resume from step 10 against an uninterrupted run:
               identical losses
7. training -- bf16 llama3.2-1b at full size, S=4096, B=4 in 2 micro-
               batches, remat: 4 AdamW steps, losses finite and falling,
               K1's forward and backward launched (counts set to 0 just
               before); step wall and busy ms, tokens/s, peak memory and
               the model-flops share, and the step's ``roofline`` line
               (``roofline.analysis.analyze``: flops, unfused bytes,
               terms, bottleneck, ``mfu_bound``, beside wall and busy);
               then ``launch/train.py --scheduled``
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

Then a ``kernels`` JSON line (its ``not_ported``: each reference function
that reaches ``pl.pallas_call`` whose port kernel this run did not launch
on its path or hold against its plain version), the card's name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits
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

# The card's peaks (``roofline.analysis``) and each kernel's work
# (``kernels.work``), imported by ``main`` once a card is found.
RA = W = None
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
NORM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # ||got - plain|| / ||plain||
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
ROUTER_TOL = 1e-6                  # weights; indices must be identical
ROUTE_SUM_RTOL = 1e-5              # prob_sum; slots and counts identical
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}   # bf16: x max(1, |ref|)
MODEL_TOL = 1e-3


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
# in reverse <-1> (mangled ILi1E, ILin1E) and the gradient kernel, warp
# specialised on TMA, and the normaliser
SCAN_BWD_WGMMA = re.compile(
    r"(?<=\d)(scan_bwd_[a-z_]+?_(?:wgmma|tma)_kernel)(?:ILi(n?)(\d+)E)?")
SCAN_BWD_WGMMA_KERNELS = 4


# K3's bf16 single pass at NP dk panels (mangled ILi<NP>E)
SCAN_TMA = re.compile(r"mlstm_tma_kernelILi(\d+)E")


def scan_tma_name(m) -> str:
    return f"mlstm_tma_kernel<{m.group(1)}>"


def scan_bwd_name(m) -> str:
    return m.group(1) + (f"<{'-' if m.group(2) else ''}{m.group(3)}>"
                         if m.group(3) else "")


def check_scan_build(build, built) -> None:
    """ptxas reports no spill in the mLSTM scan or its backward (when this
    run built them), and the SASS of the scan's bf16 kernels (the single
    pass ``mlstm_tma_kernel<NP>`` at NP 1, 2, 4 and 8, the chunk-parallel
    ``mlstm_wgmma_kernel``) and of its backward's bf16 kernels
    (``scan_bwd_*_tma_kernel`` and the normaliser) holds tensor-core
    instructions (HGMMA); each single-pass and backward tensor-core
    kernel's registers and spill stores are printed.  The production
    builds of both keep their register split (no wgmma serialised or
    waited on by ptxas, no setmaxnreg dropped) and hold no trap (BPT.TRAP
    in their SASS), their watchdog builds do; the waits ptxas injects
    into the forward's single pass are printed."""
    path, _, log_ = built["mlstm_scan"]
    fw_path, _, fw_log = next(v for key, v in built.items()
                              if key.startswith("mlstm_scan -D"))
    bwd_path, _, bwd_log = built["mlstm_scan_bwd"]
    w_path, _, w_log = next(v for key, v in built.items()
                            if key.startswith("mlstm_scan_bwd -D"))
    split = [ln.strip() for ln in bwd_log.splitlines()
             if "serializ" in ln.lower() or "setmaxnreg" in ln.lower()
             or "warpgroup.wait is injected" in ln]
    # the forward's: setmaxnreg kept and no wgmma serialised (gated); the
    # waits ptxas injects (printed)
    fwd_split = [ln.strip() for ln in log_.splitlines()
                 if "serializ" in ln.lower() or "setmaxnreg" in ln.lower()]
    fwd_waits = [ln.strip()[:160] for ln in log_.splitlines()
                 if "warpgroup.wait is injected" in ln]
    traps = {w: sum(c for n, c in build.sass_counts(pth, "TRAP").items()
                    if "scan_bwd" in n)
             for w, pth in (("production", bwd_path), ("watchdog", w_path))}
    fwd_traps = {w: sum(c for n, c in build.sass_counts(pth, "TRAP").items()
                        if "mlstm_tma_kernel" in n)
                 for w, pth in (("production", path), ("watchdog", fw_path))}
    spills = [ln.strip() for ln in (log_ + bwd_log).splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    hgmma = build.sass_counts(path, "HGMMA")
    wgmma = {n: c for n, c in hgmma.items()
             if "mlstm_wgmma_kernel" in n or "mlstm_tma_kernel" in n}
    tma = {f"mlstm_tma_kernel<{m.group(1)}>": c for n, c in hgmma.items()
           if (m := SCAN_TMA.search(n))}
    bwd_hgmma = {scan_bwd_name(m): c
                 for n, c in build.sass_counts(bwd_path, "HGMMA").items()
                 if (m := SCAN_BWD_WGMMA.search(n))}
    log("build.mlstm_scan", spill_lines=spills, hgmma_per_kernel=wgmma,
        built_here=bool(log_), bwd_built_here=bool(bwd_log),
        tma_ptxas=ptxas_by_kernel(log_, SCAN_TMA, scan_tma_name),
        tma_hgmma_per_kernel=tma, fwd_sass_traps=fwd_traps,
        fwd_register_split_lines=fwd_split, fwd_injected_waits=fwd_waits,
        watchdog_tma_ptxas=ptxas_by_kernel(fw_log, SCAN_TMA, scan_tma_name),
        bwd_registers=[ln.strip() for ln in bwd_log.splitlines()
                       if "registers" in ln],
        bwd_wgmma_ptxas=ptxas_by_kernel(bwd_log, SCAN_BWD_WGMMA,
                                        scan_bwd_name),
        bwd_hgmma_per_kernel=bwd_hgmma, bwd_register_split_lines=split,
        bwd_sass_traps=traps,
        bwd_watchdog_ptxas=ptxas_by_kernel(w_log, SCAN_BWD_WGMMA,
                                           scan_bwd_name))
    if (spills or not wgmma or not all(wgmma.values()) or len(tma) != 4
            or fwd_traps["production"] or not fwd_traps["watchdog"]
            or fwd_split):
        raise AssertionError(f"mlstm_scan: spills {spills}, HGMMA {hgmma}, "
                             f"traps {fwd_traps}, {fwd_split}")
    if len(bwd_hgmma) != SCAN_BWD_WGMMA_KERNELS or not all(bwd_hgmma.values()):
        raise AssertionError(f"mlstm_scan_bwd: HGMMA {bwd_hgmma}")
    if split or traps["production"] or not traps["watchdog"]:
        raise AssertionError(f"mlstm_scan_bwd: {split}, traps {traps}")


# K1's bf16 backward: the warp-specialised dK/dV and dQ kernels at each
# (query-key dim, value dim) they are built for -- the five equal dims and
# MLA's (192, 128)
BWD_TMA = re.compile(r"(flash_bwd_\w+?_tma_kernel)ILi(\d+)ELi(\d+)E")
BWD_TMA_KERNELS = 2 * 6
BWD_PTXAS = {}      # "flash_bwd_*_tma_kernel<DK, DV>": registers, spill


def bwd_name(m) -> str:
    return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"


def check_bwd_build(build, built) -> None:
    """K1's bf16 backward: ptxas's registers a thread and spill stores of
    each TMA kernel at each pair of dims (when this run built it; the
    launch's 168, the consumers holding 240 by setmaxnreg), HGMMA in each
    one's SASS, and the production build's register split kept: nothing
    spilled, no wgmma serialised, no setmaxnreg dropped.  The watchdog
    build's ptxas is printed beside it (its trap costs the split)."""
    path, _, log_ = built["flash_attention_bwd"]
    BWD_PTXAS.update(ptxas_by_kernel(log_, BWD_TMA, bwd_name))
    hgmma = {bwd_name(m): c
             for n, c in build.sass_counts(path, "HGMMA").items()
             if (m := BWD_TMA.search(n))}
    serialised = [ln.strip() for ln in log_.splitlines()
                  if "serializ" in ln.lower()]
    setmaxnreg = [ln.strip() for ln in log_.splitlines()
                  if "setmaxnreg" in ln.lower()]
    w_log = next((lg for key, (_, _, lg) in built.items()
                  if key.startswith("flash_attention_bwd -D")), "")
    log("build.flash_attention_bwd", ptxas=BWD_PTXAS, hgmma_per_kernel=hgmma,
        wgmma_serialised=serialised, setmaxnreg_lines=setmaxnreg,
        built_here=bool(log_),
        watchdog_ptxas=ptxas_by_kernel(w_log, BWD_TMA, bwd_name))
    if (len(hgmma) != BWD_TMA_KERNELS or not all(hgmma.values())
            or (log_ and len(BWD_PTXAS) != BWD_TMA_KERNELS)):
        raise AssertionError(f"flash_attention_bwd: HGMMA {hgmma}, "
                             f"ptxas {BWD_PTXAS}")
    if log_ and (serialised or setmaxnreg or any(
            v.get("spill_store_bytes") for v in BWD_PTXAS.values())):
        raise AssertionError(f"flash_attention_bwd: ptxas {BWD_PTXAS}, "
                             f"{serialised}, {setmaxnreg}")


# K1's bf16 forward: the TMA kernel at each (query-key dim, value dim)
K1_FWD = "flash_fwd_tma_kernel"
FWD_TMA = re.compile(r"(flash_fwd_tma_kernel)ILi(\d+)ELi(\d+)E")
FWD_TMA_KERNELS = 6
FWD_PTXAS = {}      # "flash_fwd_tma_kernel<DK, DV>": registers, spill stores


def check_flash_build(build, built) -> None:
    """K1's bf16 forward: ptxas's registers a thread and spill stores of
    ``flash_fwd_tma_kernel`` at each pair of dims and the lines where
    ptxas says it serialised wgmma (when this run built it), and HGMMA in
    each one's SASS."""
    path, _, log_ = built["flash_attention"]
    FWD_PTXAS.update(ptxas_by_kernel(log_, FWD_TMA, bwd_name))
    hgmma = {bwd_name(m): c
             for n, c in build.sass_counts(path, "HGMMA").items()
             if (m := FWD_TMA.search(n))}
    serialised = [ln.strip() for ln in log_.splitlines()
                  if "serializ" in ln.lower()]
    setmaxnreg = [ln.strip() for ln in log_.splitlines()
                  if "setmaxnreg" in ln.lower()]
    # the watchdog build (its own library): what the trap costs
    w_log = next((lg for key, (_, _, lg) in built.items()
                  if key.startswith("flash_attention -D")), "")
    log("build.flash_attention", ptxas=FWD_PTXAS, hgmma_per_kernel=hgmma,
        wgmma_serialised=serialised, setmaxnreg_lines=setmaxnreg,
        built_here=bool(log_),
        watchdog_ptxas=ptxas_by_kernel(w_log, FWD_TMA, bwd_name),
        watchdog_wgmma_serialised=sum("serializ" in ln.lower()
                                      for ln in w_log.splitlines()),
        watchdog_setmaxnreg_lines=[ln.strip() for ln in w_log.splitlines()
                                   if "setmaxnreg" in ln.lower()][:4])
    if (len(hgmma) != FWD_TMA_KERNELS or not all(hgmma.values())
            or (log_ and len(FWD_PTXAS) != FWD_TMA_KERNELS)):
        raise AssertionError(f"flash_attention: HGMMA {hgmma}, "
                             f"ptxas {FWD_PTXAS}")
    # the production build keeps its register split: nothing spilled,
    # no wgmma serialised, no setmaxnreg dropped
    if log_ and (serialised or setmaxnreg or any(
            v.get("spill_store_bytes") for v in FWD_PTXAS.values())):
        raise AssertionError(f"flash_attention: ptxas {FWD_PTXAS}, "
                             f"{serialised}, {setmaxnreg}")


# K2's kernels at each (head dim, head-group bound): the bf16 tensor-core
# kernel and the float32 split kernel
DECODE_K = re.compile(r"(decode_(?:mma|split)_kernel)ILi(\d+)ELi(\d+)E")
DECODE_PTXAS = {}   # "decode_mma_kernel<HD, MG>": registers, spill stores


def decode_name(m) -> str:
    return f"{m.group(1)}<{m.group(2)}, {m.group(3)}>"


def check_decode_build(built) -> None:
    """K2: ptxas's registers a thread and spill stores of each instantiation
    of both kernels (when this run built them): no spill anywhere, 10
    tensor-core and 20 split instantiations; the tensor-core kernel's
    build made to spill (``SPILL_FLAGS``, held to the plain version in
    ``kernels.parity.k2_spill``) does spill."""
    _, _, log_ = built["decode_attention"]
    _, _, spill_log = next(v for key, v in built.items()
                           if key.startswith("decode_attention -D"))
    DECODE_PTXAS.update(ptxas_by_kernel(log_, DECODE_K, decode_name))
    mma = {n: v for n, v in DECODE_PTXAS.items() if "mma" in n}
    spilled = {n: v for n, v in ptxas_by_kernel(spill_log, DECODE_K,
                                                decode_name).items()
               if "mma" in n}
    log("build.decode_attention", ptxas=mma, built_here=bool(log_),
        spill_build_ptxas=spilled,
        split_registers_max=max((v.get("registers", 0)
                                 for n, v in DECODE_PTXAS.items()
                                 if "split" in n), default=None))
    if log_ and (len(mma) != 10 or len(DECODE_PTXAS) != 30 or any(
            v.get("spill_store_bytes") for v in DECODE_PTXAS.values())):
        raise AssertionError(f"decode_attention: ptxas {DECODE_PTXAS}")
    if spill_log and not any(v.get("spill_store_bytes")
                             for v in spilled.values()):
        raise AssertionError(f"decode_attention: the build made to spill "
                             f"does not: {spilled}")


# The port's kernel of each reference function that reaches pl.pallas_call
PORT_OF_PALLAS = {"flash_attention_pallas": "flash_attention",
                  "decode_attention_pallas": "decode_attention",
                  "mlstm_scan_pallas": "mlstm_scan",
                  "moe_topk_pallas": "moe_topk"}


def pallas_functions() -> list:
    """Each function of the reference package (``src/repro``) that reaches
    ``pl.pallas_call``, as ("file:line of the call", name), read from its
    source text (nothing of it is imported)."""
    import ast
    found = []
    for path in sorted((ROOT / "src" / "repro").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.FunctionDef):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and sub.attr == "pallas_call":
                    found.append((f"{path.relative_to(ROOT)}:{sub.lineno}",
                                  node.name))
                    break
    return found


def host_us(fn, n: int = 1000, batch: int = 100) -> float:
    """Host microseconds a call of ``fn`` takes to return, over ``n``
    unsynchronised calls in runs of ``batch`` (the device drained between
    runs, outside the timing, so no run waits on a full launch queue)."""
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


def k1_layouts_phase(ref, kflash) -> dict:
    """K1's bf16 forward on inputs no tensor map describes -- K and V
    expanded over their heads (stride 0), q one element into its storage
    (rows off 16 bytes) -- against the plain version (bf16 3e-2), each
    such input copied once (``tma_copies``); then the watchdog build
    (``flash_attention_watchdog``, built beside the others) at hd 64, 80
    and 192 / 128 against the plain version, and whether it gives the
    production build's bits.  Returns the copies and watchdog launches."""
    dt, out = torch.bfloat16, {}
    b, s, h, kh, hd = 8, 256, 32, 8, 64
    q = randn((b * s * h * hd + 1,), dt, 71)[1:].view(b, s, h, hd)
    k = randn((b, s, 1, hd), dt, 72).expand(b, s, kh, hd)
    v = randn((b, s, 1, hd), dt, 73).expand(b, s, kh, hd)
    copies, n = kflash.tma_copies.count, kflash.launches.count
    got = kflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    copied = kflash.tma_copies.count - copies
    err = (got.float() - ref.grouped_flash_ref(q, k, v).float()
           ).abs().max().item()
    out["copies"] = copied
    log("kernels.parity.k1_layouts", shape=[b, s, h, kh, hd],
        layouts={"q": "one element into its storage",
                 "k, v": "expanded over KV heads (stride 0)"},
        copies=copied, launches=kflash.launches.count - n, max_abs_err=err,
        tol=TOL[dt])
    if not (err < TOL[dt] and copied == 3
            and kflash.launches.count == n + 1):
        raise AssertionError(f"K1 copied layouts: err {err}, copies "
                             f"{copied}")
    watch = []
    for b, s, h, kh, hd, dv in ((8, 256, 32, 8, 64, 64),
                                (8, 256, 32, 32, 80, 80),
                                (8, 256, 128, 128, 192, 128)):
        q = randn((b, s, h, hd), dt, 74)
        k = randn((b, s, kh, hd), dt, 75)
        v = randn((b, s, kh, 128 + dv), dt, 76)[..., 128:] if hd == 192 \
            else randn((b, s, kh, hd), dt, 76)
        n, w = kflash.launches.count, kflash.watchdog_launches.count
        got = kflash.flash_attention_watchdog(q, k, v)
        torch.cuda.synchronize()
        launched = (kflash.watchdog_launches.count - w,
                    kflash.launches.count - n)
        prod = kflash.flash_attention(q, k, v)
        err = (got.float() - ref.grouped_flash_ref(q, k, v).float()
               ).abs().max().item()
        watch.append({"shape": [b, s, h, kh, hd, dv], "max_abs_err": err,
                      "production_bits": torch.equal(got, prod),
                      "launches_watchdog_production": list(launched)})
        if not (err < TOL[dt] and launched == (1, 0)):
            raise AssertionError(f"K1 watchdog build: {watch[-1]}")
    log("kernels.parity.k1_watchdog", cases=watch, tol=TOL[dt],
        flags=list(kflash.WATCHDOG_FLAGS))
    out["watchdog"] = watch
    return out


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
    the kernel, the plain version and SDPA (its backend named), the TMA
    kernel's own device time, launches a call (one) and grid, the
    wrapper's host microseconds a call (``host_us``) and those of its
    tensor maps' encoding alone, and the kernel's registers and spill
    stores from ptxas."""
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
        "device_ms": device_ms(call, K1_FWD, alone=True),
    }
    _, d["launches_per_call"], d["grid"] = device_ms_per_call(
        call, K1_FWD, max_per_call=1)
    d["host_us"] = host_us(call)
    d["tma_encode_us"] = kflash.tma_encode_us(q, k, v)
    d["instantiation"] = f"{K1_FWD}<{hd}, {dv or hd}>"
    d.update(FWD_PTXAS.get(d["instantiation"], {}))
    d["library_backend"], d["library_kernels"] = sdpa_backend(library)
    d["bound_ms"], d["bound_by"] = RA.bound_ms(W.flash(q, k, v, causal=causal))
    d["shape"] = (f"B={b} Sq={sq} Sk={s} H={h} KH={kh} hd={hd}"
                  f"{f' dv={dv}' if dv else ''} "
                  f"{'causal' if causal else 'unmasked'} bf16")
    d["max_abs_err"] = (call().float() - ref.grouped_flash_ref(
        q, k, v, causal=causal).float()).abs().max().item()
    return d


K2_BF16 = "decode_mma_kernel"      # float32 runs decode_split_kernel


def time_decode(ref, kdecode, b, smax, live, h, kh, hd) -> dict:
    """K2 in bfloat16 at one decode-step shape, all rows ``live`` long: as
    ``time_flash`` (the tensor-core kernel's own device time, launches a
    call and grid, the wrapper's host microseconds a call), beside the live
    K/V bytes a call reads and the rate it reads them at; the profiler must
    see exactly one K2 launch a call."""
    F = torch.nn.functional
    dt = torch.bfloat16
    q = randn((b, 1, h, hd), dt, 80)
    k, v = (randn((b, smax, kh, hd), dt, 81 + j) for j in range(2))
    lengths = torch.full((b,), live, dtype=torch.int32, device="cuda")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = (torch.arange(smax, device="cuda")[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]

    def call():
        return kdecode.decode_attention(q, k, v, lengths)
    d = {
        "ms": cuda_ms(call),
        "plain_ms": cuda_ms(lambda: ref.grouped_decode_ref(q, k, v, lengths)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        "device_ms": device_ms(call, K2_BF16, alone=True),
    }
    _, d["launches_per_call"], d["grid"] = device_ms_per_call(
        call, K2_BF16, max_per_call=1)
    d["host_us"] = host_us(call)
    d["kv_bytes"] = 2 * b * live * kh * hd * q.element_size()
    d["kv_tb_per_s"] = d["kv_bytes"] / (d["device_ms"] * 1e-3) / 1e12
    d["bound_ms"], d["bound_by"] = RA.bound_ms(W.decode(q, k, v, lengths))
    d["cluster"], d["groups"] = kdecode.mma_plan(smax, b, kh)
    d.update(DECODE_PTXAS.get(
        f"{K2_BF16}<{hd}, {8 if h // kh <= 8 else 16}>", {}))
    d["shape"] = f"B={b} S_max={smax} live={live} H={h} KH={kh} hd={hd} bf16"
    got = kdecode.decode_attention(q, k, v, lengths)
    d["max_abs_err"] = (got.float() - ref.grouped_decode_ref(
        q, k, v, lengths).float()).abs().max().item()
    return d


def norm_err(got, want) -> float:
    """||got - want|| / ||want||: unlike an error of max |want|, it fails
    when a part of the tensor is wrong, however small its entries."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def bwd_training_shapes(ref, kflash) -> dict:
    """K1's bf16 backward at each of the port's training shapes
    (``launch/flash_bwd_study.SHAPES``: llama3.2-1b at train_4k's length,
    ``FAMILY_STEPS``' families): held to the plain
    version (bf16 3e-2 of max(1, max |plain|), norm 1e-2), its ms a call
    by CUDA events beside the plain version's, its device ms a call and by
    kernel (profiler), the kernels' grids, its bound, and the
    library's backward beside it -- SDPA's (``flash_bwd_study.library_call``),
    CUDA events and device ms over every kernel it launches, its backend
    named.  Returns {tag: fields}."""
    from repro_torch.launch.flash_bwd_study import SHAPES, library_call
    dt, out = torch.bfloat16, {}
    for j, (tag, (b, sq, sk, h, kh, hd, dv, causal, window)) in enumerate(
            SHAPES.items()):
        sc = hd ** -0.5
        q, do = (randn((b, sq, h, d), dt, 640 + 4 * j + i)
                 for i, d in enumerate((hd, dv)))
        k, v = (randn((b, sk, kh, d), dt, 642 + 4 * j + i)
                for i, d in enumerate((hd, dv)))
        o, lse = kflash.flash_attention(q, k, v, causal=causal, window=window,
                                        scale=sc, return_lse=True)

        def call():
            return kflash.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=causal, window=window,
                                              scale=sc)
        got = call()
        po, plse = ref.grouped_flash_ref(q, k, v, causal=causal,
                                         window=window, scale=sc,
                                         return_lse=True)
        e, ne = grad_errors(got, ref.grouped_flash_bwd_ref(
            q, k, v, po, plse, do, causal=causal, window=window, scale=sc))
        if not (e < TOL[dt] and ne < NORM_TOL[dt]):
            raise AssertionError(f"flash_attention_bwd {dt} at {tag}: error "
                                 f"{e}, norm error {ne}")
        del got, po, plse
        library = library_call(q, k, v, do, causal, window, sc)
        d = {"shape": [b, sq, sk, h, kh, hd, dv],
             "mask": ("causal" if causal else "unmasked")
             + (f", window {window}" if window else ""),
             "max_rel_err": e, "norm_err": ne,
             "ms": cuda_ms(call, iters=10, warmup=2),
             "plain_ms": cuda_ms(lambda: ref.grouped_flash_bwd_ref(
                 q, k, v, o, lse, do, causal=causal, window=window,
                 scale=sc), iters=2, warmup=1),
             "library_ms": cuda_ms(library, iters=10, warmup=2)}
        d["device_ms"], d["launches_per_call"], d["grid"] = \
            device_ms_per_call(call, "bwd_d", iters=3, max_per_call=3)
        d["device_ms_by_kernel"] = device_ms_by_kernel(call, "bwd_d", iters=5)
        check_ran(d["device_ms_by_kernel"], FLASH_BWD_BF16, FLASH_BWD_F32,
                  f"flash_attention_bwd bf16 at {tag}")
        lib = device_ms_by_kernel(library, "", iters=5)
        d["library_device_ms"] = sum(lib.values())
        d["library_backend"], d["library_kernels"] = sdpa_backend(library)
        d["bound_ms"], d["bound_by"] = RA.bound_ms(W.flash_bwd(
            q, k, v, causal=causal, window=window))
        d["device_over_library_device"] = (d["device_ms"]
                                           / d["library_device_ms"])
        log("kernels.time.k1_bwd_shape", tag=tag, **d)
        out[tag] = d
        del library
    free_device_memory()
    return out


def k1_bwd_watchdog(ref, kflash) -> list:
    """The backward's watchdog build (``flash_attention_bwd_watchdog``,
    built beside the others) at hd 64, 128 and 192 / 128, over more work
    tiles than SMs, against the plain version (bf16 gates) and whether it
    gives the production build's bits; its launches count apart."""
    dt, cases = torch.bfloat16, []
    for b, s, h, kh, hd, dv in ((2, 1000, 16, 4, 64, 64),
                                (2, 1000, 16, 16, 128, 128),
                                (2, 1000, 16, 16, 192, 128)):
        sc = hd ** -0.5
        q, do = (randn((b, s, h, d), dt, 660 + i) for i, d in
                 enumerate((hd, dv)))
        k, v = (randn((b, s, kh, d), dt, 662 + i) for i, d in
                enumerate((hd, dv)))
        o, lse = kflash.flash_attention(q, k, v, scale=sc, return_lse=True)
        n, w = kflash.bwd_launches.count, kflash.bwd_watchdog_launches.count
        got = kflash.flash_attention_bwd_watchdog(q, k, v, o, lse, do,
                                                  scale=sc)
        torch.cuda.synchronize()
        launched = (kflash.bwd_watchdog_launches.count - w,
                    kflash.bwd_launches.count - n)
        prod = kflash.flash_attention_bwd(q, k, v, o, lse, do, scale=sc)
        po, plse = ref.grouped_flash_ref(q, k, v, scale=sc, return_lse=True)
        e, ne = grad_errors(got, ref.grouped_flash_bwd_ref(
            q, k, v, po, plse, do, scale=sc))
        cases.append({"shape": [b, s, h, kh, hd, dv], "max_rel_err": e,
                      "norm_err": ne, "production_bits": all(
                          torch.equal(x, y) for x, y in zip(got, prod)),
                      "launches_watchdog_production": list(launched)})
        if not (e < TOL[dt] and ne < NORM_TOL[dt] and launched == (1, 0)
                and cases[-1]["production_bits"]):
            raise AssertionError(f"K1 backward watchdog build: {cases[-1]}")
    log("kernels.parity.k1_bwd_watchdog", cases=cases,
        flags=list(kflash.WATCHDOG_FLAGS))
    return cases


def k3_watchdog(ref, kscan) -> list:
    """K3's bf16 single pass on its watchdog build (``mlstm_scan_watchdog``,
    built beside the others) at xlstm's training shape, hymba's SSD heads
    and dims that are not multiples of 64, against the plain version (3e-2
    of max(1, max |plain|)) and whether it gives the production build's
    bits; its launches count apart."""
    dt, cases = torch.bfloat16, []
    for j, (bh, s, dk, dv, scale) in enumerate(((16, 2048, 512, 512, None),
                                                (200, 256, 16, 64, 1.0),
                                                (3, 129, 96, 64, None))):
        x = scan_inputs(bh, s, dk, dv, dt, 640 + 10 * j)
        n, w = kscan.launches.count, kscan.watchdog_launches.count
        got = kscan.mlstm_scan_watchdog(*x, scale=scale, design="single")
        torch.cuda.synchronize()
        launched = (kscan.watchdog_launches.count - w,
                    kscan.launches.count - n)
        prod = kscan.mlstm_scan(*x, scale=scale, design="single")
        want = ref.mlstm_chunkwise_ref(*x, scale=scale).float()
        err = (got.float() - want).abs().max().item()
        cases.append({"shape": [bh, s, dk, dv], "max_abs_err": err,
                      "production_bits": torch.equal(got, prod),
                      "launches_watchdog_production": list(launched)})
        if not (err < SCAN_TOL[dt] * max(1.0, want.abs().max().item())
                and launched == (1, 0) and cases[-1]["production_bits"]):
            raise AssertionError(f"K3 watchdog build: {cases[-1]}")
    log("kernels.parity.k3_watchdog", cases=cases,
        flags=list(kscan.WATCHDOG_FLAGS))
    return cases


def k2_spill(ref, kdecode) -> list:
    """K2's bf16 kernel on its build made to spill
    (``decode_attention_spill``, built beside the others; such builds gave
    wrong bits or faulted while the split ranges were a 64-bit division) at
    G 1, 8 and 16 and 1 to 16 clusters a (row, KV head), lengths at the
    plan's edges: against the plain version (3e-2) on live rows, a row of
    length 0 exactly 0, two calls and the production build bit for bit;
    its launches count apart."""
    dt, cases = torch.bfloat16, []
    for j, (b, s, h, kh, hd) in enumerate((
            (8, 1024, 16, 16, 128), (4, 1024, 32, 4, 64),
            (6, 512, 32, 2, 64), (8, 1024, 16, 2, 128),
            (1, 8192, 8, 1, 64), (1, 4096, 16, 1, 128))):
        q = randn((b, 1, h, hd), dt, 680 + 3 * j)
        k = randn((b, s, kh, hd), dt, 681 + 3 * j)
        v = randn((b, s, kh, hd), dt, 682 + 3 * j)
        cluster, groups = kdecode.mma_plan(s, b, kh)
        n = cluster * groups
        edge = [0, 1, n - 1, n, n + 1, s, (s // n) * n + 1]
        lens = torch.tensor([min(s, edge[i % len(edge)]) for i in range(b)]
                            if b > 1 else [s - 3], dtype=torch.int32,
                            device="cuda")
        c, w = kdecode.launches.count, kdecode.spill_launches.count
        got = kdecode.decode_attention_spill(q, k, v, lens)
        again = kdecode.decode_attention_spill(q, k, v, lens)
        torch.cuda.synchronize()
        launched = (kdecode.spill_launches.count - w,
                    kdecode.launches.count - c)
        prod = kdecode.decode_attention(q, k, v, lens)
        want = ref.grouped_decode_ref(q, k, v, lens)
        live = lens > 0
        err = (got.float() - want.float())[live].abs().max().item()
        cases.append({"shape": [b, s, h, kh, hd], "cluster": cluster,
                      "groups": groups, "max_abs_err": err,
                      "dead_rows_zero": bool((got[~live] == 0).all()),
                      "repeat_bits": torch.equal(got, again),
                      "production_bits": torch.equal(got, prod),
                      "launches_spill_production": list(launched)})
        if not (err < TOL[dt] and cases[-1]["dead_rows_zero"]
                and cases[-1]["repeat_bits"] and cases[-1]["production_bits"]
                and launched == (2, 0)):
            raise AssertionError(f"K2 spilling build: {cases[-1]}")
    log("kernels.parity.k2_spill", cases=cases, tol=TOL[dt],
        flags=list(kdecode.SPILL_FLAGS))
    return cases


def k3_bwd_watchdog(ref, kscan) -> list:
    """K3's backward on its watchdog build (``mlstm_scan_bwd_watchdog``,
    built beside the others) at xlstm's heads, hymba's SSD heads and dims
    that are not multiples of 64, against the plain version (bf16 gates)
    and whether it gives the production build's bits; its launches count
    apart."""
    dt, cases = torch.bfloat16, []
    for j, (bh, s, dk, dv, scale, qk, ssd) in enumerate((
            (4, 256, 512, 512, None, 1.0, False),
            (50, 256, 16, 64, 1.0, 0.5, True),
            (3, 130, 32, 96, None, 1.5, False))):
        x = scan_bwd_inputs(bh, s, dk, dv, dt, 670 + 10 * j, qk, ssd)
        n, w = kscan.bwd_launches.count, kscan.bwd_watchdog_launches.count
        got = kscan.mlstm_scan_bwd_watchdog(*x, scale=scale)
        torch.cuda.synchronize()
        launched = (kscan.bwd_watchdog_launches.count - w,
                    kscan.bwd_launches.count - n)
        prod = kscan.mlstm_scan_bwd(*x, scale=scale)
        e, ne = grad_errors(got, ref.mlstm_chunkwise_bwd_ref(*x, scale=scale))
        cases.append({"shape": [bh, s, dk, dv], "max_rel_err": e,
                      "norm_err": ne, "production_bits": all(
                          torch.equal(a, b) for a, b in zip(got, prod)),
                      "launches_watchdog_production": list(launched)})
        if not (e < TOL[dt] and ne < NORM_TOL[dt] and launched == (1, 0)
                and cases[-1]["production_bits"]):
            raise AssertionError(f"K3 backward watchdog build: {cases[-1]}")
    log("kernels.parity.k3_bwd_watchdog", cases=cases,
        flags=list(kscan.WATCHDOG_FLAGS))
    return cases


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
                   "flash_bwd_dkdv_tma_kernel (work tiles of 128 keys), "
                   "flash_bwd_dq_tma_kernel (work tiles of 128 queries): "
                   "each a TMA producer warpgroup and two wgmma consumer "
                   "warpgroups (setmaxnreg 24 / 240), persistent; float32 "
                   "on the CUDA cores (bwd_dkdv_kernel, bwd_dq_kernel)")
    d["ptxas"] = {n: v for n, v in BWD_PTXAS.items() if f"<{hd}, {hd}>" in n}
    d["library_backend"], d["library_kernels"] = sdpa_backend(library)
    d["bound_ms"], d["bound_by"] = RA.bound_ms(W.flash_bwd(q, k, v))
    d["kept_pairs"] = b * h * W.flash_pairs(s, s, True, 0)
    d["fwd_lse_device_ms"] = device_ms(
        lambda: kflash.flash_attention(q, k, v, return_lse=True),
        K1_FWD, iters=5, alone=True)
    d["fwd_device_ms"] = device_ms(lambda: kflash.flash_attention(q, k, v),
                                   K1_FWD, iters=5, alone=True)
    d["fwd_lse_host_us"] = host_us(
        lambda: kflash.flash_attention(q, k, v, return_lse=True))
    d["fwd_kernel"] = f"{K1_FWD}<{hd}, {hd}>"
    d["fwd_ptxas"] = FWD_PTXAS.get(d["fwd_kernel"])
    # The forward with its row logsumexp: its bound (2 dk + 2 dv
    # operations a kept pair; q, k, v read, o and lse written), and the
    # library's flash forward that returns the logsumexp, on K and V
    # repeated to the query heads outside the timing
    fwd = W.flash(q, k, v, causal=True, window=0)
    d["fwd_lse_bound_ms"], d["fwd_lse_bound_by"] = RA.bound_ms(
        fwd._replace(bytes=fwd.bytes + b * h * s * 4))
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
    d["watchdog"] = k1_bwd_watchdog(ref, kflash)
    d["training_shapes"] = bwd_training_shapes(ref, kflash)
    log("kernels.time", kernel="flash_attention_bwd", **d)
    return d


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
        (16, 2048, 512, 512, None),    # xlstm-350m training, B=4 H=4
        (50, 2048, 16, 64, 1.0),       # hymba-1.5b SSD heads training, B=2
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
        b, by = RA.bound_ms(W.route(logits, 4, capacity=cap))
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
        b, by = RA.bound_ms(W.scan(q, k, v, logf, i))
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
    scan["bound_ms_hymba"], scan["bound_by_hymba"] = RA.bound_ms(
        W.scan(q, k, v, logf, i))
    want = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=1.0).float()
    scan["max_abs_err_hymba"] = (hymba().float() - want).abs().max().item()
    if not scan["max_abs_err_hymba"] < SCAN_TOL[dt] * max(
            1.0, want.abs().max().item()):
        raise AssertionError(f"mlstm_scan at hymba's shape: max err "
                             f"{scan['max_abs_err_hymba']}")
    # At the training shapes, the forward of each step's K3 call under its
    # own plan: xlstm-350m (B 4 x H 4 = 16 row-heads, S 2048, dk = dv = 512)
    # and hymba-1.5b's SSD heads (B 2 x 25 = 50, S 2048, dk 16, dv 64, scale
    # 1.0), inputs drawn as for K3's backward; its launches a step are in
    # the "train.families" lines (``launches``: mlstm_scan).
    for tag, (bh, s, dk, dv, sc, qk, ssd) in (
            ("_train_xlstm", (16, 2048, 512, 512, None, 1.0, False)),
            ("_train_hymba", (50, 2048, 16, 64, 1.0, 0.5, True))):
        q, k, v, logf, i, _ = scan_bwd_inputs(bh, s, dk, dv, dt, 420, qk, ssd)

        def train_fwd(q=q, k=k, v=v, logf=logf, i=i, sc=sc):
            return kscan.mlstm_scan(q, k, v, logf, i, scale=sc)
        scan["plan" + tag] = kscan.scan_plan(bh, s, dk, dv).design
        scan["ms" + tag] = cuda_ms(train_fwd, iters=20, warmup=3)
        scan["plain_ms" + tag] = cuda_ms(
            lambda: ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=sc),
            iters=5, warmup=1)
        (scan["device_ms" + tag], scan["launches_per_call" + tag],
         scan["grid" + tag]) = device_ms_per_call(train_fwd, "mlstm_")
        scan["bound_ms" + tag], scan["bound_by" + tag] = RA.bound_ms(
            W.scan(q, k, v, logf, i))
        want = ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=sc).float()
        scan["max_abs_err" + tag] = (train_fwd().float() - want
                                     ).abs().max().item()
        if not scan["max_abs_err" + tag] < SCAN_TOL[dt] * max(
                1.0, want.abs().max().item()):
            raise AssertionError(f"mlstm_scan at {tag[1:]}: max err "
                                 f"{scan['max_abs_err' + tag]}")
        del q, k, v, logf, i, want
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
                     "dv=64 scale 1.0; _train_xlstm: BH=16 S=2048 "
                     "dk=dv=512; _train_hymba: BH=50 S=2048 dk=16 dv=64 "
                     "scale 1.0) bf16")
    scan["library_ms"] = None
    torch.cuda.synchronize()
    for name, d in (("moe_topk", router), ("mlstm_scan", scan)):
        log("kernels.time", kernel=name, **d)
    router["max_abs_err_f32"] = worst_w["float32"]
    scan["max_abs_err_f32"] = worst_s["float32"]
    return {"moe_topk": router, "mlstm_scan": scan}


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
SCAN_BWD_BF16 = ("scan_bwd_gates_warp_kernel", "scan_bwd_walk_tma_kernel",
                 "scan_bwd_norm_wgmma_kernel", "scan_bwd_grad_tma_kernel",
                 "scan_bwd_final_kernel")
SCAN_BWD_F32 = ("scan_bwd_outer_kernel", "scan_bwd_carry_kernel",
                "scan_bwd_norm_kernel", "scan_bwd_grad_kernel")
FLASH_BWD_BF16 = ("flash_bwd_dkdv_tma_kernel", "flash_bwd_dq_tma_kernel")
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
        # the chunk states' bytes a call: the walks write C and dC as bf16,
        # the gradient kernel reads C once and dC twice; and their rates
        by = d["device_ms_by_kernel" + tag]
        cells = bh * -(-s // kscan.BWD_CHUNK) * dk * dv
        d["state_bytes" + tag] = {"walks": 4 * cells, "gradient": 6 * cells,
                                  "total": 10 * cells}
        d["state_tb_per_s" + tag] = {
            "walks": 4 * cells / by["scan_bwd_walk_tma_kernel"] / 1e9,
            "gradient": 6 * cells / by["scan_bwd_grad_tma_kernel"] / 1e9}
        d["bound_ms" + tag], by = RA.bound_ms(W.scan_bwd(q, k, v, logf, i))
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
    d["watchdog"] = k3_bwd_watchdog(ref, kscan)
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
        d["bound_ms" + tag], by = RA.bound_ms(W.route_bwd(logits, k))
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
    d["bound_ms"], d["bound_by"] = RA.bound_ms(W.flash_bwd(q, k, v))
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
    d["design"] = ("bf16: bwd_delta_kernel, flash_bwd_dkdv_tma_kernel<192, "
                   "128> (dV and dK work tiles apart), flash_bwd_dq_tma_kernel"
                   "<192, 128>, each a TMA producer and two wgmma consumers; "
                   "float32: bwd_dkdv_kernel, bwd_dq_kernel on the CUDA "
                   "cores")
    d["ptxas"] = {n: v for n, v in BWD_PTXAS.items() if "<192, 128>" in n}
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
    d["bound_ms_hymba"], _ = RA.bound_ms(W.flash_bwd(q, k, v, window=1024))
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
        "decode_step_weight_read_ms": step_bytes / RA.HBM_BW * 1e3,
        "decode_step_routed_weight_read_ms":
            routed_bytes / RA.HBM_BW * 1e3,
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
        flops += per_pair * W.flash_pairs(s, s, True, w)
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
    kflash.tma_launches.reset()
    kflash.bwd_launches.reset()
    copies = kflash.tma_copies.count
    r = run_steps(step, box, batch, 4,
                  lambda: {"flash_attention": kflash.launches.count,
                           "flash_attention_tma": kflash.tma_launches.count,
                           "flash_attention_bwd": kflash.bwd_launches.count},
                  (K1_FWD, "bwd_d"))
    launches = r["launches"]
    losses, wall = r["losses"], r["wall"]
    flops = model_flops(cfg, box["state"]["params"], b, s)
    from repro_torch.configs.base import ShapeConfig
    n = RA.count_params(box["state"]["params"])
    roof = RA.analyze(lambda: step(box["state"], batch),
                      model_flops=RA.model_flops(
                          cfg, ShapeConfig("train.steps", s, b, "train"), n, 1),
                      dtype=cfg.dtype)
    roofline_log("train_step", roof, wall, r["busy"], arch=cfg.name, batch=b,
                 seq=s, grad_accum=2, remat=cfg.remat)
    result = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
              "batch": b, "seq": s, "grad_accum": 2, "remat": cfg.remat,
              "losses": losses, "step_wall_ms": r["walls"],
              "step_wall_ms_median_2_4": wall, "step_busy_ms": r["busy"],
              "step_top_kernels": r["top"],
              "step_k1_ms_launches": {"forward": r["named"][K1_FWD],
                                      "backward": r["named"]["bwd_d"]},
              "tokens_per_s": b * s / wall * 1e3,
              "max_memory_allocated_bytes": r["peak"],
              "model_flops_per_step": flops,
              "model_flops_share_of_989_tflops": flops / (wall / 1e3) / RA.PEAK_FLOPS[torch.bfloat16],
              "launches": launches}
    log("train.steps", **result)
    if not (all(np.isfinite(losses)) and losses[3] < losses[0]):
        raise AssertionError(f"training losses {losses}")
    if not (all(c > 0 for c in launches.values())
            and r["named"][K1_FWD][1] > 0):
        raise AssertionError(f"K1 launches on the training path: {launches}, "
                             f"{K1_FWD} in the profiled step "
                             f"{r['named'][K1_FWD]}")
    del model, box, r, step
    return {**launches,
            "flash_attention_tma_copies": kflash.tma_copies.count - copies}


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
            "flash_attention_tma": kflash.tma_launches,
            "flash_attention_tma_copies": kflash.tma_copies,
            "flash_attention_bwd": kflash.bwd_launches,
            "mlstm_scan": kscan.launches, "mlstm_scan_bwd": kscan.bwd_launches,
            "mlstm_scan_tma_copies": kscan.tma_copies,
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
                      flops / (wall / 1e3) / RA.PEAK_FLOPS[torch.bfloat16],
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
# ---------------------------------------------------------------- roofline
def roofline_log(step: str, roof, wall_ms: float, busy: float,
                 **extra) -> None:
    """One ``roofline`` line: ``roofline.analysis.analyze``'s counts and
    terms for a step, beside its measured wall and busy ms."""
    d = roof.to_dict()
    t_roof = roof.roofline_time * 1e3
    log("roofline", step=step, flops=d["flops"], hbm_bytes=d["hbm_bytes"],
        coll_bytes=d["coll_bytes"], model_flops=d["model_flops"],
        t_compute_ms=d["t_compute"] * 1e3, t_memory_ms=d["t_memory"] * 1e3,
        t_collective_ms=d["t_collective"] * 1e3, bottleneck=d["bottleneck"],
        roofline_ms=t_roof, mfu_bound=d["mfu_bound"],
        useful_flops_ratio=d["useful_flops_ratio"], dtype=d["dtype"],
        flops_by_type=d["flops_by_type"], kernels=d["kernels"],
        wall_ms=wall_ms, busy_ms=busy, wall_over_roofline=wall_ms / t_roof,
        busy_over_roofline=busy / t_roof,
        peak_flops={t: RA.PEAK_FLOPS[getattr(torch, t)]
                    for t in d["flops_by_type"]},
        hbm_bytes_per_s=RA.HBM_BW, card=card_line(),
        **extra)
    if not (roof.flops > 0 and roof.hbm_bytes > 0 and t_roof > 0
            and roof.kernels):
        raise AssertionError(f"roofline of {step}: nothing counted, {d}")


def wall_ms(fn, n: int) -> float:
    """Host ms a call, over ``n`` calls ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def roofline_serving_phase(model, params) -> None:
    """The roofline of llama3.2-1b's decode step (B 8, S_max 1024, 700
    positions live, random caches) and ``prefill_batch`` (8 x 256), bf16,
    as ``launch/profile_decode.py`` times them: ``analyze`` counts in one
    run; the wall is timed over 20 calls and the busy time in a profiler
    window, in runs of their own."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.weights import tree_leaves
    cfg = model.cfg
    caches = model.init_cache(8, 1024)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for leaf in tree_leaves(caches):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    tok = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen,
                        device="cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 256))
             .astype(np.int32), "lengths": np.full((8,), 256, np.int32)}
    n = RA.count_params(params)
    for name, fn, shape in (
            ("decode_step", lambda: model.decode_step(params, caches, tok, 700),
             ShapeConfig("decode_step", 701, 8, "decode")),
            ("prefill_batch", lambda: model.prefill_batch(params, batch, 1024),
             ShapeConfig("prefill_batch", 256, 8, "prefill"))):
        for _ in range(3):
            fn()
        roof = RA.analyze(fn, model_flops=RA.model_flops(cfg, shape, n, 1),
                          dtype=cfg.dtype)
        wall = wall_ms(fn, 20)
        busy, top, _ = busy_ms(fn)
        roofline_log(name, roof, wall, busy, arch=cfg.name, batch=8,
                     seq=shape.seq_len, top_kernels=top[:5])


# ------------------------------------------------------------ distributed
def distributed_phase(Model, get_arch, kflash) -> dict:
    """The distributed layer on a one-rank NCCL group (one card: two ranks
    cannot share it; the CPU tests hold 2 and 4 gloo ranks).  llama3.2-1b
    at full width and depth through ``Model.shardmap_attn`` (K1 on the
    rank's heads, the ``all_reduce`` over the model axis): prefill
    logits against the same model without the hook, float32 to
    ``MODEL_TOL``, bf16's max error printed; K1's launches counted on that
    path (set to 0 just before, read just after) and the collectives the
    prefill issues; then ``compressed_psum`` over NCCL equal to one local
    int8 round trip.  Returns the launches of the bf16 path."""
    import torch.distributed as dist
    from repro_torch.distributed.shardmap_attention import make_shardmap_gqa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import grad_compress as gc_
    # the rendezvous is a file of this checkout: no port to share
    store = ROOT / "build" / "chip_smoke_pg"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        launches = {}
        rng = np.random.default_rng(5)
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_arch("llama3.2-1b"), dtype=dtype)
            model = Model(cfg, device="cuda")
            params = model.init_params(
                torch.Generator(device="cuda").manual_seed(0))
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 512))
                     .astype(np.int32)}
            want, _ = model.prefill(params, batch, 1024)
            model.shardmap_attn = make_shardmap_gqa(mesh, cfg)
            kflash.launches.reset()
            got, _ = model.prefill(params, batch, 1024)
            torch.cuda.synchronize()
            launches = {"flash_attention": kflash.launches.count}
            coll = RA.collective_bytes(model.prefill, params, batch, 1024)
            err = (got.float() - want.float()).abs().max().item()
            log("distributed.shardmap_attn", arch=cfg.name, dtype=dtype,
                batch=4, seq=512, max_abs_err=err,
                tol=MODEL_TOL if dtype == "float32" else None,
                launches=launches, collectives=coll,
                mesh={"data": 1, "model": 1}, backend="nccl")
            if dtype == "float32" and not err < MODEL_TOL:
                raise AssertionError(f"shardmap_attn prefill: {err}")
            if not (launches["flash_attention"] >= cfg.n_layers
                    and coll["counts"]["all-reduce"] == cfg.n_layers):
                raise AssertionError(f"shardmap_attn path: {launches}, {coll}")
            del model, params, got, want
            free_device_memory()
        x = randn((1 << 20,), torch.float32, 77)
        y = gc_.compressed_psum(x)
        q, scale = gc_._quant(x)
        want = gc_._dequant(q, scale)
        err = (y - x).abs().max().item()
        log("distributed.compressed_psum", n=x.numel(), backend="nccl",
            world_size=1, equal_to_local_round_trip=torch.equal(y, want),
            max_abs_err_vs_input=err, quant_step=scale.item())
        if not torch.equal(y, want):
            raise AssertionError("compressed_psum over one rank is not the "
                                 "local int8 round trip")
    finally:
        dist.destroy_process_group()
    return launches


# ---------------------------------------------------------------- sharded
@contextlib.contextmanager
def counting_local_map(ops):
    """Count ``ops.on_shards`` calls (each a kernel or a MoE gather under
    ``local_map``) for the block: {"calls": n}."""
    box = {"calls": 0}
    inner = ops.on_shards

    def counted(*a, **kw):
        box["calls"] += 1
        return inner(*a, **kw)
    ops.on_shards = counted
    try:
        yield box
    finally:
        ops.on_shards = inner


def placement_list(tree) -> list:
    from repro_torch.models.weights import tree_leaves
    return [t.placements for t in tree_leaves(tree)]


def timed_steps(step, box: dict, batch, n: int, counters: dict) -> dict:
    """``n`` steps of ``step`` from ``box["state"]`` (replaced step by
    step), each timed on the host; the launch counts (set to 0 just
    before) read just after; then one more step in a profiler window
    for the busy ms."""
    for c in counters.values():
        c.reset()
    losses, walls = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        box["state"], metrics = step(box["state"], batch)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    launches = {k: c.count for k, c in counters.items()}

    def one():
        box["state"], _ = step(box["state"], batch)
    busy, top, _ = busy_ms(one, top=5)
    return {"losses": losses, "walls": walls, "launches": launches,
            "busy": busy, "top": top}


def sharded_train(SH, mesh, ops, Model, trainer, optimizer, cfg, b, s,
                  accum, ep, seed, counters, need) -> dict:
    """Train ``cfg`` twice from one state: placed by
    ``sharding.device_put`` on ``mesh`` (every leaf a DTensor), then as
    plain tensors; 2 timed steps each (and a profiled third).  The kernels
    in ``need`` must launch as often in the DTensor steps as in the plain
    ones, through ``local_map``; the parameters' placements must stay.
    Returns both runs' readings."""
    model = Model(cfg, device="cuda")
    tcfg = trainer.TrainConfig(grad_accum=accum, opt=optimizer.OptimizerConfig(
        lr=1e-4, warmup_steps=0, total_steps=4))

    def state():
        # the same bits each time (a seeded generator): the card holds one
        # state beside a step's (qwen2-moe's 3 layers fill it), not two
        return trainer.init_state(
            model, tcfg, torch.Generator(device="cuda").manual_seed(0))
    batch = family_batch(cfg, b, s, seed, getattr(torch, cfg.dtype))
    step = trainer.make_train_step(model, tcfg)
    box = {"state": state()}
    box["state"] = SH.device_put(box["state"], SH.state_shardings(
        box["state"], mesh, ep=ep), mesh)
    before = placement_list(box["state"])
    dbatch = SH.device_put(batch, SH.batch_shardings(batch, mesh), mesh)
    with counting_local_map(ops) as lm:
        d = timed_steps(step, box, dbatch, 2, counters)
    exchange = moe_exchange(cfg, step, box, dbatch, b * s // accum, accum) \
        if cfg.moe is not None else None
    kept = placement_list(box["state"]) == before
    del box["state"]
    free_device_memory()
    box["state"] = state()
    p = timed_steps(step, box, batch, 2, counters)
    del box, step, model, batch
    free_device_memory()
    out = {"dtensor": d, "plain": p, "placements_kept": kept,
           "local_map_calls": lm["calls"], "exchange": exchange}
    if not kept:
        raise AssertionError(f"{cfg.name}: the step moved the placements")
    if not all(d["launches"][n] == p["launches"][n] > 0 for n in need):
        raise AssertionError(f"{cfg.name}: launches {d['launches']} under "
                             f"local_map, {p['launches']} plain")
    return out


def moe_exchange(cfg, step, box, dbatch, t: int, accum: int) -> dict:
    """One more DTensor step of a MoE model with its collectives counted
    (``analysis.collective_bytes``): the MoE layers' all-to-alls
    (``all_to_all_single``) must be 4 a layer and micro-batch (6 under
    remat), each of ``moe.exchange_bytes`` for ``t`` tokens on this mesh
    (one rank: rows 1, the experts whole)."""
    from repro_torch.models import moe as M
    m = cfg.moe

    def one():
        box["state"], _ = step(box["state"], dbatch)
    c = RA.collective_bytes(one, by_op=True)
    per = M.exchange_bytes(t, m.top_k, 1.25, m.routed_total(), cfg.d_model,
                           torch.finfo(getattr(torch, cfg.dtype)).bits // 8,
                           rows=1)
    calls = (cfg.n_layers - cfg.first_k_dense) * accum * (
        6 if cfg.remat else 4)
    got = c["by_op"].get("all_to_all_single", {"count": 0, "bytes": 0})
    out = {"all_to_all_single": got, "per_call_bytes_formula": per,
           "calls_formula": calls, "by_op": c["by_op"],
           "bytes_by_kind": {k: c[k] for k in ("all-gather", "all-reduce",
                                               "reduce-scatter", "all-to-all")}}
    if got != {"count": calls, "bytes": calls * per}:
        raise AssertionError(f"{cfg.name} exchange: {out}")
    return out


def sharded_elastic(SH, mesh, Model, trainer, optimizer, cfg, b, s, seed):
    """llama at full width with 2 layers, float32: 2 steps on the (1, 1)
    mesh against 2 plain steps (losses to 1e-4, every parameter leaf to
    1e-4 x max(1, max |plain|)); the state after step 1 saved sharded and,
    gathered, unsharded (files byte-identical), then restored onto the
    mesh (step 2's loss bit for bit the uninterrupted one's) and as a
    plain CUDA state (1e-6 relative)."""
    import filecmp
    import inspect
    import shutil
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.weights import tree_leaves, tree_map
    from repro_torch.training.checkpoint import CheckpointManager
    model = Model(cfg, device="cuda")
    tcfg = trainer.TrainConfig(opt=optimizer.OptimizerConfig(
        lr=1e-4, warmup_steps=0, total_steps=4))
    s0 = trainer.init_state(model, tcfg,
                            torch.Generator(device="cuda").manual_seed(0))
    batch = family_batch(cfg, b, s, seed, torch.float32)
    dbatch = SH.device_put(batch, SH.batch_shardings(batch, mesh), mesh)
    step = trainer.make_train_step(model, tcfg)
    d0 = SH.device_put(s0, SH.state_shardings(s0, mesh), mesh)
    d1, m1 = step(d0, dbatch)
    ck = ROOT / "build" / "sharded_ck"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.monotonic()
    CheckpointManager(str(ck / "sharded")).save(1, d1)
    save_s = time.monotonic() - t0
    CheckpointManager(str(ck / "unsharded")).save(
        1, tree_map(lambda t: t.full_tensor(), d1))
    step_dir = Path("step_00000001")
    names = sorted(p.name for p in (ck / "unsharded" / step_dir).iterdir())
    same = names == sorted(p.name for p in (ck / "sharded" / step_dir).iterdir()) \
        and all(filecmp.cmp(ck / "sharded" / step_dir / n,
                            ck / "unsharded" / step_dir / n, shallow=False)
                for n in names)
    files_gb = sum((ck / "sharded" / step_dir / n).stat().st_size
                   for n in names) / 1e9
    d2, m2 = step(d1, dbatch)
    dparams = [t.full_tensor() for t in tree_leaves(d2["params"])]
    dlosses = [m1["loss"].item(), m2["loss"].item()]
    del d1, d2
    mgr = CheckpointManager(str(ck / "sharded"))
    r = mgr.restore(1, d0)
    restored_placements = placement_list(r) == placement_list(d0)
    _, mr = step(r, dbatch)
    del r, d0
    p = mgr.restore(1, s0)
    _, mp = step(p, batch)
    del p
    p1, pm1 = step(s0, batch)
    p2, pm2 = step(p1, batch)
    plosses = [pm1["loss"].item(), pm2["loss"].item()]
    loss_err = max(abs(x - y) for x, y in zip(dlosses, plosses))
    param_err = max(((x - y).abs().max() / max(1.0, y.abs().max().item())).item()
                    for x, y in zip(dparams, tree_leaves(p2["params"])))
    resumed, plain_resumed = mr["loss"].item(), mp["loss"].item()
    plain_rel = abs(plain_resumed - dlosses[1]) / abs(dlosses[1])
    shutil.rmtree(ck, ignore_errors=True)
    result = {"arch": cfg.name, "dtype": "float32", "layers": cfg.n_layers,
              "batch": [b, s], "dtensor_losses": dlosses,
              "plain_losses": plosses,
              "loss_max_abs_err": loss_err, "param_max_rel_err": param_err,
              "checkpoint_gb": files_gb, "sharded_save_s": save_s,
              "distribute_tensor_takes_src_data_rank": "src_data_rank" in
              inspect.signature(distribute_tensor).parameters,
              "files_byte_identical": same,
              "restored_placements_kept": restored_placements,
              "step2_loss": dlosses[1], "step2_loss_resumed_same_mesh": resumed,
              "step2_loss_resumed_plain": plain_resumed,
              "plain_resume_rel_err": plain_rel,
              "tolerance": {"loss": 1e-4, "params": "1e-4 x max(1, max|plain|)",
                            "same_mesh_resume": "bit for bit",
                            "plain_resume": "1e-6 relative"}}
    log("sharded.elastic", **result)
    del model, s0, p1, p2, dparams, step
    free_device_memory()
    if not (loss_err < 1e-4 and param_err < 1e-4):
        raise AssertionError(f"sharded float32 steps: loss {loss_err}, "
                             f"params {param_err}")
    if not (same and restored_placements and resumed == dlosses[1]
            and plain_rel < 1e-6):
        raise AssertionError(f"elastic drill: {result}")
    return result


def sharded_decode(SH, ops, Model, get_arch, counters) -> dict:
    """llama3.2-1b, float32, full size, on a (1, 1, 1) (pod, data, model)
    mesh: parameters by ``params_shardings``, caches by
    ``Model.cache_pspecs`` (placed again after every step, the reference's
    ``out_shardings``); a prefill of 4 x 128 tokens and 8 greedy decode
    steps against the plain path: logits to ``MODEL_TOL``, tokens
    identical, K1 and K2 launched as often."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.weights import tree_map
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), dtype="float32")
    model = Model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    b, s, smax, steps = 4, 128, 256, 8
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32), device="cuda")
    spec = model.cache_pspecs(mesh, b, smax)

    def run(p, put):
        for c in counters.values():
            c.reset()
        logits, out = [], []
        torch.cuda.synchronize()
        t0 = time.monotonic()
        lg, caches = model.prefill(p, {"tokens": put(toks)}, smax)
        caches = put(caches, spec)
        for i in range(steps):
            full = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
            logits.append(full.float())
            tok = full[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
            lg, caches = model.decode_step(p, caches, put(tok), s + i)
            caches = put(caches, spec)
        full = lg.full_tensor() if hasattr(lg, "full_tensor") else lg
        logits.append(full.float())
        torch.cuda.synchronize()
        return (logits, torch.cat(out, 1), (time.monotonic() - t0) * 1e3,
                {k: c.count for k, c in counters.items()})

    def put_d(t, sp=None):
        if sp is None:
            return SH.device_put(t, SH.batch_shardings(t, mesh), mesh)
        return SH.device_put(t, tree_map(lambda c, x: SH.placements(x, mesh),
                                         t, sp), mesh)
    dparams = SH.device_put(params, SH.params_shardings(params, mesh), mesh)
    with implicit_replication(), counting_local_map(ops) as lm:
        dl, dtok, dwall, dlaunch = run(dparams, put_d)
    pl, ptok, pwall, plaunch = run(params, lambda t, sp=None: t)
    err = max((x - y).abs().max().item() for x, y in zip(dl, pl))
    result = {"arch": cfg.name, "dtype": "float32", "mesh": [1, 1, 1],
              "batch": b, "prompt": s, "smax": smax, "decode_steps": steps,
              "max_abs_err": err, "tol": MODEL_TOL,
              "tokens_identical": torch.equal(dtok, ptok),
              "wall_ms": {"dtensor": dwall, "plain": pwall},
              "launches": {"dtensor": dlaunch, "plain": plaunch},
              "local_map_calls": lm["calls"]}
    log("sharded.decode", **result)
    del model, params, dparams, dl, pl
    free_device_memory()
    if not (err < MODEL_TOL and result["tokens_identical"]):
        raise AssertionError(f"sharded decode: {result}")
    if not all(dlaunch[n] == plaunch[n] > 0 for n in
               ("flash_attention", "decode_attention")):
        raise AssertionError(f"sharded decode launches: {result}")
    return dlaunch


def sharded_phase(ops, Model, trainer, optimizer, get_arch) -> dict:
    """The sharded program run for real on one NCCL rank: one card, and
    two ranks cannot share it in one communicator, so the mesh is (1, 1)
    (and (1, 1, 1) for the pod axis); the CPU tests hold 4 and 8 gloo
    ranks (tests/test_torch_sharded.py).  Every state, batch and cache is
    placed by ``sharding.device_put``, every tensor of a step is a DTensor,
    and K1-K4 and their backward kernels launch under ``local_map``
    (``kernels.ops``): llama3.2-1b bf16 at full size (B 4, S 4096, 2
    micro-batches, remat) against the same steps on plain tensors (wall
    and busy ms of both, launches equal, placements kept); at 2 layers in
    float32 with the elastic drill (``sharded_elastic``); xlstm-350m
    (full) and qwen2-moe-a2.7b (3 of 24 layers, experts over the model
    axis) in bf16; llama3.2-1b's float32 decode (``sharded_decode``).
    bf16 losses within 3e-2 x max(1, |plain|) of the plain steps'.
    Returns each path's launches under ``local_map``."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    store = ROOT / "build" / "chip_smoke_pg_sharded"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=0, world_size=1)
    counters = bwd_counters()
    from repro_torch.kernels import decode_attention as kdecode
    counters["decode_attention"] = kdecode.launches
    by = {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        runs = [("llama3.2-1b", get_arch("llama3.2-1b"), 4, 4096, 2, False,
                 ("flash_attention", "flash_attention_tma",
                  "flash_attention_bwd")),
                ("xlstm-350m", get_arch("xlstm-350m"), 4, 2048, 1, False,
                 ("mlstm_scan", "mlstm_scan_bwd")),
                ("qwen2-moe-a2.7b", dataclasses.replace(
                    get_arch("qwen2-moe-a2.7b"), n_layers=3), 2, 1024, 1,
                 True, ("moe_topk", "moe_route_bwd", "flash_attention",
                        "flash_attention_bwd"))]
        for j, (name, cfg, b, s, accum, ep, need) in enumerate(runs):
            t0 = time.monotonic()
            r = sharded_train(SH, mesh, ops, Model, trainer, optimizer, cfg,
                              b, s, accum, ep, 90 + j, counters, need)
            errs = [abs(x - y) / max(1.0, abs(y)) for x, y in
                    zip(r["dtensor"]["losses"], r["plain"]["losses"])]
            log("sharded.train", arch=name, layers=cfg.n_layers,
                dtype=cfg.dtype, batch=b, seq=s, grad_accum=accum,
                experts_over_model=ep, mesh={"data": 1, "model": 1},
                backend="nccl", losses={k: r[k]["losses"] for k in
                                        ("dtensor", "plain")},
                loss_max_rel_err=max(errs), tol=TOL[torch.bfloat16],
                step_wall_ms={k: r[k]["walls"] for k in ("dtensor", "plain")},
                step_busy_ms={k: r[k]["busy"] for k in ("dtensor", "plain")},
                top_kernels={k: r[k]["top"] for k in ("dtensor", "plain")},
                launches={k: r[k]["launches"] for k in ("dtensor", "plain")},
                local_map_calls=r["local_map_calls"],
                placements_kept=r["placements_kept"],
                moe_exchange=r["exchange"],
                seconds=time.monotonic() - t0)
            if not max(errs) < TOL[torch.bfloat16]:
                raise AssertionError(f"{name} sharded losses {errs}")
            by[f"{name} training (sharded)"] = r["dtensor"]["launches"]
        sharded_elastic(SH, mesh, Model, trainer, optimizer, dataclasses.replace(
            get_arch("llama3.2-1b"), dtype="float32", n_layers=2), 2, 1024, 97)
        by["llama3.2-1b decode (sharded)"] = sharded_decode(
            SH, ops, Model, get_arch, counters)
    finally:
        dist.destroy_process_group()
    return by


# ---------------------------------------------------------------- dry-run
# The cells the dry-run traces on the card, (arch, shape, multi-pod,
# variant): between them K1 and its backward, K2, K3 and K4 and its
# backward.
DRYRUN_CELLS = [("llama3.2-1b", "train_4k", False, {}),
                ("llama3.2-1b", "prefill_32k", False, {}),
                ("llama3.2-1b", "decode_32k", False, {}),
                ("llama3.2-1b", "decode_32k", True, {}),
                ("qwen2-moe-a2.7b", "train_4k", False, {"ep": True}),
                ("xlstm-350m", "prefill_32k", False, {})]
DRYRUN_PEAK_TOL = 0.15        # traced peak against max_memory_allocated


class SpecMesh:
    """A mesh's axis names and sizes, all the sharding rules read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def spec_argument_bytes(arch: str, shape_name: str, multi_pod: bool,
                        variant: dict) -> int:
    """Rank 0's bytes of a cell's step inputs from the sharding specs
    alone, without DTensor: each leaf's bytes over the product of the axes
    its spec shards it on (parameters with ``ep`` as the variant says,
    the optimizer state (bf16 m, v and the step) and the batch; or the
    caches and the token)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import tree_leaves
    from repro_torch.training import optimizer
    mesh = SpecMesh(*dryrun.MESHES[multi_pod])
    cfg, shape = get_arch(arch), SHAPES[shape_name]

    def nbytes(leaf, spec) -> int:
        parts = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)) if ax else ():
                parts *= mesh.shape[a]
        return leaf.numel() * leaf.element_size() // parts

    def tree(t, spec_fn) -> int:
        got = []
        SH.tree_map_with_path(lambda p, x: got.append(nbytes(x, spec_fn(
            p, x))), t)
        return sum(got)
    model = Model(cfg, device="meta")
    meta = model.init_params()
    ep = variant.get("ep", False)
    total = tree(meta, lambda p, x: SH.param_spec(p, x, mesh, ep=ep))
    b, s = shape.global_batch, shape.seq_len
    tok = torch.empty((b, s if shape.kind != "decode" else 1),
                      dtype=torch.int32, device="meta")
    total += (2 if shape.kind == "train" else 1) * nbytes(
        tok, SH.batch_spec(tok, mesh))
    if shape.kind == "train":
        state = optimizer.init_state(optimizer.OptimizerConfig(
            state_dtype="bfloat16"), meta)
        total += tree(state, lambda p, x: SH.param_spec(p, x, mesh))
    if shape.kind == "decode":
        caches = model.init_cache(b, s, device="meta")
        specs = model.cache_pspecs(mesh, b, s)
        total += sum(nbytes(c, sp) for c, sp in zip(tree_leaves(caches),
                                                    _spec_leaves(specs)))
    return total


def _spec_leaves(tree) -> list:
    """The spec tuples of a cache spec tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def dryrun_phase() -> dict:
    """The dry-run on the card: (a) each of ``DRYRUN_CELLS`` traced at full
    size as rank 0's program over DTensor on a fake group of 256 or 512
    ranks, under ``FakeTensorMode``, on the kernel path
    (``launch.dryrun.run_cell``, device "cuda"): every cell ok, its
    argument bytes equal to the spec-derived sum, and nothing allocated on
    the card (``memory_allocated`` the same after, the peak after
    ``reset_peak_memory_stats`` not above it); (b) the one-rank check
    (``one_rank_phase``).  Returns each kernel's calls over the cells."""
    from repro_torch.launch import dryrun
    counted = {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for arch, shape, mp, variant in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, mp, variant=variant, device="cuda")
        r, mem = rec["roofline"], rec["memory"]
        want = spec_argument_bytes(arch, shape, mp, variant)
        for name, k in r["kernels"].items():
            counted[name] = counted.get(name, 0) + k["calls"]
        from repro_torch.configs import get_arch
        from repro_torch.configs.base import SHAPES
        exchange = dryrun.moe_exchange(get_arch(arch), SHAPES[shape], SpecMesh(
            *dryrun.MESHES[mp]), variant)
        log("dryrun.cell", arch=arch, shape=shape, mesh=rec["mesh"],
            variant=variant, status=rec["status"], trace_s=rec["trace_s"],
            argument_gb=mem["argument_bytes"] / 2**30,
            argument_bytes=mem["argument_bytes"], spec_argument_bytes=want,
            peak_gb=mem["peak_bytes"] / 2**30, temp_gb=mem["temp_bytes"] / 2**30,
            output_gb=mem["output_bytes"] / 2**30,
            flops_by_type=r["flops_by_type"], coll_bytes=r["coll_bytes"],
            coll_detail=r["coll_detail"], coll_counts=r["coll_counts"],
            coll_by_op=r["coll_by_op"], moe_exchange_formula=exchange,
            bottleneck=r["bottleneck"], t_compute_ms=r["t_compute"] * 1e3,
            t_memory_ms=r["t_memory"] * 1e3,
            t_collective_ms=r["t_collective"] * 1e3,
            kernels={n: k["calls"] for n, k in r["kernels"].items()},
            card=card_line())
        if rec["status"] != "ok" or mem["argument_bytes"] != want:
            raise AssertionError(f"dry-run {arch} {shape}: {rec['status']}, "
                                 f"arguments {mem['argument_bytes']} != {want}")
        # the MoE layers' all-to-alls are the exchange's formula
        if r["coll_by_op"].get("all_to_all_single") != exchange:
            raise AssertionError(f"dry-run {arch} {shape}: all-to-alls "
                                 f"{r['coll_by_op']}, formula {exchange}")
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    log("dryrun.memory", allocated_before=before, allocated_after=after,
        peak_after_reset=peak)
    if after != before or peak > before:
        raise AssertionError(f"the dry-run allocated on the card: {before} "
                             f"-> {after}, peak {peak}")
    reached = {"flash_attention", "flash_attention_bwd", "decode_attention",
               "mlstm_scan", "moe_topk", "moe_route_bwd"}
    if not reached <= set(counted):
        raise AssertionError(f"dry-run kernels {counted}, want {reached}")
    log("dryrun.kernels", calls=counted)
    one_rank_phase()
    return counted


def one_rank_phase() -> None:
    """The dry-run against a real run on the card, one rank: llama3.2-1b's
    train step at ``train.steps``' shape (B 4, S 4096, 2 micro-batches,
    remat, AdamW's float32 state) and its decode step (B 8, S_max 1024,
    701 positions live), each run for real (``analyze``'s flops; the peak
    of ``max_memory_allocated`` over one step, reset just before it) and
    traced on a one-rank fake mesh.  The traced flops by type must equal
    the real run's exactly, the traced peak be within
    ``DRYRUN_PEAK_TOL`` of the real one."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import Model
    from repro_torch.training import optimizer, trainer
    cfg = get_arch("llama3.2-1b")
    b, s = 4, 4096
    tcfg = trainer.TrainConfig(grad_accum=2, opt=optimizer.OptimizerConfig(
        lr=1e-4, warmup_steps=0, total_steps=4))
    model = Model(cfg, device="cuda")
    box = {"state": trainer.init_state(
        model, tcfg, torch.Generator(device="cuda").manual_seed(0))}
    model._buffers.clear()          # the state alone holds the weights
    model.params = None
    raw = SyntheticTokens(cfg.vocab_size, seed=0).batch(0, 0, b, s)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in raw.items()}
    step = trainer.make_train_step(model, tcfg)
    box["state"], _ = step(box["state"], batch)           # warm
    real = {}

    def measured(fn, *args) -> tuple:
        """One call under ``analyze`` (which holds no memory of the card):
        its ``max_memory_allocated``, reset just before, and its counts."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        roof = RA.analyze(fn, *args, dtype=cfg.dtype)
        return torch.cuda.max_memory_allocated(), roof
    real["train_step"] = measured(step, box["state"], batch)
    del box, batch, step
    free_device_memory()
    model = Model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    caches = model.init_cache(8, 1024)
    tok = torch.zeros((8, 1), dtype=torch.int32, device="cuda")
    model.decode_step(params, caches, tok, 700)            # warm
    real["decode_step"] = measured(model.decode_step, params, caches, tok, 700)
    del model, params, caches, tok
    free_device_memory()
    traced = {
        "train_step": dryrun.trace(cfg, ShapeConfig("train.steps", s, b,
                                                    "train"),
                                   (1, 1), ("data", "model"), device="cuda",
                                   train_cfg=tcfg),
        "decode_step": dryrun.trace(cfg, ShapeConfig("decode_step", 1024, 8,
                                                     "decode"),
                                    (1, 1), ("data", "model"), device="cuda",
                                    pos=700)}
    for name, (peak, roof) in real.items():
        rec = traced[name]
        want = roof.to_dict()["flops_by_type"]
        got = rec["roofline"]["flops_by_type"]
        traced_peak = rec["memory"]["peak_bytes"]
        log("dryrun.one_rank", step=name, real_flops_by_type=want,
            traced_flops_by_type=got, real_kernels=roof.kernels,
            traced_kernels=rec["roofline"]["kernels"],
            real_max_memory_allocated=peak, traced_peak_bytes=traced_peak,
            traced_argument_bytes=rec["memory"]["argument_bytes"],
            peak_ratio=traced_peak / peak, tol=DRYRUN_PEAK_TOL,
            trace_s=rec["trace_s"], card=card_line())
        if got != want:
            raise AssertionError(f"dry-run {name} flops {got} != real {want}")
        if abs(traced_peak / peak - 1) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"dry-run {name} peak {traced_peak} against "
                                 f"max_memory_allocated {peak}")


# --------------------------------------------------------------- examples
def run_example(name: str, *args) -> str:
    """Run ``examples/<name>`` in this process as ``python <name> <args>``
    would (its launch counts land in this process's counters); returns
    what it printed.  A ``SystemExit`` with a message (a simulated crash)
    is returned as that message's last line."""
    import contextlib
    import io
    import runpy
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [name, *args]
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")
    except SystemExit as e:
        if not isinstance(e.code, str):
            raise
        out.write(e.code + "\n")
    finally:
        sys.argv = argv
    text = out.getvalue()
    print(text[-4000:], flush=True)
    return text


def example_losses(text: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+) loss\s+([-\d.]+)", text, re.MULTILINE)}


def examples_phase(counters) -> dict:
    """``examples/mixed_serving_torch.py`` as it runs by default (qwen2-0.5b
    at full size, bf16, beside the background-train lane): every request
    completes, the lane takes a step, K1, K2 and K1's backward are
    launched (counts set to 0 just before, read just after).  Then
    ``examples/train_100m_torch.py`` (demo-100m, float32) for 20 steps
    with checkpoints every 10: a crash after step 15 and a rerun, which
    resumes from step 10, give the losses of an uninterrupted run.
    Returns the launches by example."""
    import shutil
    by = {}
    for c in counters.values():
        c.reset()
    text = run_example("mixed_serving_torch.py")
    torch.cuda.synchronize()
    by["qwen2-0.5b mixed_serving_torch.py"] = launches = {
        n: c.count for n, c in counters.items()}
    done = re.search(r"completed (\d+)/(\d+) requests", text)
    steps = re.search(r"background train steps: (\d+)", text)
    log("examples.mixed_serving", arch="qwen2-0.5b", full_size=True,
        completed=done and done.group(0), background_train_steps=steps and
        int(steps.group(1)), launches=launches)
    if not (done and done.group(1) == done.group(2) == "8" and steps
            and int(steps.group(1)) >= 1 and all(
                launches[n] > 0 for n in ("flash_attention",
                                          "decode_attention",
                                          "flash_attention_bwd"))):
        raise AssertionError(f"mixed_serving_torch.py: {done}, {steps}, "
                             f"{launches}")
    free_device_memory()

    drill, whole = (ROOT / "build" / f"chip_smoke_ckpt_100m_{n}"
                    for n in ("drill", "whole"))
    for d in (drill, whole):
        shutil.rmtree(d, ignore_errors=True)
    common = ("--steps", "20", "--ckpt-every", "10", "--log-every", "1")
    for c in counters.values():
        c.reset()
    t0 = time.monotonic()
    crash = run_example("train_100m_torch.py", *common, "--ckpt-dir",
                        str(drill), "--fail-at", "15")
    resume = run_example("train_100m_torch.py", *common, "--ckpt-dir",
                         str(drill))
    torch.cuda.synchronize()
    by["demo-100m train_100m_torch.py"] = launches = {
        n: c.count for n, c in counters.items()}
    full = run_example("train_100m_torch.py", *common, "--ckpt-dir",
                       str(whole))
    want, before, after = (example_losses(t) for t in (full, crash, resume))
    ok = (sorted(want) == list(range(1, 21))
          and before == {s: want[s] for s in range(1, 16)}
          and after == {s: want[s] for s in range(11, 21)}
          and "simulated failure at step 15" in crash
          and "resumed from checkpoint step 10" in resume)
    log("examples.train_100m", arch="demo-100m", dtype="float32", steps=20,
        crash_after=15, resumed_from=10, losses_identical=ok,
        losses=want, seconds=time.monotonic() - t0, launches=launches)
    for d in (drill, whole):
        shutil.rmtree(d, ignore_errors=True)
    if not ok or not all(launches[n] > 0 for n in ("flash_attention",
                                                   "flash_attention_bwd")):
        raise AssertionError(f"train_100m_torch.py drill: {want}, {before}, "
                             f"{after}, {launches}")
    free_device_memory()
    return by


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    global RA, W
    from repro_torch import core
    from repro_torch.configs import get_arch
    from repro_torch.kernels import work as W
    from repro_torch.roofline import analysis as RA
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
    built = build.build(extra=(("flash_attention", kflash.WATCHDOG_FLAGS),
                               ("flash_attention_bwd", kflash.WATCHDOG_FLAGS),
                               ("mlstm_scan", kscan.WATCHDOG_FLAGS),
                               ("mlstm_scan_bwd", kscan.WATCHDOG_FLAGS),
                               ("decode_attention", kdecode.SPILL_FLAGS)))
    ptxas = {name: [ln.strip() for ln in log_.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, (_, _, log_) in built.items()}
    log("build", seconds=time.monotonic() - t0,
        per_source={n: s for n, (_, s, _) in built.items()}, ptxas=ptxas)
    seconds["build"] = time.monotonic() - t0
    check_scan_build(build, built)
    check_bwd_build(build, built)
    check_flash_build(build, built)
    check_decode_build(built)

    t0 = time.monotonic()
    timed = kernel_phase(ref, kflash, kdecode)
    done("kernels", t0)

    t0 = time.monotonic()
    timed["decode_attention"]["spill_build"] = k2_spill(ref, kdecode)
    done("kernels.k2_spill", t0)

    t0 = time.monotonic()
    k1_layouts = k1_layouts_phase(ref, kflash)
    done("kernels.k1_layouts", t0)
    # from here on no path may copy an input for K1's tensor maps
    kflash.tma_copies.reset()

    t0 = time.monotonic()
    timed["flash_attention_bwd"] = backward_phase(ref, kflash)
    free_device_memory()
    done("kernels.bwd", t0)

    t0 = time.monotonic()
    timed.update(router_scan_phase(ref, kmoe, kscan, capacity))
    timed["mlstm_scan"]["watchdog"] = k3_watchdog(ref, kscan)
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

    t0 = time.monotonic()
    dryrun_calls = dryrun_phase()
    free_device_memory()
    done("dryrun", t0, kernel_calls=dryrun_calls)

    t0 = time.monotonic()
    shardmap = distributed_phase(Model, get_arch, kflash)
    done("distributed", t0)

    t0 = time.monotonic()
    sharded = sharded_phase(ops, Model, trainer, optimizer, get_arch)
    free_device_memory()
    done("sharded", t0, total_seconds=time.monotonic() - t_start)

    # Serving, bfloat16, full width and depth (deepseek-v3-671b: its 3
    # dense layers and 2 of its 58 MoE layers, 53.2 GB, as the card's 80 GB
    # allow); each path's own kernels must run on it.  seamless-m4t-medium's
    # path runs at model level (prefill_batch over frames, then decode
    # steps), as the engine passes no frames.  The models with recurrent
    # heads and the two with stub frontends first print their bf16
    # prefill_batch logits, kernel path against plain path.
    counters = {"flash_attention": kflash.launches,
                "flash_attention_tma": kflash.tma_launches,
                "flash_attention_tma_copies": kflash.tma_copies,
                "flash_attention_bwd": kflash.bwd_launches,
                "decode_attention": kdecode.launches,
                "mlstm_scan": kscan.launches, "moe_topk": kmoe.launches}
    # K1's launches on a bf16 path are the TMA kernel's: both must count
    attn = ("flash_attention", "flash_attention_tma", "decode_attention")
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
             ("qwen2-0.5b", "qwen2-0.5b", {}, attn, False),
             ("granite-8b", "granite-8b", {}, attn, False),
             ("stablelm-3b", "stablelm-3b", {}, attn, False),
             ("deepseek-v3-671b", "deepseek-v3-671b", {"n_layers": 5},
              ("flash_attention", "flash_attention_tma", "moe_topk"), False)]
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
        if name == "llama3.2-1b":
            roofline_serving_phase(model, params)
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

    by_path["llama3.2-1b shardmap_attn (distributed)"] = shardmap
    by_path.update(sharded)
    t0 = time.monotonic()
    by_path.update(examples_phase(counters))
    done("examples", t0, total_seconds=time.monotonic() - t_start)

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
    # (hymba-1.5b's runs K1, K2 and K3; seamless-m4t-medium's,
    # internvl2-1b's, qwen2-0.5b's and granite-8b's K1 and K2;
    # deepseek-v3-671b's K1 at 192 / 128 and K4; the shardmap_attn prefill
    # K1; the two examples K1, K2 and K1's backward).
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
    # each kernel's launches on the sharded phase's DTensor path, under
    # ``local_map`` (none ran K1 at 192 / 128 sharded)
    local_map_path = {
        "flash_attention": "llama3.2-1b training (sharded)",
        "flash_attention_bwd": "llama3.2-1b training (sharded)",
        "decode_attention": "llama3.2-1b decode (sharded)",
        "mlstm_scan": "xlstm-350m training (sharded)",
        "mlstm_scan_bwd": "xlstm-350m training (sharded)",
        "moe_topk": "qwen2-moe-a2.7b training (sharded)",
        "moe_route_bwd": "qwen2-moe-a2.7b training (sharded)"}
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
    # K1's inputs copied for a tensor map, by path: none on any served,
    # training or sharded path (nor anywhere since the layouts' pass)
    copies = {p: c["flash_attention_tma_copies"] for p, c in by_path.items()
              if "flash_attention_tma_copies" in c}
    log("k1.copies", by_path=copies, since_layouts_pass=kflash.tma_copies.count,
        layouts_pass=k1_layouts["copies"])
    if any(copies.values()) or kflash.tma_copies.count:
        raise AssertionError(f"K1 copied inputs on a model path: {copies}, "
                             f"{kflash.tma_copies.count} in all")
    # K3's backward's likewise, on every training path
    scan_copies = {p: c["mlstm_scan_tma_copies"] for p, c in by_path.items()
                   if "mlstm_scan_tma_copies" in c}
    log("k3.copies", by_path=scan_copies, in_all=kscan.tma_copies.count)
    if any(scan_copies.values()) or kscan.tma_copies.count:
        raise AssertionError(f"K3's backward copied inputs on a model path: "
                             f"{scan_copies}, {kscan.tma_copies.count} in all")
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
            "launches_under_local_map": by_path[local_map_path[name]][name]
            if name in local_map_path else None,
            "launches_under_local_map_path": local_map_path.get(name),
            **({"tma_launches_by_path": {
                p: c["flash_attention_tma"] for p, c in by_path.items()
                if "flash_attention_tma" in c}, "tma_copies_by_path": copies,
                "watchdog": k1_layouts["watchdog"]}
               if name == "flash_attention" else {}),
            **extra, "card": card})
    # Each reference Pallas kernel beside the port's kernel that this run
    # launched on its path and held against its plain version (every parity
    # phase raises on a failure, so an entry of ``timed`` was held)
    ported = []
    for where, fn in pallas_functions():
        port = PORT_OF_PALLAS.get(fn)
        ported.append({
            "reference": f"{where} {fn}", "port": port,
            "launches": by_path[own[port]][port] if port in timed else 0,
            "max_abs_err": timed[port]["max_abs_err"] if port in timed
            else None})
    not_ported = [r["reference"] for r in ported
                  if not (r["launches"] and r["max_abs_err"] is not None)]
    log("ported", kernels=ported, not_ported=not_ported)
    if not ported:
        raise AssertionError("no reference function reaches pl.pallas_call")
    log("phase_seconds", total=time.monotonic() - t_start,
        build=seconds["build"], by_phase=seconds)
    print(json.dumps({"kernels": kernels, "not_ported": not_ported}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
