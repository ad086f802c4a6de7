#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of
one cell, as ``BENCHMARK.json`` names it.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for.  Makes the configuration's weights on the device from the
seed, builds the UFS live kernel and the serving engine, warms the cell's
shapes, offers the cell's traffic for ``--seconds``, then checks a sample
of what the window served against the plain reference.  Prints, as its
last line, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; the numbers
compared, each with its limit, come last there and as the last lines of
standard error.  Exits 2 without a result when no CUDA device (or too few)
is present, or when the JAX package or JAX is loaded.
"""
from __future__ import annotations

import time

_T_MONO = time.monotonic()

import argparse  # noqa: E402
import json      # noqa: E402
import os        # noqa: E402
import sys       # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """Wall-clock time this process started (Linux ``/proc``), or the
    moment this module was first run where ``/proc`` is not there."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - (time.monotonic() - _T_MONO)


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own libraries under ``build/kernels``)."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the benchmark must not load:
    JAX, its relatives, and the JAX package ``repro`` (compared whole, so
    ``repro_torch`` is not it)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    set_caches()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    from benchlib import manifest as M
    from benchlib.serve import log
    man = M.load(ROOT / "BENCHMARK.json")
    M.validate(man)
    cell = M.cell(man, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"no result: {cell['chips']} CUDA device(s) wanted, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " present")
        return 2
    from benchlib.cellrun import run_cell
    out = run_cell(man, ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_proc_start=t_start)
    bad = forbidden_loaded()
    if bad:
        log(f"no result: the run loaded {', '.join(bad)}")
        return 2

    log(out["summary"])
    lat = out["lateness"]
    log(f"generator lateness: {len(lat)} open-loop sends, "
        f"max {max(lat, default=0.0) * 1e3:.3f} ms, "
        f"mean {sum(lat) / max(1, len(lat)) * 1e3:.3f} ms")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    tl = out["timeline"]
    if tl is not None:
        device["busy_s"] = tl.busy_s
        device["window_s"] = tl.window_s
        top = sorted(tl.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                               "idle_gaps": [[label, s] for s, label in
                                             tl.gaps]}
        for note in tl.notes:
            log("trace:", note)
    checks = {k: v for k, v in out["checks"].items()}
    result["checks"] = checks
    for name, c in checks.items():
        rel = ">=" if name == "served_tokens_compared" else "<="
        log(f"check {name} {c['value']} limit {rel} {c['limit']}")
    print(json.dumps(result, allow_nan=False,
                     default=lambda v: None), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
