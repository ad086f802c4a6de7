#!/usr/bin/env python3
"""Readings that set a cell's limit: for each seed, one short window of
the cell's own traffic and load, then on the same sample of served
requests the program's widest logit gap (the lower reading) and the
control's (the plain reference computed in fp8, its first token at each
served position; the upper reading).  One process for every seed, so the
kernels are built once.  Not run by the benchmark's own runs.

    python3 bench/control.py --workload <cell> --seconds 20 --seeds 1 2 3
        [--rates R ...]     # a sweep of time-sensitive rates instead
        [--no-control]      # the program's readings alone

Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rates", type=float, nargs="+", default=[None],
                    help="time-sensitive rates to sweep (default the cell's)")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import run as bench_run
    bench_run.set_caches()
    from benchlib import discover, manifest as M
    from benchlib.cellrun import run_cell
    man = M.load(ROOT / "BENCHMARK.json")
    cell = M.cell(man, args.workload)
    cfg = discover.config(ROOT, M.config_entry(man, cell["config"]))
    for rate, seed in [(r, s) for r in args.rates for s in args.seeds]:
        t0 = time.time()
        out = run_cell(man, ROOT, args.workload, seed, args.seconds, False,
                       t_proc_start=t0, cfg=cfg,
                       rates=None if rate is None else {"time-sensitive": rate},
                       control=(() if args.no_control
                                else ("fp8",)))
        print(json.dumps({
            "seed": seed, "rate": rate, "ttft_s": out["load"]["ttft_s"],
            "correct": out["correct"],
            "program": out["readings"],
            "control": out["control_readings"],
            "served_tokens_compared":
                out["checks"]["served_tokens_compared"]["value"],
            "summary": out["summary"], "wall_s": time.time() - t0,
            "metrics": {k: v["value"] for k, v in out["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
