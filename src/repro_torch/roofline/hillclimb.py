"""Performance hillclimbing driver (EXPERIMENTS.md section Perf).

Re-traces the three selected (arch x shape) cells with candidate changes
(the port's dry-run, ``launch.dryrun.run_cell``) and records before/after
roofline terms into results/perf.json. Each entry in PLAN is one
hypothesis -> change -> measure iteration, the reference's PLAN verbatim;
the narrative (napkin math, confirmed/refuted) lives in EXPERIMENTS.md.

  PYTHONPATH=src python -m repro_torch.roofline.hillclimb [--only <cell>] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

PLAN = [
    # cell 1: worst useful-FLOPs fraction / serving hot path (memory-bound)
    ("stablelm-3b", "decode_32k", "baseline", {}),
    ("stablelm-3b", "decode_32k", "kv_int8", {"kv_quant": True}),
    ("stablelm-3b", "decode_32k", "kv_int8_local",
     {"kv_quant": True, "kv_local_update": True}),
    # cell 2: most collective-bound
    ("granite-8b", "prefill_32k", "baseline", {}),
    ("granite-8b", "prefill_32k", "act_dp", {"act_spec": ("data", None, None)}),
    ("granite-8b", "prefill_32k", "act_seqshard",
     {"act_spec": ("data", "model", None)}),
    ("granite-8b", "prefill_32k", "act_hidden",
     {"act_spec": ("data", None, "model")}),
    ("granite-8b", "prefill_32k", "attn_layout",
     {"attn_layout": True, "act_spec": ("data", None, None)}),
    ("granite-8b", "prefill_32k", "shardmap_attn",
     {"shardmap_attn": True, "act_spec": ("data", None, None)}),
    ("granite-8b", "train_4k", "baseline", {}),
    ("granite-8b", "train_4k", "shardmap_attn",
     {"shardmap_attn": True, "act_spec": ("data", None, None)}),
    # cell 3: the paper-representative large-scale mixed-deployment trainer
    # (MoE). qwen2-moe is the tractable-compile proxy for the EP lever; the
    # deepseek variants reuse the same code path at 61L/256e scale.
    ("qwen2-moe-a2.7b", "train_4k", "baseline", {}),
    ("qwen2-moe-a2.7b", "train_4k", "ep", {"ep": True}),
    ("qwen2-moe-a2.7b", "train_4k", "act_dp",
     {"act_spec": ("data", None, None)}),
    ("deepseek-v3-671b", "train_4k", "baseline", {}),
    ("deepseek-v3-671b", "train_4k", "ep", {"ep": True}),
]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--out", default="results/perf.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernel path, shapes alone; cpu: the "
                         "plain versions")
    args = ap.parse_args()

    from ..launch.dryrun import run_cell

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    for arch, shape, name, variant in PLAN:
        key = f"{arch}|{shape}|{name}"
        if args.only and args.only not in key:
            continue
        if results.get(key, {}).get("status") == "ok":
            print(f"[skip] {key}")
            continue
        print(f"[perf] {key} ...", flush=True)
        t0 = time.time()
        try:
            res = run_cell(arch, shape, multi_pod=False, unroll=True,
                           variant=variant, device=args.device)
            res["variant"] = name
            r = res["roofline"]
            print(f"  ok in {time.time()-t0:.0f}s compute={r['t_compute']*1e3:.2f}ms "
                  f"coll={r['t_collective']*1e3:.1f}ms "
                  f"args={res['memory']['argument_bytes']/2**30:.2f}GB", flush=True)
        except Exception as e:  # noqa: BLE001
            res = {"status": "error", "variant": name,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-1500:]}
            print(f"  ERROR {e}", flush=True)
        results[key] = res
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
