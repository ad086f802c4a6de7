"""Fill EXPERIMENTS.md placeholders from results/dryrun.json + perf.json
(the port's dry-run, ``launch.dryrun``, and ``roofline.hillclimb``), as
the reference's ``roofline/fill_experiments.py`` does, priced on one H100
(``analysis``'s constants: bf16 peak, HBM, NVLink).  The markers are the
reference's; a missing EXPERIMENTS.md fails as it does there.

  PYTHONPATH=src python -m repro_torch.roofline.fill_experiments
"""
from __future__ import annotations

import json
import os
import re

import torch

from . import report as R
from . import analysis as RA
from ..configs.base import SHAPES, get_arch


def perf_table(path="results/perf.json") -> str:
    if not os.path.exists(path):
        return "(pending: run `python -m repro_torch.roofline.hillclimb`)\n"
    with open(path) as f:
        perf = json.load(f)
    lines = ["| cell | variant | compute | memory (analytic) | collective | "
             "args GB/dev | Δ dominant |",
             "|---|---|---|---|---|---|---|"]
    base: dict = {}
    for key, res in perf.items():
        if res.get("status") != "ok":
            lines.append(f"| {key} | — | ERROR {res.get('error','')[:60]} | | | | |")
            continue
        arch, shape_name, variant = key.split("|")
        cfg = get_arch(arch)
        shape = SHAPES[shape_name]
        n_dev = res["n_devices"]
        r = res["roofline"]
        attn = RA.attn_model_flops(cfg, shape, n_dev)
        t_c = (r["flops"] + attn) / RA.PEAK_FLOPS[torch.bfloat16]
        mem = RA.analytic_memory_bytes(cfg, shape,
                                       res["memory"]["argument_bytes"],
                                       res["memory"]["output_bytes"], n_dev)
        t_m = mem / RA.HBM_BW
        t_x = r["coll_bytes"] / RA.NVLINK_BW
        cell = f"{arch}×{shape_name}"
        dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
                  key=lambda kv: kv[1])
        delta = ""
        if variant == "baseline":
            base[cell] = dom
        elif cell in base:
            b = base[cell][1]
            delta = f"{(dom[1]-b)/b*100:+.0f}% vs baseline"
        lines.append(
            f"| {cell} | {variant} | {t_c*1e3:.2f} ms | {t_m*1e3:.1f} ms "
            f"| {t_x*1e3:.1f} ms | {res['memory']['argument_bytes']/2**30:.2f} "
            f"| {dom[0]} {dom[1]*1e3:.1f} ms {delta} |")
    return "\n".join(lines) + "\n"


def main() -> None:
    results = R.load("results/dryrun.json")
    if os.path.exists("results/dryrun_mp.json"):
        mp = R.load("results/dryrun_mp.json")
        results.update({k: v for k, v in mp.items() if k not in results
                        or results[k].get("status") != "ok"})
    rows = R.roofline_rows(results)
    table = R.markdown_table(rows)
    summary = R.dryrun_summary(results)

    notes = []
    worst = sorted(rows, key=lambda r: r["useful"])[:3]
    collb = [r for r in rows if r["bottleneck"] == "collective"]
    notes.append("**Bottleneck census (single-pod):** "
                 + ", ".join(f"{b}: {sum(1 for r in rows if r['bottleneck']==b)}"
                             for b in ("compute", "memory", "collective")) + ".")
    notes.append("**Lowest useful-FLOPs ratio:** "
                 + ", ".join(f"{r['arch']}×{r['shape']} ({r['useful']:.2f})"
                             for r in worst) + ".")
    if collb:
        top = max(collb, key=lambda r: r["t_collective_ms"])
        notes.append(f"**Most collective-bound:** {top['arch']}×{top['shape']} "
                     f"({top['t_collective_ms']:.0f} ms of collectives/step).")
    notes_md = "\n\n".join(notes) + "\n"

    def put(text, name, content):
        pat = re.compile(f"<!-- BEGIN:{name} -->.*?<!-- END:{name} -->", re.S)
        repl = f"<!-- BEGIN:{name} -->\n{content}\n<!-- END:{name} -->"
        if pat.search(text):
            return pat.sub(lambda _m: repl, text)
        return text.replace(f"<!-- {name} -->", repl)

    with open("EXPERIMENTS.md") as f:
        text = f.read()
    text = put(text, "DRYRUN-SUMMARY", summary)
    text = put(text, "ROOFLINE-TABLE", table)
    text = put(text, "ROOFLINE-NOTES", notes_md)
    text = put(text, "PERF-TABLE", perf_table())
    with open("EXPERIMENTS.md", "w") as f:
        f.write(text)
    print("EXPERIMENTS.md updated")


if __name__ == "__main__":
    main()
