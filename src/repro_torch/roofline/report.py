"""Roofline tables from a dry-run's results (``results/dryrun.json``).

Recomputes the analytic model flops uniformly (``analysis.model_flops``)
so the useful-flops ratio stays comparable across cells, and prices each
cell on one H100 (``analysis``'s constants: bf16 peak, HBM, NVLink).  The
results dict has the reference package's layout, as the port's dry-run
(``launch.dryrun``) writes it; its ``compile_s`` column reads the trace's
``trace_s`` there (the reference's compile seconds where a record has
them).

  PYTHONPATH=src python -m repro_torch.roofline.report [results/dryrun.json]
"""
from __future__ import annotations

import json
import sys

import torch

from ..configs.base import SHAPES, get_arch
from . import analysis as RA


def load(path: str = "results/dryrun.json") -> dict:
    with open(path) as f:
        return json.load(f)


def roofline_rows(results: dict, mesh: str = "16x16") -> list:
    peak = RA.PEAK_FLOPS[torch.bfloat16]
    rows = []
    for key, res in sorted(results.items()):
        if res.get("status") != "ok" or res.get("mesh") != mesh:
            continue
        cfg = get_arch(res["arch"])
        shape = SHAPES[res["shape"]]
        r = res["roofline"]
        n_dev = res["n_devices"]
        mflops = RA.model_flops(cfg, shape, res["n_params"], n_dev)
        # Adjusted compute: a blocked attention (and chunked SSM scans) is
        # costed once by the counter of dispatched operations; add the
        # analytic attention/state flops they actually perform.
        attn = RA.attn_model_flops(cfg, shape, n_dev)
        flops_adj = r["flops"] + attn
        coll_bytes = r["coll_bytes"]
        est = False
        if res["arch"] == "deepseek-v3-671b" and not res.get("unrolled"):
            # scanned cell: a scanned segment's body is costed once, so
            # scale per-layer flops/collectives by the mean scanned-segment
            # depth and mark the row estimated.
            from ..models.transformer import build_plan
            scans = [s.n for s in build_plan(cfg) if s.kind == "scan"]
            factor = sum(scans) / max(len(scans), 1)
            flops_adj = r["flops"] * factor + attn
            coll_bytes = r["coll_bytes"] * factor
            est = True
        mem_an = RA.analytic_memory_bytes(
            cfg, shape, res["memory"]["argument_bytes"],
            res["memory"]["output_bytes"], n_dev)
        t_c = flops_adj / peak
        t_m = mem_an / RA.HBM_BW
        t_x = coll_bytes / RA.NVLINK_BW
        terms = {"compute": t_c, "memory": t_m, "collective": t_x}
        bottleneck = max(terms, key=terms.get)
        roof_t = max(terms.values())
        rows.append({
            "arch": res["arch"] + (" †" if est else ""),
            "shape": res["shape"], "kind": res["kind"],
            "t_compute_ms": t_c * 1e3,
            "t_memory_ms": t_m * 1e3,
            "t_collective_ms": t_x * 1e3,
            "t_memory_hlo_ms": r["hbm_bytes"] / RA.HBM_BW * 1e3,
            "bottleneck": bottleneck,
            "useful": mflops / flops_adj if flops_adj else 0.0,
            "mfu_bound": (mflops / peak) / roof_t if roof_t else 0.0,
            "peak_gb": res["memory"]["peak_bytes"] / 2**30,
            "arg_gb": res["memory"]["argument_bytes"] / 2**30,
            "compile_s": res.get("trace_s", res.get("compile_s", 0)),
            "coll_detail": r.get("coll_detail", {}),
            "coll_counts": r.get("coll_counts", {}),
            "model_flops": mflops, "flops_adj": flops_adj,
        })
    return rows


def markdown_table(rows: list) -> str:
    hdr = ("| arch | shape | compute | memory | collective | bottleneck | "
           "useful | MFU-bound | args GB/dev | peak GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_ms']:.2f} ms "
            f"| {r['t_memory_ms']:.1f} ms | {r['t_collective_ms']:.1f} ms "
            f"| **{r['bottleneck']}** | {r['useful']:.2f} "
            f"| {r['mfu_bound']*100:.1f}% | {r['arg_gb']:.2f} "
            f"| {r['peak_gb']:.2f} |\n")
    return "".join(out)


def dryrun_summary(results: dict) -> str:
    by_mesh = {}
    for key, res in results.items():
        by_mesh.setdefault(res.get("mesh", "?"), []).append(res)
    lines = []
    for mesh, cells in sorted(by_mesh.items()):
        ok = [c for c in cells if c.get("status") == "ok"]
        err = [c for c in cells if c.get("status") != "ok"]
        lines.append(f"* mesh **{mesh}**: {len(ok)}/{len(cells)} cells "
                     f"lower+compile OK")
        for c in err:
            lines.append(f"    * FAIL {c['arch']}|{c['shape']}: {c.get('error')}")
    return "\n".join(lines)


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.json"
    results = load(path)
    print(dryrun_summary(results))
    print()
    rows = roofline_rows(results)
    print(markdown_table(rows))


if __name__ == "__main__":
    main()
