"""One run of one cell: weights from the seed, the engine, warm-up, the
measured window, the metrics, and the check of what the window served.

``run_cell`` takes the device as an argument so that the CPU tests can
drive a whole run at a tiny size; ``bench/run.py`` calls it on the card.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from dataclasses import dataclass

import torch

from . import check, discover, manifest as M, profiling, serve, stats, weights
from .traffic import Traffic

TS, BG = "time-sensitive", "background"


@dataclass
class Run:
    """What a metric reader reads."""
    cell: str
    model: dict                 # the configuration file (its model keys at the top)
    engine: dict                # its ``engine`` keys
    seconds: float
    setup_s: float
    window: serve.Window
    calls: list                 # the proxy's calls inside the window
    timeline: object = None     # profiling.Timeline (traced runs)
    sched_events: list = None   # the scheduler's trace (traced runs)

    def tier(self, name: str) -> list:
        return [r for r in self.window.records if r.tier == name]


def port_arch(cfg: dict):
    """The port's ``ArchConfig`` this configuration runs: the registered
    architecture with the file's replacements, checked against the file's
    model keys."""
    from repro_torch.configs import get_arch
    port = cfg["port"]
    arch = dataclasses.replace(get_arch(port["arch"]),
                               **port.get("replace", {}))
    for attr, key in port["check"].items():
        have, want = getattr(arch, attr), cfg[key]
        if not (have == want or (isinstance(want, float)
                                 and math.isclose(have, want, rel_tol=1e-9))):
            raise ValueError(f"the port's {attr} is {have}, the "
                             f"configuration's {key} is {want}")
    return arch


def reference_weights(model, params) -> dict:
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"],
            "layers": weights.per_layer(model, params)}


def run_cell(man: dict, root, cell_name: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", t_proc_start: float,
             cfg: dict | None = None, rates: dict | None = None,
             drain_s: float = 60.0, control: tuple = ()) -> dict:
    """One run.  ``cfg`` and ``rates`` replace the cell's configuration
    and load (the CPU tests' tiny sizes); ``control`` names reference
    variants (``"fp8"``, the control) read on the same sample: each one's
    first token at every served position and that token's gap."""
    from repro_torch.models.transformer import Model
    cell = M.cell(man, cell_name)
    cfg = cfg or discover.config(root, M.config_entry(man, cell["config"]))
    mix = discover.traffic(cell["traffic"])
    cp = discover.cell_params(cell_name)
    rates = rates or cp["rates"]
    arch = port_arch(cfg)
    model = Model(arch, device=device)
    meta = Model(arch, device="meta").init_params()
    params, nbytes = weights.make(meta, seed, device)
    model.adopt(params)
    cuda = device.startswith("cuda")
    server = serve.Server(model, params, cfg["engine"], trace_scheduler=trace)
    traffic = Traffic(mix, seed, arch.vocab_size, seconds, rates)
    profiler = []                # the started profiler, until stopped

    def stop_profiler():
        while profiler:
            profiler.pop().__exit__(None, None, None)
    prof = cal = None
    try:
        serve.warm(server, traffic.warmup())
        if cuda:
            torch.cuda.synchronize()
        if trace:
            prof = profiling.start_profiler()
            profiler.append(prof)
            cal = profiling.calibrate()
        n_calls = len(server.proxy.calls)
        setup_s = time.time() - t_proc_start
        w = serve.run_window(server, traffic, seconds, drain_s=drain_s,
                             on_close=stop_profiler)
    finally:
        stop_profiler()
        server.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    calls = [c for c in server.proxy.calls[n_calls:]
             if w.t_open <= c.t < w.t_close]
    timeline = sched = None
    if trace:
        def host_ns_at(m):
            return w.t_open_ns + int((m - w.t_open) * 1e9)
        timeline = profiling.read(prof, cal, server.proxy.calls, w.t_open,
                                  w.t_close, host_ns_at)
        sched = [e for e in server.kernel.tracer.events
                 if w.t_open <= e.t + server.clock_offset < w.t_close]
        prof = None
    run = Run(cell_name, cfg, cfg["engine"], seconds, setup_s, w,
              calls, timeline, sched)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for x in M.metrics_for(man, group, cell_name):
        if x["name"] == "setup_s":
            value = setup_s
        else:
            value = discover.metric_reader(x["name"])(run)
        if value is not None:
            metrics[x["name"]] = {"value": value, "unit": x["unit"]}

    # the check, with the engine's state freed
    t_check = time.time()
    due = [r for r in w.records if r.due < w.t_close]
    failed = sum(1 for r in due if not r.ok)
    server.engine.caches = None
    del server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rule = cp["check"]
    ref = discover.reference(cfg)
    recs = check.sample(w.records, seed, rule["min_tokens"],
                        rule["max_requests"])
    gaps = check.gaps(ref, cfg, reference_weights(model, params), recs)
    readings = check.numbers(gaps)
    control_readings = {
        q: check.numbers(check.gaps(ref, cfg, reference_weights(model, params),
                                    recs, quant=q))
        for q in control}
    checks = {name: {"value": readings.get(name), "limit": limit}
              for name, limit in rule["limits"].items()}
    checks.update({
        "never_finished": {"value": w.unfinished, "limit": 0},
        "failed": {"value": failed, "limit": 0},
        "served_tokens_compared": {"value": sum(len(p) for p in gaps),
                                   "limit": rule["min_tokens"]},
    })
    held = all(readings.get(n) is not None and readings[n] <= lim
               for n, lim in rule["limits"].items())
    correct = (held and w.unfinished == 0
               and failed == 0 and sum(len(p) for p in gaps)
               >= min(rule["min_tokens"],
                      sum(len(r.tokens) for r in w.records if r.ok)))
    ts = [r for r in due if r.tier == TS]
    load = {"ttft_s": [[r.due - w.t_open, t if math.isfinite(t) else None]
                       for r, t in zip(ts, stats.ttfts(ts))]}
    summary = (f"check {time.time() - t_check:.1f} s; "
               f"window: {len(ts)} time-sensitive due, "
               f"{sum(r.ok for r in ts)} finished; "
               f"{sum(1 for r in w.records if r.tier == BG and r.ok)} "
               f"background finished of {sum(r.tier == BG for r in w.records)}"
               f" sent; {w.decode_steps} decode steps; "
               f"{len(recs)} requests checked")
    out = {"correct": bool(correct), "attempted": len(due), "failed": failed,
           "summary": summary, "readings": readings,
           "control_readings": control_readings, "load": load,
           "metrics": metrics, "memory_peak_bytes": int(peak),
           "weights_bytes": nbytes, "checks": checks,
           "lateness": w.lateness, "timeline": timeline}
    return out
