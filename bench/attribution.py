#!/usr/bin/env python3
"""Where the decode steps' idle device time goes: one traced window of a
cell, read through the program's spans against the profiler's timeline.
Not run by the benchmark's own runs, whose ``cellrun.Run`` and
``profiling.Timeline`` do not carry the spans or the device's intervals;
this window is run the way ``cellrun.run_cell`` runs a traced one (the
same server, warm-up, traffic, profiler and calibration), without the
check of what it served.

    python3 bench/attribution.py --workload <cell> --seed <n> --seconds 51
        [--site-cost]    # first, ns a span site costs on this host

Standard error: the decode steps' idle device time summed by the
innermost span open when each idle stretch began (top 10); the 10
longest idle stretches inside decode steps, each with that span and the
runtime calls made inside it; how far the argmax's synchronisation lies
from its ``engine.sync`` span.  Standard output, last: one JSON line
with the span metrics (``bench/metrics/decode_*``), the manifest's
per-layer metrics on the same window, and those readings.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPAN_METRICS = ("decode_chunk_p95_ms", "decode_step_idle_pct",
                "decode_launches_per_step", "decode_syncs_per_step")


def device_view(prof, marks, w0_host: int, w1_host: int):
    """(device operations in the window, host calls, clock points,
    window) on the profiler's clock: its raw events as ``profiling.read``
    takes them, kept whole, and the profiler's clock against the host's
    at each of ``marks`` (``spans.clock_points``).  A host event's thread
    is its ``device_resource_id``, the thread that made it (its
    ``start_thread_id`` is the profiler's own numbering, that of the
    operator that launched it where one was recorded)."""
    from torch.autograd import DeviceType

    from benchlib import spans
    dev, calls = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.end_ns()))
        else:
            calls.append((e.start_ns(), e.end_ns(), e.name(),
                          e.device_resource_id()))
    calls.sort()
    points = spans.clock_points(marks, calls)
    to_prof = spans.to_profiler(points)
    w0, w1 = to_prof(w0_host), to_prof(w1_host)
    ops = sorted((max(s, w0), min(e, w1)) for s, e in dev
                 if min(e, w1) > max(s, w0))
    return ops, calls, points, (w0, w1)


def clock_marks(marks: list, stop: threading.Event,
                every_s: float = 0.1) -> None:
    """Until ``stop``, every ``every_s``: one ``cudaStreamQuery`` (it
    waits for nothing), timed on the host's wall clock, for
    ``clock_points`` to find in the profiler's record."""
    import torch
    stream = torch.cuda.current_stream()
    while not stop.wait(every_s):
        t0 = time.time_ns()
        stream.query()
        marks.append((t0, time.time_ns(), "cudaStreamQuery"))


def traced_window(man, root, cell_name: str, seed: int, seconds: float, *,
                  device: str = "cuda", cfg=None, rates=None,
                  drain_s: float = 60.0):
    """One traced window of ``cell_name``; returns a ``cellrun.Run`` with
    ``spans``, ``span_ns`` and ``collections`` (the interpreter's garbage
    collections in the window: generation, start, end on the tracer's
    clock) set, its timeline (on a card) with ``device_ops``,
    ``host_calls``, ``offset_ns`` and ``window_ns``, and the tracer.  On
    the CPU no profiler runs and the timeline is None.

    The profiler's clock is calibrated against the host's at the open, as
    ``cellrun.run_cell`` does, at the close, and every 0.1 s between them
    (``clock_marks``); ``span_ns`` interpolates the offset between those
    points (``offset_ns``), and ``profiling.read``'s timeline keeps its
    own single offset, taken at the open."""
    import torch
    from repro_torch.models.transformer import Model

    from benchlib import cellrun, discover, manifest as M, profiling, serve
    from benchlib import spans, weights
    from benchlib.traffic import Traffic
    cell = M.cell(man, cell_name)
    cfg = cfg or discover.config(root, M.config_entry(man, cell["config"]))
    arch = cellrun.port_arch(cfg)
    model = Model(arch, device=device)
    params, _ = weights.make(Model(arch, device="meta").init_params(), seed,
                             device)
    model.adopt(params)
    cuda = device.startswith("cuda")
    server = serve.Server(model, params, cfg["engine"], trace_scheduler=True)
    traffic = Traffic(discover.traffic(cell["traffic"]), seed,
                      arch.vocab_size, seconds,
                      rates or discover.cell_params(cell_name)["rates"])
    profiler, cals, marks, collections = [], [], [], []
    stop_marks = threading.Event()

    def stop_profiler():
        stop_marks.set()
        if profiler:
            cals.append(profiling.calibrate())
        while profiler:
            profiler.pop().__exit__(None, None, None)

    def collected(phase, info):
        collections.append((phase, info["generation"], time.monotonic()))
    prof = None
    try:
        serve.warm(server, traffic.warmup())
        if cuda:
            torch.cuda.synchronize()
            prof = profiling.start_profiler()
            profiler.append(prof)
            cals.append(profiling.calibrate())
            threading.Thread(target=clock_marks, args=(marks, stop_marks),
                             daemon=True, name="bench-clock").start()
        n_calls = len(server.proxy.calls)
        gc.callbacks.append(collected)
        w = serve.run_window(server, traffic, seconds, drain_s=drain_s,
                             on_close=stop_profiler)
    finally:
        if collected in gc.callbacks:
            gc.callbacks.remove(collected)
        stop_profiler()
        server.stop()
    tracer = server.kernel.tracer
    calls = [c for c in server.proxy.calls[n_calls:]
             if w.t_open <= c.t < w.t_close]
    sched = [e for e in tracer.events
             if w.t_open <= e.t + server.clock_offset < w.t_close]
    timeline, points = None, []
    if cuda:
        def host_ns_at(m):
            return w.t_open_ns + int((m - w.t_open) * 1e9)
        timeline = profiling.read(prof, cals[0], server.proxy.calls,
                                  w.t_open, w.t_close, host_ns_at)
        marks += [(t0, t1, "cudaDeviceSynchronize") for t0, t1, _ in cals]
        ops, host_calls, points, window = device_view(
            prof, marks, host_ns_at(w.t_open), host_ns_at(w.t_close))
        timeline.device_ops, timeline.host_calls = ops, host_calls
        timeline.offset_ns, timeline.window_ns = points, window
    to_prof = spans.to_profiler(points)
    run = cellrun.Run(cell_name, cfg, cfg["engine"], seconds, 0.0, w, calls,
                      timeline, sched)
    run.spans = [s for s in tracer.spans
                 if w.t_open <= tracer.anchor_mono + s.t0 < w.t_close]
    run.span_ns = lambda t: to_prof(tracer.to_wall_ns(t))
    starts = {}
    run.collections = []
    for phase, gen, t in collections:
        if phase == "start":
            starts[gen] = t
        elif gen in starts:
            run.collections.append((gen, starts.pop(gen) - tracer.anchor_mono,
                                    t - tracer.anchor_mono))
    return run, tracer


def site_cost(n: int = 200_000) -> dict:
    """ns a span site costs on this host: the loop around an empty
    ``with`` taken off, with no tracer bound and with one."""
    from repro_torch.core.trace import SchedTracer, bind_thread, span

    def per_site(body):
        t = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t) / n

    def empty():
        for i in range(n):
            pass

    def bare():
        for i in range(n):
            with span("model.layer"):
                pass

    def with_arg():
        for i in range(n):
            with span("model.layer", "index", i):
                pass
    base = min(per_site(empty) for _ in range(3))
    out = {"untraced_ns": min(per_site(bare) for _ in range(3)) - base,
           "untraced_arg_ns": min(per_site(with_arg) for _ in range(3))
           - base}
    prev = bind_thread(SchedTracer(capacity=n))
    try:
        out["traced_ns"] = min(per_site(bare) for _ in range(3)) - base
        out["traced_arg_ns"] = min(per_site(with_arg) for _ in range(3)) - base
    finally:
        bind_thread(prev)
    return out


def report(run, tracer, metric_names) -> dict:
    """The readings of one traced window: the metrics ``metric_names``
    and the span metrics, and, where the run has a device timeline, the
    attribution of the decode steps' idle time, logged as it goes."""
    from benchlib import discover, spans
    from benchlib.serve import log
    out = {"spans": {"window": len(run.spans), "kept": len(tracer.spans),
                     "dropped": tracer.spans_dropped}}
    metrics = {n: discover.metric_reader(n)(run)
               for n in list(metric_names) + list(SPAN_METRICS)}
    out["metrics"] = metrics
    v = spans.step_view(run)
    if v is not None and v.steps:
        tl = run.timeline
        for note in tl.notes:
            log("trace:", note)
        w = run.window
        log("the tracer's anchor against the window's own reading of the "
            "wall clock at its open (ns): "
            f"{tracer.to_wall_ns(w.t_open - tracer.anchor_mono) - w.t_open_ns}"
            f"; the profiler's clock minus the host's (ns) at "
            f"{len(tl.offset_ns)} points: "
            f"{min((o for _, o in tl.offset_ns), default=None)} to "
            f"{max((o for _, o in tl.offset_ns), default=None)}, first "
            f"{tl.offset_ns[:1]}, last {tl.offset_ns[-1:]}")
        log(f"host calls by thread: {dict(Counter(c[3] for c in tl.host_calls))}"
            f"; spans by thread: {dict(Counter(s.tid for s in run.spans))}"
            f"; profiler threads -> span threads {v.tids}")
        total = max(1, v.idle_ns)
        by = sorted(v.idle_by_span.items(), key=lambda kv: -kv[1])
        log(f"decode steps {len(v.steps)}: {v.step_ns / 1e9:.3f} s, idle "
            f"{v.idle_ns / 1e9:.3f} s")
        log("idle time in decode steps by the innermost span open when "
            "each stretch began:")
        for name, ns in by[:10]:
            log(f"  {name}: {ns / 1e6:.3f} ms ({ns / total * 100:.2f}%)")
        log("longest idle stretches in decode steps, and the garbage "
            "collections over them:")
        cols = [(run.span_ns(t0), run.span_ns(t1), gen)
                for gen, t0, t1 in getattr(run, "collections", ())]
        gaps = spans.gap_lines(v)
        for line, (_, a, b, _, _) in zip(gaps, v.gaps):
            over = [f"gen {g} {(y - x) / 1e6:.3f} ms" for x, y, g in cols
                    if x < b and y > a]
            log("  " + line + (f"; collection: {', '.join(over)}"
                               if over else ""))
        by_gen = Counter()
        for x, y, g in cols:
            by_gen[g] += y - x
        log("garbage collections in the window (ms by generation): "
            f"{ {g: ns / 1e6 for g, ns in sorted(by_gen.items())} }")
        d = v.sync_distance_ns
        if d:
            picks = [d[int(q * (len(d) - 1))] for q in
                     (0, .1, .2, .3, .4, .5, .6, .7, .8, .9, 1)]
            log("argmax sync start - engine.sync start, end - end (ns), at "
                "0, 10, ..., 100% of the window's steps: "
                + "; ".join(f"{a} / {b}" for a, b in picks))
        outside = max((n for n, _ in v.sync_outside), default=0)
        log(f"argmax sync inside engine.sync in {v.sync_inside} of "
            f"{len(v.steps)} steps; farthest outside {outside} ns; the "
            "farthest (ns outside, s after the first step): "
            + ", ".join(f"{n} at {(a - v.steps[0][0]) / 1e9:.3f}"
                        for n, a in sorted(v.sync_outside, reverse=True)[:10]))
        covered = 1.0 - sum(v.idle_by_span.get(n, 0)
                            for n in spans.STEP_OWN) / total
        log(f"spans below engine.decode hold {covered * 100:.2f}% of its "
            "idle time")
        out["attribution"] = {
            "steps": len(v.steps), "step_s": v.step_ns / 1e9,
            "idle_s": v.idle_ns / 1e9,
            "idle_ms_by_span": {n: ns / 1e6 for n, ns in by},
            "covered_pct": covered * 100, "sync_inside": v.sync_inside,
            "sync_outside_max_ns": outside, "gaps": gaps}
    for name, value in metrics.items():
        log(f"metric {name} {value}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--site-cost", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import run as bench_run
    bench_run.set_caches()
    import torch

    from benchlib import manifest as M
    from benchlib.serve import log
    if not torch.cuda.is_available():
        log("no result: no CUDA device")
        return 2
    out = {"device": torch.cuda.get_device_name(0)}
    if args.site_cost:
        out["site_cost"] = site_cost()
        log("span site ns:", out["site_cost"])
    man = M.load(ROOT / "BENCHMARK.json")
    t0 = time.time()
    run, tracer = traced_window(man, ROOT, args.workload, args.seed,
                                args.seconds)
    out["wall_s"] = time.time() - t0
    out.update(report(run, tracer,
                      [x["name"] for x in
                       M.metrics_for(man, "per_layer", args.workload)]))
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
