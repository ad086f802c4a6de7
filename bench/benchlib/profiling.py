"""The traced run's device timeline, read from ``torch.profiler``'s raw
events (CUPTI on the card).

* every device operation (kernel, copy, set) with its start, end and
  correlation id, and every host launch call with its thread, time and
  correlation id;
* the host clock is tied to the profiler's by one ``synchronize()`` on
  this thread, timed on both (``calibrate``);
* a device operation belongs to the proxy call of the thread and time
  that launched it (``Proxy`` logs each call's native thread id and host
  interval), which splits device time by step kind;
* busy seconds: the union of the device operations inside the window;
  idle gaps: the stretches between them, each named by the proxy call
  open on the host when it began (or none: the engine, the scheduler or
  the host's own synchronisation between model calls).
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def start_profiler():
    """A started profiler: host launch calls of every thread (CUPTI) and
    device operations."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def calibrate() -> tuple:
    """(host ns before, host ns after, this thread's id) around one
    device synchronisation, found again in the trace by ``offset``."""
    t0 = time.time_ns()
    torch.cuda.synchronize()
    return t0, time.time_ns(), threading.get_native_id()


@dataclass
class Timeline:
    window_s: float
    busy_s: float
    kernel_s: dict                       # device seconds by operation name
    kind_s: dict                         # device seconds by proxy call kind
    gaps: list                           # (seconds, label), longest first
    notes: list = field(default_factory=list)


def _offset(cpu_events, cal) -> int | None:
    """The profiler's clock minus the host's: the synchronisation the
    calibration timed, found as the synchronize call nearest its host
    interval (the profiler's clock is wall-clock ns as well, so the offset
    is small; without such an event it is taken as 0)."""
    t0, t1, _ = cal
    mid_host = (t0 + t1) // 2
    best = None
    for e in cpu_events:
        if "ynchronize" not in e[0]:
            continue
        d = (e[1] + e[2]) // 2 - mid_host
        if abs(d) < 5_000_000 and (best is None or abs(d) < abs(best)):
            best = d
    return best


def read(prof, cal, calls, t_open: float, t_close: float,
         host_ns_at: callable, n_gaps: int = 10) -> Timeline:
    """Reduce a stopped profiler to a ``Timeline`` of the window
    [t_open, t_close) (host monotonic seconds; ``host_ns_at`` maps one to
    the wall-clock ns the calibration used).  ``calls``: the proxy's log."""
    evs = prof.profiler.kineto_results.events()
    dev, cpu = [], []
    from torch.autograd import DeviceType
    for e in evs:
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        else:
            cpu.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                        e.correlation_id()))
    off = _offset(cpu, cal)
    notes = []
    if off is None:
        notes.append("no calibration event: host and trace clocks assumed equal")
        off = 0
    w0, w1 = host_ns_at(t_open) + off, host_ns_at(t_close) + off

    # launches -> (thread, time) by correlation id
    launch = {}
    for name, s, _, tid, corr in cpu:
        if name in LAUNCHES:
            launch[corr] = (tid, s)
    # proxy calls in profiler time; a launch belongs to the call open on
    # the host when it was made (the one of its own thread where calls
    # overlap; the profiler's thread ids need not be the native ones, so
    # time decides first)
    open_calls = sorted((c.t0_ns + off, c.t1_ns + off, c.kind, c.tid)
                        for c in calls)
    call_starts = [x[0] for x in open_calls]

    def covering(t):
        i = bisect.bisect_right(call_starts, t)
        return [open_calls[j] for j in range(i - 1, max(-1, i - 33), -1)
                if open_calls[j][0] <= t <= open_calls[j][1]]

    def kind_of(corr):
        got = launch.get(corr)
        if got is None:
            return None
        tid, s = got
        cands = covering(s)
        if not cands:
            return None
        mine = [c for c in cands if c[3] == tid]
        return (mine or cands)[0][2]

    kernel_s = defaultdict(float)
    kind_s = defaultdict(float)
    spans = []
    for name, s, e, corr in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        dur = (e - s) / 1e9
        kernel_s[name] += dur
        kind_s[kind_of(corr) or "other"] += dur
        spans.append((s, e))
    spans.sort()
    busy, gaps = 0, []
    cur_s = cur_e = None
    edge = w0
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                edge = cur_e
            if s > edge:
                gaps.append((s - edge, edge))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        edge = cur_e
    if w1 > edge:
        gaps.append((w1 - edge, edge))
    gaps.sort(reverse=True)

    def label(t):
        cands = covering(t)
        if cands:
            return "host in " + cands[0][2]
        return "host between model calls (engine, scheduler, sync)"

    top = [(g / 1e9, label(at)) for g, at in gaps[:n_gaps]]
    return Timeline((w1 - w0) / 1e9, busy / 1e9, dict(kernel_s),
                    dict(kind_s), top, notes)
