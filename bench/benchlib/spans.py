"""Readings of the program's spans (``repro_torch.core.trace``) in a traced
window, alone and against the device's timeline: how long a decode chunk
takes, and what the host was doing while the device sat idle inside a
decode step.

What they read from a run.  ``cellrun.Run`` and ``profiling.Timeline``
do not carry these; ``traced_window`` (``bench/attribution.py``) sets them on
the run it makes:

* ``run.spans`` -- the program's span records that start inside the
  window (``SpanRecord``: name, t0, t1 on the tracer's clock in seconds,
  sid, parent, native thread id, args, detached);
* ``run.span_ns`` -- a time on the tracer's clock to the profiler's
  clock, in ns: the tracer's ``to_wall_ns``, then the profiler's clock
  minus the host's at that time (``clock_points``, ``to_profiler``);
* ``run.timeline.device_ops`` -- (start, end) ns of every device
  operation inside the window, on the profiler's clock, sorted;
* ``run.timeline.host_calls`` -- (start, end, name, thread) of every
  host event the profiler saw (the runtime calls by CUPTI), on its
  clock, sorted; the thread is the event's ``device_resource_id``;
* ``run.timeline.offset_ns`` -- the clock points ``span_ns`` was made
  from: (host ns, the profiler's clock minus the host's);
* ``run.timeline.window_ns`` -- the window's (open, close) on the
  profiler's clock: only steps wholly inside it are read (the profiler
  records nothing past the close, and a step cut there would read idle).

A host call belongs to a span by its thread and time, as
``profiling.read`` gives a device operation to a proxy call.  The
profiler's thread ids are not the native ones the spans carry, so each
native thread with spans is matched to the profiler thread that made
most calls inside its spans alone (``thread_map``).
"""
from __future__ import annotations

import bisect
import heapq
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from . import profiling, stats

STEP = "engine.decode"
CHUNK = "engine.decode_chunk"
SYNC = "engine.sync"
# the step's own time and its model call's: every other span below a step
# names where the host was
STEP_OWN = (STEP, "model.decode_step")


def is_sync(name: str) -> bool:
    """A runtime call that waits for the device: any ``*Synchronize``,
    and the blocking ``cudaMemcpy``."""
    return "Synchronize" in name or name == "cudaMemcpy"


def chunk_ms(run) -> list:
    """Durations (ms) of the window's decode chunks that merged a step."""
    return [(s.t1 - s.t0) * 1e3 for s in getattr(run, "spans", None) or ()
            if s.name == CHUNK and (s.args or {}).get("outcome") == "merged"]


def chunk_p95_ms(run):
    xs = chunk_ms(run)
    return stats.percentile(xs, 95) if xs else None


def clock_points(marks, host_calls, within_ns: int = 5_000_000,
                 longest_ns: int = 200_000) -> list:
    """(host ns, profiler minus host ns) at each of ``marks``: a runtime
    call the host timed from outside, ``(t0, t1, name)`` in
    ``time.time_ns()``, found as the call of that name the profiler
    recorded nearest to it (within ``within_ns`` of where the last point
    puts it).  A mark timed over more than ``longest_ns`` places nothing:
    it held a pause of the host, or a wait whose host interval and
    recorded interval need not share a midpoint (``profiling.calibrate``'s
    device synchronisation read the offset 0.6-0.7 ms off on the card's
    host, where short marks agree within 0.05 ms over a window)."""
    mids = defaultdict(list)
    for t0, t1, name, _ in host_calls:
        mids[name].append((t0 + t1) // 2)
    for ms in mids.values():
        ms.sort()
    points, guess = [], 0
    for t0, t1, name in sorted(marks):
        if t1 - t0 > longest_ns:
            continue
        ms = mids.get(name, [])
        host = (t0 + t1) // 2
        i = bisect.bisect_left(ms, host + guess)
        near = [m for m in ms[max(0, i - 1):i + 1]
                if abs(m - host - guess) <= within_ns]
        if near:
            best = min(near, key=lambda m: abs(m - host - guess))
            guess = best - host
            points.append((host, guess))
    return points


def to_profiler(points):
    """Host wall ns -> the profiler's clock: the offset interpolated
    between the nearest two ``clock_points`` (held at the ends)."""
    hosts = [h for h, _ in points]

    def f(wall: int) -> int:
        if not points:
            return wall
        i = bisect.bisect_left(hosts, wall)
        if i == 0:
            return wall + points[0][1]
        if i == len(points):
            return wall + points[-1][1]
        (h0, o0), (h1, o1) = points[i - 1], points[i]
        return wall + o0 + round((o1 - o0) * (wall - h0) / (h1 - h0))
    return f


def _merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _covers(union, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def thread_map(spans, host_calls, to_ns, votes_wanted: int = 100_000) -> dict:
    """Profiler thread id -> native thread id: each native thread that
    has spans takes the profiler thread with most calls inside its spans
    (top-level, on the profiler's clock) and no other thread's; about
    ``votes_wanted`` calls, evenly spaced, vote.  A thread that makes
    calls and no spans (one that only times the clocks) is matched to
    none."""
    outer = defaultdict(list)
    for s in spans:
        if not s.detached and s.parent == -1:
            outer[s.tid].append((to_ns(s.t0), to_ns(s.t1)))
    unions = {tid: _merge(iv) for tid, iv in outer.items()}
    starts = {tid: [a for a, _ in u] for tid, u in unions.items()}
    votes = defaultdict(Counter)
    every = max(1, len(host_calls) // votes_wanted)
    for t0, _, _, ptid in host_calls[::every]:
        held = [tid for tid, u in unions.items()
                if _covers(u, starts[tid], t0)]
        if len(held) == 1:
            votes[ptid][held[0]] += 1
    best: dict = {}
    for ptid, c in votes.items():
        for tid, n in c.items():
            if n > best.get(tid, (0, None))[0]:
                best[tid] = (n, ptid)
    return {ptid: tid for tid, (_, ptid) in best.items()}


class _Innermost:
    """The innermost span open on one thread at any time: the thread's
    spans cut into stretches, each with the deepest span open over it."""

    def __init__(self, spans, to_ns):
        bounds = []
        for s in spans:
            a, b = to_ns(s.t0), to_ns(s.t1)
            # at one instant: closes before opens, the inner span closing
            # first and the outer one opening first
            bounds.append((a, 1, -b, s))
            bounds.append((b, 0, -a, s))
        bounds.sort(key=lambda x: x[:3])
        self.starts, self.spans = [], []
        stack: list = []
        for t, opening, _, s in bounds:
            if opening:
                stack.append(s)
            else:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] is s:
                        del stack[i]
                        break
            self.starts.append(t)
            self.spans.append(stack[-1] if stack else None)

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.spans[i] if i >= 0 else None


@dataclass
class StepView:
    """The window's decode steps against the device and the host calls."""
    steps: list                      # (start ns, end ns, SpanRecord)
    step_ns: int = 0                 # summed step time
    idle_ns: int = 0                 # ... with no device operation
    idle_by_span: dict = field(default_factory=dict)   # innermost name -> ns
    gaps: list = field(default_factory=list)           # longest idle stretches
    launches: int = 0
    syncs: int = 0
    sync_inside: int = 0             # steps whose last sync lies in engine.sync
    sync_distance_ns: list = field(default_factory=list)  # (start, end) offsets
    sync_outside: list = field(default_factory=list)   # (ns out, step start)
    tids: dict = field(default_factory=dict)           # profiler -> native


def step_view(run, n_gaps: int = 10):
    """The decode steps of a traced run against its device timeline
    (worked out once a run), or None when the run has no spans or no
    device timeline."""
    cached = getattr(run, "_step_view", None)
    if cached is not None:
        return cached
    spans = getattr(run, "spans", None)
    tl = run.timeline
    if not spans or tl is None or getattr(tl, "device_ops", None) is None:
        return None
    to_ns = run.span_ns
    calls = tl.host_calls
    tids = thread_map(spans, calls, to_ns)
    by_thread = defaultdict(list)
    for c in calls:
        tid = tids.get(c[3])
        if tid is not None:
            by_thread[tid].append(c)
    call_starts = {tid: [c[0] for c in cs] for tid, cs in by_thread.items()}
    thread_spans = defaultdict(list)
    for s in spans:
        if not s.detached:
            thread_spans[s.tid].append(s)
    inner = {tid: _Innermost(ss, to_ns) for tid, ss in thread_spans.items()}
    syncs_of = {s.parent: s for s in spans if s.name == SYNC}
    busy = _merge(tl.device_ops)
    busy_starts = [a for a, _ in busy]

    w0, w1 = tl.window_ns
    view = StepView(sorted((to_ns(s.t0), to_ns(s.t1), s) for s in spans
                           if s.name == STEP
                           and w0 <= to_ns(s.t0) and to_ns(s.t1) <= w1),
                    tids=tids)
    idle_by = Counter()
    longest: list = []
    for a, b, s in view.steps:
        view.step_ns += b - a
        # host calls on the step's own thread
        cs = by_thread.get(s.tid, [])
        st = call_starts.get(s.tid, [])
        mine = cs[bisect.bisect_left(st, a):bisect.bisect_right(st, b)]
        view.launches += sum(1 for c in mine if c[2] in profiling.LAUNCHES)
        waits = [c for c in mine if is_sync(c[2])]
        view.syncs += len(waits)
        sync = syncs_of.get(s.sid)
        if sync is not None and waits:
            lo, hi = to_ns(sync.t0), to_ns(sync.t1)
            last = waits[-1]
            out = max(0, lo - last[0], last[1] - hi)
            view.sync_distance_ns.append((last[0] - lo, last[1] - hi))
            if out:
                view.sync_outside.append((out, a))
            view.sync_inside += out == 0
        # idle stretches inside the step, by the span open when each began
        i = max(0, bisect.bisect_right(busy_starts, a) - 1)
        edge = a
        while i < len(busy) and busy[i][0] < b:
            x, y = busy[i]
            if x > edge:
                _idle(view, idle_by, longest, inner[s.tid], mine, edge, x,
                      n_gaps)
            edge = max(edge, y)
            i += 1
        if edge < b:
            _idle(view, idle_by, longest, inner[s.tid], mine, edge, b, n_gaps)
    view.idle_by_span = dict(idle_by)
    view.gaps = sorted(longest, reverse=True)
    run._step_view = view
    return view


def _idle(view, idle_by, longest, inner, calls, a, b, n_gaps) -> None:
    dur = b - a
    view.idle_ns += dur
    sp = inner.at(a)
    idle_by[sp.name if sp is not None else "(none)"] += dur
    item = (dur, a, b, sp, calls)         # (dur, a) tell any two apart
    if len(longest) < n_gaps:
        heapq.heappush(longest, item)
    elif dur > longest[0][0]:
        heapq.heapreplace(longest, item)


def gap_lines(view) -> list:
    """One line for each of the longest idle stretches: its length, the
    innermost span open when it began (with its arguments) and the host's
    runtime calls inside it."""
    lines = []
    for dur, a, b, sp, calls in view.gaps:
        inside = Counter(c[2] for c in calls if a <= c[0] < b)
        what = (f"{sp.name} {dict(sp.args)}" if sp is not None and sp.args
                else (sp.name if sp is not None else "(none)"))
        made = ", ".join(f"{n} x{k}" for n, k in inside.most_common()) \
            or "no runtime call"
        lines.append(f"{dur / 1e6:.3f} ms in {what}: {made}")
    return lines


def idle_pct(run):
    v = step_view(run)
    if v is None or not v.step_ns:
        return None
    return v.idle_ns / v.step_ns * 100.0


def launches_per_step(run):
    v = step_view(run)
    return v.launches / len(v.steps) if v is not None and v.steps else None


def syncs_per_step(run):
    v = step_view(run)
    return v.syncs / len(v.steps) if v is not None and v.steps else None
