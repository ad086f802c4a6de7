"""Scheduler tracing: structured lifecycle events from the core, and
timed spans of the program the core runs.

The userspace analogue of the paper's eBPF tracepoints (section 6.1
reconstructs per-CPU execution timelines from ``sched_switch`` events;
"Silentium!" argues DB/OS interference is only diagnosable at this event
granularity).  :class:`SchedTracer` is a bounded ring buffer the
:class:`~repro_torch.core.base.SchedCore` emits :class:`TraceEvent` records into
at every lifecycle edge -- wake, enqueue, dispatch, start/stop, preempt,
kick, boost/unboost, lock acquire/release with holder identity, slot
add/drain.  The schema is backend-agnostic: sim and live runs produce the
same event stream, timestamped by their respective clocks, so every
derived analysis below works identically on both.

Program spans (:func:`span`, kept as :class:`SpanRecord`) time what a
job does inside a chunk -- the engine's admission, decode step and host
sync, the model's layers -- in a second ring of the same tracer, on the
same clock as its events.  A span is kept only while the running thread has a tracer: the
live executor binds its kernel's tracer around each job chunk
(:func:`bind_thread`); on any other thread a span site enters one shared
no-op context.  :meth:`SchedTracer.to_wall_ns` maps an event's or a span's
time to wall-clock ns (``time.time_ns()``, the clock ``torch.profiler``
stamps host events with, up to an offset it can be calibrated by).

On top of the raw stream:

* :func:`to_chrome_trace` / :func:`write_chrome_trace` -- Chrome
  ``trace_event`` JSON (one track per slot, one per group, one per lock,
  one per host thread for spans; instant events for kicks and boosts),
  loadable at https://ui.perfetto.dev;
* :func:`busy_intervals` -- per-slot busy timelines, reproducing the
  paper's Figure 2 from the trace instead of charge-time accounting;
* :func:`detect_inversions` -- priority-inversion spans with boost
  resolution time (boost -> unboost per holder);
* :class:`TraceSummary` -- counters :class:`~repro_torch.core.build.KernelReport`
  embeds.
"""
from __future__ import annotations

import itertools
import json
import math
import threading
import time
from collections import Counter, defaultdict, deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import ContextManager, Iterable, NamedTuple, Optional

__all__ = [
    "EVENT_KINDS", "TraceEvent", "SchedTracer", "TraceSummary", "summarize",
    "Span", "SpanRecord", "span", "bind_thread", "thread_tracer",
    "busy_intervals", "detect_inversions", "to_chrome_trace",
    "write_chrome_trace", "validate_events", "validate_chrome_trace",
    "TraceSchemaError",
]

#: Every lifecycle edge the core emits.  Kept in one frozenset so schema
#: validation and tests cannot drift from the emitters.
EVENT_KINDS = frozenset({
    "wake",            # job became runnable (first cause of a dispatch chain)
    "enqueue",         # handed to the policy (args: requeue)
    "dispatch",        # slot pulled from the policy (local DSQ was empty)
    "start_job",       # job began running on a slot
    "stop_job",        # job left a slot (args: used, reason)
    "preempt_slot",    # running job forced off a slot
    "kick",            # slot kicked (args: preempt)
    "boost",           # hint boost: BG lock holder lifted into the TS tier
    "unboost",         # boost released (lock freed)
    "lock_wait",       # contended lock (args: lock, lock_id, holder identity)
    "lock_acquire",    # lock granted (args: lock, lock_id)
    "lock_release",    # lock released
    "slot_add",        # elastic scale-up
    "slot_drain",      # slot taken offline
    "lock_timeout",    # acquire gave up waiting (args: lock, lock_id)
    "panic",           # job faulted (args: reason, error, traceback, retries)
    "retry",           # panic path restarting the job (args: attempt, delay)
    "quarantine",      # retries exhausted: job poisoned to EXITED
    "park",            # idle worker parked on its per-slot event (live only)
    "unpark",          # parked worker woken (args: waited)
})

DEFAULT_CAPACITY = 1 << 16


class TraceSchemaError(ValueError):
    """An event stream or exported trace violates the schema."""


@dataclass(frozen=True, slots=True)
class TraceEvent:
    """One structured scheduler event.  ``slot``/``jid`` are -1 when the
    event is not slot- or job-scoped; ``args`` holds kind-specific fields
    (used, reason, lock, preempt, ...)."""

    t: float
    kind: str
    slot: int = -1
    jid: int = -1
    job: str = ""
    group: str = ""
    jkind: str = ""
    args: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {"t": self.t, "kind": self.kind}
        if self.slot >= 0:
            d["slot"] = self.slot
        if self.jid >= 0:
            d.update(jid=self.jid, job=self.job, group=self.group,
                     jkind=self.jkind)
        if self.args:
            d["args"] = dict(self.args)
        return d


class _ThreadState(threading.local):
    """The calling thread's tracer, its open spans and its native id (set
    by :func:`bind_thread`); class defaults for threads never bound."""
    tracer: Optional["SchedTracer"] = None
    stack: tuple = ()
    tid: int = 0


_thread = _ThreadState()


class SpanRecord(NamedTuple):
    """One kept span: a timed stretch of the program on one host thread.
    ``t0`` / ``t1`` on the tracer's clock (seconds), ``sid`` its id in the
    tracer, ``parent`` the id of the span open around it on its thread
    (-1: none), ``tid`` the native id of that thread, ``args`` e.g.
    ``rid`` / ``rids`` and ``jid``.  ``detached`` spans were recorded after
    the fact (:meth:`SchedTracer.record_span`), outside their thread's
    nesting.  A tuple: one of atomic values costs the garbage collector
    nothing once it has been seen."""
    name: str
    t0: float
    t1: float
    sid: int
    parent: int
    tid: int
    args: Optional[dict] = None
    detached: bool = False


class Span:
    """An open span of a :func:`span` site, its own context manager:
    entering stamps ``t0`` and pushes it on the thread's stack, leaving
    pops it and keeps its :class:`SpanRecord` in the tracer's span ring."""

    __slots__ = ("name", "t0", "sid", "parent", "tid", "args", "_tracer")

    def __init__(self, name: str, sid: int, tid: int,
                 args: Optional[dict], tracer: "SchedTracer"):
        self.name = name
        self.t0 = 0.0
        self.sid = sid
        self.parent = -1
        self.tid = tid
        self.args = args
        self._tracer = tracer

    def set(self, key: str, value) -> None:
        """Add an argument known only once the span is open."""
        if self.args is None:
            self.args = {}
        self.args[key] = value

    def __enter__(self) -> "Span":
        stack = _thread.stack
        if stack:
            self.parent = stack[-1].sid
        stack.append(self)
        self.t0 = time.monotonic() - self._tracer.anchor_mono
        return self

    def __exit__(self, et, ev, tb) -> bool:
        tr = self._tracer
        t1 = time.monotonic() - tr.anchor_mono
        _thread.stack.pop()
        tr._keep_span(SpanRecord(self.name, self.t0, t1, self.sid,
                                 self.parent, self.tid, self.args))
        return False


class _NoSpan:
    """The one context every span site enters on a thread with no tracer:
    nothing is allocated, timed or kept."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, et, ev, tb) -> bool:
        return False


_NO_SPAN = _NoSpan()


def span(name: str, key: Optional[str] = None, value=None):
    """A span named ``name`` (with one argument ``key=value``, if given)
    on the calling thread's tracer, as a context manager whose ``as`` is
    the :class:`Span` -- or, on a thread with no tracer, the shared no-op
    context, whose ``as`` is None.  Arguments known only later go through
    ``Span.set`` behind an ``is not None`` test, so an untraced site
    builds nothing."""
    tr = _thread.tracer
    if tr is None:
        return _NO_SPAN
    return Span(name, next(tr._span_ids), _thread.tid,
                None if key is None else {key: value}, tr)


def bind_thread(tracer: Optional["SchedTracer"]) -> Optional["SchedTracer"]:
    """Make ``tracer`` the calling thread's (None: no tracer), with an
    empty span stack; returns the tracer the thread had."""
    prev = _thread.tracer
    _thread.tracer = tracer
    _thread.stack = []
    _thread.tid = threading.get_native_id()
    return prev


def thread_tracer() -> Optional["SchedTracer"]:
    """The calling thread's tracer, or None."""
    return _thread.tracer


class SchedTracer:
    """Bounded ring buffer of :class:`TraceEvent`, and a second one, of
    the same capacity, of :class:`SpanRecord`.

    Backend-agnostic: the emitter passes the timestamp explicitly (virtual
    clock in sim, monotonic in live).  Appends are guarded by a mutex so
    live-mode paths that emit outside the core guard (``LiveLock``) stay
    consistent; when a ring wraps, its oldest records are dropped and
    counted in :attr:`dropped` / :attr:`spans_dropped`.

    ``kinds`` optionally restricts retention of events to a subset of
    :data:`EVENT_KINDS` (e.g. only ``start_job``/``stop_job`` for long
    busy-timeline captures); spans are kept whatever ``kinds`` says.

    The clock's anchor: ``anchor_mono`` is the ``time.monotonic()``
    reading at the clock's zero and ``anchor_ns`` the ``time.time_ns()``
    read beside it.  The tracer's own creation until a live kernel sets
    its executor's zero (:meth:`set_anchor`); spans are timed on it.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 kinds: Optional[Iterable[str]] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.kinds = frozenset(kinds) if kinds is not None else None
        if self.kinds is not None and not self.kinds <= EVENT_KINDS:
            raise ValueError(f"unknown kinds {sorted(self.kinds - EVENT_KINDS)}")
        self._events: deque = deque(maxlen=capacity)
        self._emitted = 0
        self._spans: deque = deque(maxlen=capacity)
        self._spans_kept = 0
        self._span_ids = itertools.count()
        self._mu: ContextManager = threading.Lock()
        self.set_anchor(time.monotonic(), time.time_ns())

    def set_anchor(self, mono: float, wall_ns: int) -> None:
        """The clock's zero: ``time.monotonic()`` there, and the
        ``time.time_ns()`` read beside it."""
        self.anchor_mono = mono
        self.anchor_ns = wall_ns

    def to_wall_ns(self, t: float) -> int:
        """Wall-clock ns (``time.time_ns()``'s clock) of time ``t`` of a
        live run's event or span on this tracer's clock."""
        return self.anchor_ns + round(t * 1e9)

    def set_threadsafe(self, threadsafe: bool) -> None:
        """Swap the append mutex for a no-op guard (or back).

        The sim backend is a single-threaded event loop, so the core calls
        ``set_threadsafe(False)`` at attach time and every emit skips the
        lock; live mode keeps the real mutex because ``LiveLock`` paths
        emit outside the core guard."""
        self._mu = threading.Lock() if threadsafe else nullcontext()

    # ------------------------------------------------------------------
    def emit(self, kind: str, t: float, slot: Optional[int] = None,
             job=None, **args) -> None:
        """Record one event.  ``job`` is any Job-like object (``jid``,
        ``name``, ``kind``, ``group.name``); extra keywords become
        ``args``."""
        if self.kinds is not None and kind not in self.kinds:
            return
        ev = TraceEvent(
            t=t, kind=kind,
            slot=slot if slot is not None else -1,
            jid=job.jid if job is not None else -1,
            job=job.name if job is not None else "",
            group=job.group.name if job is not None else "",
            jkind=job.kind if job is not None else "",
            args=args or None,
        )
        with self._mu:
            self._emitted += 1
            self._events.append(ev)

    def record_span(self, name: str, since: float,
                    args: Optional[dict] = None) -> SpanRecord:
        """Keep a detached span that began at ``since`` (a
        ``time.monotonic()`` reading, possibly on another thread) and ends
        now, on the calling thread: a wait that started before any traced
        code could time it (a request queued from its submission)."""
        now = time.monotonic()
        sp = SpanRecord(name, since - self.anchor_mono,
                        now - self.anchor_mono, next(self._span_ids), -1,
                        threading.get_native_id(), args, True)
        self._keep_span(sp)
        return sp

    def _keep_span(self, sp: SpanRecord) -> None:
        with self._mu:
            self._spans_kept += 1
            self._spans.append(sp)

    # ------------------------------------------------------------------
    @property
    def events(self) -> list:
        with self._mu:
            return list(self._events)

    @property
    def emitted(self) -> int:
        return self._emitted

    @property
    def dropped(self) -> int:
        with self._mu:
            return self._emitted - len(self._events)

    @property
    def spans(self) -> list:
        """The kept spans, in the order they ended."""
        with self._mu:
            return list(self._spans)

    @property
    def spans_dropped(self) -> int:
        with self._mu:
            return self._spans_kept - len(self._spans)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        with self._mu:
            self._events.clear()
            self._emitted = 0
            self._spans.clear()
            self._spans_kept = 0

    def summary(self) -> "TraceSummary":
        with self._mu:
            evs = list(self._events)
            dropped = self._emitted - len(evs)
            n_spans = len(self._spans)
            spans_dropped = self._spans_kept - n_spans
        s = summarize(evs, dropped=dropped)
        s.spans, s.spans_dropped = n_spans, spans_dropped
        return s


# ---------------------------------------------------------------------------
# Summary
# ---------------------------------------------------------------------------

@dataclass
class TraceSummary:
    """Counters over an event stream, and the spans kept beside it -- the
    unit :class:`~repro_torch.core.build.KernelReport` embeds."""

    events: int = 0
    dropped: int = 0
    t0: float = 0.0
    t1: float = 0.0
    counts: dict = field(default_factory=dict)        # kind -> n
    inversions: int = 0                               # boost spans seen
    inversions_resolved: int = 0                      # ... that unboosted
    max_boost_resolution: float = 0.0                 # slowest inversion fix
    spans: int = 0                                    # program spans kept
    spans_dropped: int = 0                            # ... and lost to the ring

    def to_dict(self) -> dict:
        return {
            "events": self.events, "dropped": self.dropped,
            "span": [self.t0, self.t1],
            "counts": {k: self.counts[k] for k in sorted(self.counts)},
            "inversions": self.inversions,
            "inversions_resolved": self.inversions_resolved,
            "max_boost_resolution": self.max_boost_resolution,
            "spans": self.spans, "spans_dropped": self.spans_dropped,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)


def summarize(events: list, dropped: int = 0) -> TraceSummary:
    counts = Counter(ev.kind for ev in events)
    inv = detect_inversions(events)
    resolved = [i for i in inv if i["resolution"] is not None]
    return TraceSummary(
        events=len(events), dropped=dropped,
        t0=events[0].t if events else 0.0,
        t1=events[-1].t if events else 0.0,
        counts=dict(counts),
        inversions=len(inv),
        inversions_resolved=len(resolved),
        max_boost_resolution=max((i["resolution"] for i in resolved),
                                 default=0.0),
    )


# ---------------------------------------------------------------------------
# Derived analyses
# ---------------------------------------------------------------------------

def busy_intervals(events: list, end: Optional[float] = None) -> dict:
    """Per-slot execution timeline: ``{slot: [interval, ...]}`` where each
    interval is ``{"start", "stop", "jid", "job", "group", "jkind",
    "reason"}`` -- the Figure-2 reconstruction, built from
    ``start_job``/``stop_job`` pairs exactly as the paper rebuilds per-CPU
    timelines from ``sched_switch``.  A job still running at the end of the
    stream is closed at ``end`` (when given), mirroring the kernel's
    horizon settlement."""
    out: dict = defaultdict(list)
    open_: dict = {}
    for ev in events:
        if ev.kind == "start_job":
            open_[ev.slot] = ev
        elif ev.kind == "stop_job":
            started = open_.pop(ev.slot, None)
            if started is not None:
                out[ev.slot].append({
                    "start": started.t, "stop": ev.t,
                    "jid": ev.jid, "job": ev.job, "group": ev.group,
                    "jkind": ev.jkind,
                    "reason": (ev.args or {}).get("reason", ""),
                })
    if end is not None:
        for slot, started in open_.items():
            out[slot].append({
                "start": started.t, "stop": max(end, started.t),
                "jid": started.jid, "job": started.job,
                "group": started.group, "jkind": started.jkind,
                "reason": "open",
            })
    return dict(out)


def detect_inversions(events: list) -> list:
    """Priority-inversion spans: each hint boost of a background lock
    holder, paired with its unboost.  ``resolution`` is the boost->unboost
    time (how long the inversion took to resolve once detected); None for
    spans still open at the end of the stream."""
    open_: dict = {}
    out = []
    for ev in events:
        if ev.kind == "boost":
            open_[ev.jid] = ev
        elif ev.kind == "unboost":
            b = open_.pop(ev.jid, None)
            if b is not None:
                out.append({
                    "jid": ev.jid, "job": ev.job, "group": b.group,
                    "boost_group": (b.args or {}).get("boost_group", ""),
                    "t_boost": b.t, "t_unboost": ev.t,
                    "resolution": ev.t - b.t,
                })
    for b in open_.values():
        out.append({
            "jid": b.jid, "job": b.job, "group": b.group,
            "boost_group": (b.args or {}).get("boost_group", ""),
            "t_boost": b.t, "t_unboost": None, "resolution": None,
        })
    out.sort(key=lambda i: i["t_boost"])
    return out


# ---------------------------------------------------------------------------
# Chrome trace_event export
# ---------------------------------------------------------------------------

PID_SLOTS, PID_GROUPS, PID_LOCKS, PID_THREADS, PID_REQUESTS = 1, 2, 3, 4, 5


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def to_chrome_trace(events: list, end: Optional[float] = None,
                    spans: Iterable[SpanRecord] = ()) -> dict:
    """Export to the Chrome ``trace_event`` JSON object format (loadable in
    Perfetto / chrome://tracing).

    Layout: process "slots" has one thread per slot carrying complete
    ("X") events per job run plus instant events for kicks and preempts;
    process "groups" has one thread per workload group carrying the same
    runs grouped by owner plus instant wake/boost/unboost events; process
    "locks" has one thread per lock with held spans named by holder.
    Given ``spans`` (on the events' clock), process "host threads" has one
    thread per host thread carrying its nested spans, and process
    "requests" one per request id carrying the detached spans."""
    te: list = []
    slots_seen: list = []
    groups_seen: list = []

    def group_tid(name: str) -> int:
        if name not in groups_seen:
            groups_seen.append(name)
        return groups_seen.index(name)

    def meta(pid: int, name: str) -> None:
        te.append({"ph": "M", "pid": pid, "tid": 0, "ts": 0,
                   "name": "process_name", "args": {"name": name}})

    meta(PID_SLOTS, "slots")
    meta(PID_GROUPS, "groups")
    meta(PID_LOCKS, "locks")

    # --- run spans: slot tracks and group tracks -----------------------
    for slot, ivs in sorted(busy_intervals(events, end=end).items()):
        if slot not in slots_seen:
            slots_seen.append(slot)
        for iv in ivs:
            common = {
                "name": iv["job"], "cat": iv["jkind"] or "job", "ph": "X",
                "ts": _us(iv["start"]),
                "dur": max(0.0, _us(iv["stop"]) - _us(iv["start"])),
                "args": {"jid": iv["jid"], "group": iv["group"],
                         "reason": iv["reason"], "slot": slot},
            }
            te.append(dict(common, pid=PID_SLOTS, tid=slot))
            te.append(dict(common, pid=PID_GROUPS, tid=group_tid(iv["group"])))

    # --- instant events and lock spans ---------------------------------
    open_locks: dict = {}
    for ev in events:
        a = ev.args or {}
        if ev.kind in ("kick", "preempt_slot", "park", "unpark"):
            te.append({"name": ev.kind, "ph": "i", "s": "t",
                       "pid": PID_SLOTS, "tid": ev.slot, "ts": _us(ev.t),
                       "args": {k: v for k, v in a.items()}})
            if ev.slot not in slots_seen:
                slots_seen.append(ev.slot)
        elif ev.kind in ("wake", "boost", "unboost",
                         "panic", "retry", "quarantine"):
            te.append({"name": ev.kind, "ph": "i", "s": "t",
                       "pid": PID_GROUPS, "tid": group_tid(ev.group),
                       "ts": _us(ev.t), "args": dict(a, job=ev.job)})
        elif ev.kind == "lock_acquire":
            open_locks[a.get("lock_id", -1)] = ev
        elif ev.kind == "lock_release":
            got = open_locks.pop(a.get("lock_id", -1), None)
            if got is not None:
                ga = got.args or {}
                te.append({
                    "name": f"{ga.get('lock', 'lock')}:{got.job}",
                    "cat": "lock", "ph": "X", "pid": PID_LOCKS,
                    "tid": ga.get("lock_id", 0), "ts": _us(got.t),
                    "dur": max(0.0, _us(ev.t) - _us(got.t)),
                    "args": {"holder": got.job, "holder_jid": got.jid},
                })
        elif ev.kind == "lock_wait":
            te.append({"name": f"wait:{a.get('lock', 'lock')}", "ph": "i",
                       "s": "t", "pid": PID_LOCKS,
                       "tid": a.get("lock_id", 0), "ts": _us(ev.t),
                       "args": {"waiter": ev.job,
                                "holder": a.get("holder", "")}})
        elif ev.kind == "lock_timeout":
            te.append({"name": f"timeout:{a.get('lock', 'lock')}", "ph": "i",
                       "s": "t", "pid": PID_LOCKS,
                       "tid": a.get("lock_id", 0), "ts": _us(ev.t),
                       "args": {"waiter": ev.job}})

    for sid in sorted(slots_seen):
        te.append({"ph": "M", "pid": PID_SLOTS, "tid": sid, "ts": 0,
                   "name": "thread_name", "args": {"name": f"slot{sid}"}})
    for gname in groups_seen:
        te.append({"ph": "M", "pid": PID_GROUPS, "tid": groups_seen.index(gname),
                   "ts": 0, "name": "thread_name", "args": {"name": gname}})

    # --- program spans: one track per host thread, one per request ------
    tracks: dict = {}
    for sp in spans:
        a = dict(sp.args or {}, sid=sp.sid, parent=sp.parent)
        if sp.detached:
            track = (PID_REQUESTS, int(a.get("rid", 0)))
            label = f"request {track[1]}"
        else:
            track = (PID_THREADS, sp.tid)
            label = f"thread {sp.tid}"
        tracks[track] = label
        te.append({"name": sp.name, "cat": "span", "ph": "X",
                   "pid": track[0], "tid": track[1], "ts": _us(sp.t0),
                   "dur": max(0.0, _us(sp.t1) - _us(sp.t0)), "args": a})
    if tracks:
        meta(PID_THREADS, "host threads")
        meta(PID_REQUESTS, "requests")
    for (pid, tid), label in sorted(tracks.items()):
        te.append({"ph": "M", "pid": pid, "tid": tid, "ts": 0,
                   "name": "thread_name", "args": {"name": label}})

    return {"displayTimeUnit": "ms", "traceEvents": te,
            "otherData": {"schema": "repro.core.trace/v1",
                          "n_source_events": len(events)}}


def write_chrome_trace(events: list, path: str,
                       end: Optional[float] = None,
                       spans: Iterable[SpanRecord] = ()) -> int:
    """Validate and write a Chrome trace export (with ``spans``, see
    :func:`to_chrome_trace`); returns the number of trace_event records
    written.  Output bytes are deterministic for a deterministic event
    stream (sorted keys, fixed float formatting)."""
    doc = to_chrome_trace(events, end=end, spans=spans)
    n = validate_chrome_trace(doc)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
    return n


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------

def validate_events(events: list, balanced: bool = True) -> dict:
    """Check the event stream against the schema; raises
    :class:`TraceSchemaError` on violation, returns per-kind counts.

    Invariants: known kinds, finite non-negative timestamps, every
    ``start_job`` on a slot closed by a ``stop_job`` before the next start
    on that slot (``balanced=False`` tolerates a trailing open run, e.g. a
    truncated ring), and prefix-balanced boost/unboost per job."""
    counts: Counter = Counter()
    running: dict = {}
    boosted: Counter = Counter()
    for i, ev in enumerate(events):
        if ev.kind not in EVENT_KINDS:
            raise TraceSchemaError(f"event {i}: unknown kind {ev.kind!r}")
        if not math.isfinite(ev.t) or ev.t < 0.0:
            raise TraceSchemaError(f"event {i}: bad timestamp {ev.t!r}")
        counts[ev.kind] += 1
        if ev.kind == "start_job":
            if ev.slot < 0 or ev.jid < 0:
                raise TraceSchemaError(f"event {i}: start_job without slot/jid")
            if ev.slot in running:
                raise TraceSchemaError(
                    f"event {i}: start_job on slot {ev.slot} while "
                    f"{running[ev.slot].job!r} still running")
            running[ev.slot] = ev
        elif ev.kind == "stop_job":
            started = running.pop(ev.slot, None)
            if started is None:
                raise TraceSchemaError(
                    f"event {i}: stop_job on idle slot {ev.slot}")
            if started.jid != ev.jid:
                raise TraceSchemaError(
                    f"event {i}: stop_job jid {ev.jid} != started {started.jid}")
        elif ev.kind == "boost":
            boosted[ev.jid] += 1
        elif ev.kind == "unboost":
            boosted[ev.jid] -= 1
            if boosted[ev.jid] < 0:
                raise TraceSchemaError(
                    f"event {i}: unboost of job {ev.jid} without boost")
    if balanced and running:
        raise TraceSchemaError(
            f"unbalanced trace: slots {sorted(running)} still running at end")
    return dict(counts)


_CHROME_PHASES = {"X", "i", "M"}


def validate_chrome_trace(doc: dict) -> int:
    """Structural validation of a Chrome trace_event export; raises
    :class:`TraceSchemaError`, returns the record count."""
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        raise TraceSchemaError("export must be an object with 'traceEvents'")
    evs = doc["traceEvents"]
    if not evs:
        raise TraceSchemaError("empty traceEvents")
    for i, ev in enumerate(evs):
        for key in ("name", "ph", "pid", "tid", "ts"):
            if key not in ev:
                raise TraceSchemaError(f"record {i}: missing {key!r}")
        if ev["ph"] not in _CHROME_PHASES:
            raise TraceSchemaError(f"record {i}: unknown phase {ev['ph']!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise TraceSchemaError(f"record {i}: bad ts {ev['ts']!r}")
        if ev["ph"] == "X" and not (isinstance(ev.get("dur"), (int, float))
                                    and ev["dur"] >= 0):
            raise TraceSchemaError(f"record {i}: X event needs dur >= 0")
        if ev["ph"] == "i" and ev.get("s") not in ("t", "p", "g"):
            raise TraceSchemaError(f"record {i}: instant event needs scope")
        if ev["ph"] == "M" and "name" not in (ev.get("args") or {}):
            raise TraceSchemaError(f"record {i}: metadata event needs args.name")
    return len(evs)
