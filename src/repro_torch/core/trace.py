"""Scheduler tracing: structured lifecycle events from the core.

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

On top of the raw stream:

* :func:`to_chrome_trace` / :func:`write_chrome_trace` -- Chrome
  ``trace_event`` JSON (one track per slot, one per group, one per lock;
  instant events for kicks and boosts), loadable at https://ui.perfetto.dev;
* :func:`busy_intervals` / :func:`slot_busy_from_trace` -- per-slot busy
  timelines, reproducing the paper's Figure 2 from the trace instead of
  charge-time accounting (cross-checked against ``Metrics`` in
  tests/test_trace.py);
* :func:`wakeup_delays` -- wakeup-latency breakdown per group;
* :func:`detect_inversions` -- priority-inversion spans with boost
  resolution time (boost -> unboost per holder);
* :class:`TraceSummary` -- counters the parity benchmark diffs across
  backends (benchmarks/parity.py).

``python -m repro_torch.core.trace --out trace.json`` runs a small mixed
workload in simulation, validates the exported trace against the schema,
and writes it -- CI uploads this file as a workflow artifact.
"""
from __future__ import annotations

import json
import math
import threading
from collections import Counter, defaultdict, deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import ContextManager, Iterable, Optional

__all__ = [
    "EVENT_KINDS", "TraceEvent", "SchedTracer", "TraceSummary", "summarize",
    "busy_intervals", "slot_busy_from_trace", "wakeup_delays",
    "detect_inversions", "to_chrome_trace", "write_chrome_trace",
    "validate_events", "validate_chrome_trace", "TraceSchemaError",
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


class SchedTracer:
    """Bounded ring buffer of :class:`TraceEvent`.

    Backend-agnostic: the emitter passes the timestamp explicitly (virtual
    clock in sim, monotonic in live).  Appends are guarded by a mutex so
    live-mode paths that emit outside the core guard (``LiveLock``) stay
    consistent; when the ring wraps, the oldest events are dropped and
    counted in :attr:`dropped`.

    ``kinds`` optionally restricts retention to a subset of
    :data:`EVENT_KINDS` (e.g. only ``start_job``/``stop_job`` for long
    busy-timeline captures).
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
        self._mu: ContextManager = threading.Lock()

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

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        with self._mu:
            self._events.clear()
            self._emitted = 0

    def summary(self) -> "TraceSummary":
        with self._mu:
            evs = list(self._events)
            dropped = self._emitted - len(evs)
        return summarize(evs, dropped=dropped)


# ---------------------------------------------------------------------------
# Summary
# ---------------------------------------------------------------------------

@dataclass
class TraceSummary:
    """Counters over an event stream -- the unit the parity benchmark diffs
    across backends and :class:`~repro_torch.core.build.KernelReport` embeds."""

    events: int = 0
    dropped: int = 0
    t0: float = 0.0
    t1: float = 0.0
    counts: dict = field(default_factory=dict)        # kind -> n
    inversions: int = 0                               # boost spans seen
    inversions_resolved: int = 0                      # ... that unboosted
    max_boost_resolution: float = 0.0                 # slowest inversion fix

    def counters(self) -> dict:
        out = {k: self.counts.get(k, 0) for k in sorted(EVENT_KINDS)}
        out.update(events=self.events, dropped=self.dropped,
                   inversions=self.inversions,
                   inversions_resolved=self.inversions_resolved)
        return out

    def to_dict(self) -> dict:
        return {
            "events": self.events, "dropped": self.dropped,
            "span": [self.t0, self.t1],
            "counts": {k: self.counts[k] for k in sorted(self.counts)},
            "inversions": self.inversions,
            "inversions_resolved": self.inversions_resolved,
            "max_boost_resolution": self.max_boost_resolution,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    def diff(self, other: "TraceSummary") -> dict:
        """Presence diff against another backend's summary: kinds one stream
        has and the other lacks.  Absolute counts are never comparable
        across clocks, presence must be (the parity invariant)."""
        mine, theirs = self.counters(), other.counters()
        out = {}
        for k in sorted(EVENT_KINDS):
            if (mine[k] > 0) != (theirs[k] > 0):
                out[k] = (mine[k], theirs[k])
        return out


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


def slot_busy_from_trace(events: list, n_slots: int, kind: str = "",
                         window: tuple = (0.0, 0.0),
                         end: Optional[float] = None) -> list:
    """Per-slot busy seconds from the trace, clipped to ``window`` --
    directly comparable to ``Metrics.slot_utilization(kind, n_slots)``."""
    ws, we = window
    hi_bound = we if we > 0.0 else math.inf
    busy = [0.0] * n_slots
    for slot, ivs in busy_intervals(events, end=end).items():
        if not (0 <= slot < n_slots):
            continue
        for iv in ivs:
            if kind and iv["jkind"] != kind:
                continue
            lo = min(max(iv["start"], ws), hi_bound)
            hi = min(max(iv["stop"], ws), hi_bound)
            busy[slot] += hi - lo
    return busy


def wakeup_delays(events: list) -> dict:
    """Per-group wake -> first-start delays (the paper's wakeup-latency
    attribution for tail spikes).  Matches the metrics convention: only the
    first start after each wake counts."""
    pending: dict = {}
    delays: dict = defaultdict(list)
    for ev in events:
        if ev.kind == "wake":
            pending[ev.jid] = ev.t
        elif ev.kind == "start_job" and ev.jid in pending:
            delays[ev.group].append(ev.t - pending.pop(ev.jid))
    return dict(delays)


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

PID_SLOTS, PID_GROUPS, PID_LOCKS = 1, 2, 3


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def to_chrome_trace(events: list, end: Optional[float] = None) -> dict:
    """Export to the Chrome ``trace_event`` JSON object format (loadable in
    Perfetto / chrome://tracing).

    Layout: process "slots" has one thread per slot carrying complete
    ("X") events per job run plus instant events for kicks and preempts;
    process "groups" has one thread per workload group carrying the same
    runs grouped by owner plus instant wake/boost/unboost events; process
    "locks" has one thread per lock with held spans named by holder."""
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

    return {"displayTimeUnit": "ms", "traceEvents": te,
            "otherData": {"schema": "repro.core.trace/v1",
                          "n_source_events": len(events)}}


def write_chrome_trace(events: list, path: str,
                       end: Optional[float] = None) -> int:
    """Validate and write a Chrome trace export; returns the number of
    trace_event records written.  Output bytes are deterministic for a
    deterministic event stream (sorted keys, fixed float formatting)."""
    doc = to_chrome_trace(events, end=end)
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


# ---------------------------------------------------------------------------
# CLI: produce and validate a sample trace (CI artifact)
# ---------------------------------------------------------------------------

def main(argv: Optional[list] = None) -> None:
    import argparse

    from .experiment import run_mix

    ap = argparse.ArgumentParser(
        description="Run a small mixed workload in simulation and export a "
                    "validated Chrome trace (open at https://ui.perfetto.dev)")
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--policy", default="ufs")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--warmup", type=float, default=0.2)
    args = ap.parse_args(argv)

    tracer = SchedTracer()
    run_mix(args.policy, n_slots=args.slots, n_bursty=args.slots,
            n_bound=args.slots, duration=args.duration, warmup=args.warmup,
            tracer=tracer)
    events = tracer.events
    validate_events(events, balanced=False)
    n = write_chrome_trace(events, args.out,
                           end=args.warmup + args.duration)
    s = tracer.summary()
    print(f"{args.out}: {n} trace records from {s.events} events "
          f"({s.dropped} dropped), kinds={sorted(s.counts)}")


if __name__ == "__main__":
    main()
