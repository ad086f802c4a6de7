"""Scheduler metrics: throughput, latency percentiles, per-slot utilization.

Per-slot busy time by job kind supports the Figure-2 reconstruction (the
paper rebuilds per-CPU execution time of CPU-bursty tasks from sched_switch
traces; we account it directly at charge time).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional


def percentile_sorted(s: list, q: float) -> float:
    """Nearest-rank percentile of an already-sorted list (q in [0,100])."""
    if not s:
        return float("nan")
    k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile on a copy (q in [0,100]).  Callers reading
    several quantiles should sort once and use :func:`percentile_sorted`."""
    return percentile_sorted(sorted(values), q)


class Metrics:
    def __init__(self) -> None:
        self.request_latency: dict[str, list] = defaultdict(list)   # group -> latencies
        self.wakeup_latency: dict[str, list] = defaultdict(list)    # group -> wake->run delays
        self.completed: dict[str, int] = defaultdict(int)           # group -> finished requests
        self.cpu_by_group: dict[str, float] = defaultdict(float)    # group -> slot-seconds
        self.slot_busy: dict = defaultdict(float)                   # (slot, kind) -> busy seconds
        self.preemptions: int = 0
        self.kicks: int = 0
        self.dispatches: int = 0
        self.lb_migrations: int = 0
        self.panics: list[str] = []
        self.retries: int = 0               # panic-path restarts granted
        self.quarantines: int = 0           # jobs poisoned after retries ran out
        self.window_start: float = 0.0
        self.window_end: float = 0.0

    # ------------------------------------------------------------------
    def record_run(self, slot_id: int, kind: str, group: str, dur: float, t: float) -> None:
        """Charge a run ending at ``t`` of length ``dur``, clipped to the
        measurement window.  Both ends are clamped symmetrically into
        [window_start, window_end] so a run straddling either window edge
        contributes exactly its in-window portion (and never a negative
        span): the old one-sided ``min(t, window_end)`` could place ``hi``
        before ``lo`` and silently drop the run."""
        end = self.window_end if self.window_end > 0.0 else float("inf")
        lo = min(max(t - dur, self.window_start), end)
        hi = min(max(t, self.window_start), end)
        d = hi - lo
        if d <= 0.0:
            return
        self.slot_busy[(slot_id, kind)] += d
        self.cpu_by_group[group] += d

    def record_request(self, group: str, latency: float, t: float) -> None:
        if t < self.window_start or (self.window_end and t > self.window_end):
            return
        self.completed[group] += 1
        self.request_latency[group].append(latency)

    def record_wakeup(self, group: str, delay: float, t: float) -> None:
        if t < self.window_start:
            return
        self.wakeup_latency[group].append(delay)

    # ------------------------------------------------------------------
    def throughput(self, group: str, duration: Optional[float] = None) -> float:
        dur = duration or (self.window_end - self.window_start)
        return self.completed[group] / dur if dur > 0 else 0.0

    def latency_stats(self, group: str) -> dict:
        lat = self.request_latency[group]
        if not lat:
            return {"mean": float("nan"), "p50": float("nan"), "p95": float("nan"),
                    "p99": float("nan"), "p999": float("nan"), "n": 0}
        s = sorted(lat)
        return {
            # mean sums the insertion-order list so float accumulation is
            # stable against the sort (byte-identical summaries).
            "mean": sum(lat) / len(lat),
            "p50": percentile_sorted(s, 50),
            "p95": percentile_sorted(s, 95),
            "p99": percentile_sorted(s, 99),
            "p999": percentile_sorted(s, 99.9),
            "n": len(lat),
        }

    def slot_utilization(self, kind: str, n_slots: int) -> list:
        """Per-slot busy seconds for jobs of ``kind`` (Figure 2)."""
        return [self.slot_busy.get((s, kind), 0.0) for s in range(n_slots)]

    def slot_skew(self, kind: str, n_slots: int) -> float:
        """max/mean utilization ratio across slots -- 1.0 means perfectly even."""
        u = self.slot_utilization(kind, n_slots)
        mean = sum(u) / len(u) if u else 0.0
        return (max(u) / mean) if mean > 0 else float("nan")

    def wakeup_stats(self, group: str) -> dict:
        """Wakeup-latency distribution for ``group`` (wake -> first start)."""
        w = self.wakeup_latency.get(group, [])
        if not w:
            return {"mean": float("nan"), "p95": float("nan"),
                    "max": float("nan"), "n": 0}
        s = sorted(w)
        return {"mean": sum(w) / len(w), "p95": percentile_sorted(s, 95),
                "max": s[-1], "n": len(w)}

    # ------------------------------------------------------------------
    def summary(self, groups: Optional[list] = None,
                n_slots: Optional[int] = None) -> dict:
        """The one read surface for consumers: a nested dict of everything
        above.  ``experiment.MixResult``, ``benchmarks``, the launch
        drivers, and ``KernelReport`` all read this instead of assembling
        their own percentile dicts.

        ``groups`` defaults to every group seen; pass an explicit list to
        include groups with no activity.  ``n_slots`` adds the per-slot
        utilization block (Figure 2)."""
        if groups is None:
            groups = sorted(set(self.completed) | set(self.request_latency)
                            | set(self.cpu_by_group) | set(self.wakeup_latency))
        counters = {"preemptions": self.preemptions, "kicks": self.kicks,
                    "dispatches": self.dispatches,
                    "lb_migrations": self.lb_migrations,
                    "panics": list(self.panics)}
        # Fault counters appear only on faulting runs: fault-free summaries
        # stay byte-identical to the committed microbench baseline
        # (BENCH_8.json compares summary hashes exactly).
        if self.retries:
            counters["retries"] = self.retries
        if self.quarantines:
            counters["quarantines"] = self.quarantines
        out = {
            "window": {"start": self.window_start, "end": self.window_end,
                       "duration": max(0.0, self.window_end - self.window_start)},
            "counters": counters,
            "groups": {
                g: {"completed": self.completed.get(g, 0),
                    "throughput": self.throughput(g),
                    "cpu_s": self.cpu_by_group.get(g, 0.0),
                    "latency": self.latency_stats(g),
                    "wakeup": self.wakeup_stats(g)}
                for g in groups
            },
        }
        if n_slots is not None:
            kinds = sorted({k for (_, k) in self.slot_busy})
            out["slots"] = {
                "n": n_slots,
                "busy_by_kind": {k: self.slot_utilization(k, n_slots)
                                 for k in kinds},
                "skew_by_kind": {k: self.slot_skew(k, n_slots)
                                 for k in kinds},
            }
        return out
