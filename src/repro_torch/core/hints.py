"""Application-based scheduler hinting (paper sections 4, 5.2).

The eBPF-map analogue: a shared table the application (engine) writes lock
events into and the scheduler reads when making decisions. Each entry pairs
(job id, lock id), mirroring the paper's map entries of (PID, lock id).

The scheduler reacts on the *wait-start* path: when a time-sensitive job
reports waiting on a lock currently held by a background job, the holder is
temporarily **boosted** into the time-sensitive tier until it releases the
lock -- resolving indirect priority inversion. Boosting is reference-counted
per held lock so nested locks behave.

All operations are O(1) dict updates; the overhead benchmark
(benchmarks/sec67_hint_overhead.py) reproduces the paper's <=1% finding.
"""
from __future__ import annotations

from typing import Callable, Optional

from .task import Job, Tier


class HintTable:
    """Shared app<->scheduler hint state (eBPF map analogue)."""

    def __init__(self) -> None:
        self.holders: dict[int, Job] = {}          # lock_id -> holder job
        self.waiters: dict[int, list[Job]] = {}    # lock_id -> waiting jobs
        self._boost_reasons: dict[int, set[int]] = {}  # holder jid -> {lock_id}
        # Scheduler callbacks, wired by the policy at attach time.
        self.on_boost: Optional[Callable[[Job], None]] = None
        self.on_unboost: Optional[Callable[[Job], None]] = None
        # Metrics
        self.writes = 0
        self.boosts = 0

    # ------------------------------------------------------------------ app side
    def report_lock_acquired(self, job: Job, lock_id: int) -> None:
        self.writes += 1
        self.holders[lock_id] = job
        # A holder that someone already waits on (race: waiter registered
        # between release and re-acquire) may need an immediate boost.
        self._maybe_boost(lock_id)

    def report_wait_start(self, job: Job, lock_id: int) -> None:
        """pgstat_report_wait_start analogue (idempotent per waiter)."""
        self.writes += 1
        w = self.waiters.setdefault(lock_id, [])
        if job not in w:
            w.append(job)
        self._maybe_boost(lock_id)

    def report_wait_end(self, job: Job, lock_id: int) -> None:
        """pgstat_report_wait_end analogue.

        Also re-evaluates the holder's boost: a waiter that leaves
        *without* acquiring (acquire timeout, panic) may have been the
        time-sensitive waiter the boost exists for, and the boost must
        expire with the wait, not with the lock -- otherwise a timed-out
        waiter leaves the holder boosted indefinitely."""
        self.writes += 1
        w = self.waiters.get(lock_id)
        if w and job in w:
            w.remove(job)
            if not w:
                del self.waiters[lock_id]
            self._reevaluate(lock_id)

    def report_lock_released(self, job: Job, lock_id: int) -> None:
        self.writes += 1
        if self.holders.get(lock_id) is job:
            del self.holders[lock_id]
        self._unboost(job, lock_id)

    def purge_job(self, job: Job) -> None:
        """Remove every trace of ``job`` from the table (panic/quarantine
        containment, DESIGN.md section 12): wait entries it would otherwise
        leak, its own boost residue, and any holder entries still naming it
        after its locks were force-released outside the normal path.  Boosts
        other holders carry on this job's behalf are re-evaluated so they
        expire with the dead waiter."""
        for lock_id in [lid for lid, w in self.waiters.items() if job in w]:
            self.report_wait_end(job, lock_id)
        reasons = self._boost_reasons.pop(job.jid, None)
        if reasons and job.boosted:
            job.boosted = False
            job.boost_group = None
            if self.on_unboost is not None:
                self.on_unboost(job)
        for lock_id in [lid for lid, h in self.holders.items() if h is job]:
            del self.holders[lock_id]

    # ------------------------------------------------------------ scheduler side
    def _maybe_boost(self, lock_id: int) -> None:
        holder = self.holders.get(lock_id)
        if holder is None or holder.group.tier != Tier.BACKGROUND:
            return
        waiters = self.waiters.get(lock_id, ())
        ts_waiter = next((w for w in waiters if w.tier == Tier.TIME_SENSITIVE), None)
        if ts_waiter is None:
            return
        reasons = self._boost_reasons.setdefault(holder.jid, set())
        if lock_id in reasons:
            return
        reasons.add(lock_id)
        if not holder.boosted:
            holder.boosted = True
            # Priority inheritance: schedule the holder as a member of the
            # waiting time-sensitive task's group until release.
            holder.boost_group = ts_waiter.sched_group()
            holder.boost_count += 1
            self.boosts += 1
            if self.on_boost is not None:
                self.on_boost(holder)

    def _reevaluate(self, lock_id: int) -> None:
        """A waiter left without acquiring: if no time-sensitive waiter
        remains, retract the holder's boost reason for this lock.  On the
        normal hand-off path the releasing holder is already gone from
        ``holders`` by the time the new owner reports wait-end, so this is
        a no-op there."""
        holder = self.holders.get(lock_id)
        if holder is None:
            return
        waiters = self.waiters.get(lock_id, ())
        if any(w.tier == Tier.TIME_SENSITIVE for w in waiters):
            return
        self._unboost(holder, lock_id)

    def _unboost(self, holder: Job, lock_id: int) -> None:
        reasons = self._boost_reasons.get(holder.jid)
        if not reasons:
            return
        reasons.discard(lock_id)
        if not reasons and holder.boosted:
            holder.boosted = False
            holder.boost_group = None
            del self._boost_reasons[holder.jid]
            if self.on_unboost is not None:
                self.on_unboost(holder)
