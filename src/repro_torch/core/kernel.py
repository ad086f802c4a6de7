"""Sim-mode execution backend: the discrete-event clock behind SchedCore.

This is the host-side analogue of the kernel scheduling core that
``sched_ext`` policies plug into (DESIGN.md section 2).  The shared
scheduling machinery -- slots, group/job registries, the policy callback
surface, enqueue/dispatch/start/stop/preempt, hint wiring -- lives in
:mod:`repro_torch.core.base` (:class:`~repro_torch.core.base.SchedCore`) and is common
to both execution modes.  This module contributes the **sim** backend:

* :class:`SimClock` -- a deterministic discrete-event clock (heap of
  timestamped callbacks); benchmarks reproduce the paper's experiments in
  virtual time;
* :class:`SimExecutor` -- drives generator-based :class:`Job` behaviours
  (bursts, blocks, lock phases) against the core: arms run-end events,
  applies burst accounting on preemption, advances the phase machinery;
* :class:`SchedKernel` -- the sim facade over :class:`SchedCore`
  (``add_job`` / ``run`` / ``create_lock``).

Live mode (``repro_torch.core.live``) drives the *same* policy objects and the
same core with real threads.  Policies never advance time themselves; they
only mutate queue state and request kicks, exactly as eBPF callbacks do.
"""
from __future__ import annotations

import heapq
import traceback
import warnings
from contextlib import nullcontext
from typing import Callable, ContextManager, Optional

from .base import DEFAULT_SLICE, Executor, Policy, SchedCore, Slot
from .hints import HintTable
from .locks import SimLock
from .metrics import Metrics
from .trace import SchedTracer
from .task import (AcquireLock, Block, Burst, Exit, Job, JobState, PanicExit,
                   ReleaseLock, RequestBegin, RequestEnd, TryLock)

__all__ = ["SimClock", "SimExecutor", "SchedKernel", "Policy", "Slot",
           "SchedCore", "Executor", "DEFAULT_SLICE"]

_NULL_GUARD = nullcontext()


class SimClock:
    """Deterministic discrete-event clock with cancellable events.

    Events are mutable ``[time, seq, fn]`` cells; :meth:`at`/:meth:`after`
    return the cell as a handle and :meth:`cancel` kills it in O(1) by
    nulling ``fn`` (lazy deletion, DESIGN.md section 11).  Dead cells are
    skipped on pop and compacted wholesale once they outnumber live ones,
    so the heap no longer grows with every preemption or slice expiry.
    ``seq`` is per-clock, so same-seed runs are deterministic regardless of
    how many other kernels the process has built.

    :attr:`processed` counts executed events -- the denominator of the
    events/sec figure in ``benchmarks/microbench.py``.
    """

    def __init__(self) -> None:
        self.now = 0.0
        self._heap: list = []          # [t, seq, fn-or-None] cells
        self._seq = 0
        self._dead = 0                 # cancelled cells still in the heap
        self.processed = 0

    def __len__(self) -> int:
        """Live (uncancelled) pending events."""
        return len(self._heap) - self._dead

    @property
    def heap_size(self) -> int:
        """Raw heap occupancy including dead cells (compaction telemetry)."""
        return len(self._heap)

    def at(self, t: float, fn: Callable[[], None]) -> list:
        self._seq += 1
        ev = [max(t, self.now), self._seq, fn]
        heapq.heappush(self._heap, ev)
        return ev

    def after(self, dt: float, fn: Callable[[], None]) -> list:
        return self.at(self.now + dt, fn)

    def cancel(self, ev: list) -> bool:
        """Cancel a pending event.  Returns False if it already ran or was
        already cancelled.  O(1); the cell is pruned from the heap lazily."""
        if ev[2] is None:
            return False
        ev[2] = None
        self._dead += 1
        if self._dead > 64 and self._dead * 2 > len(self._heap):
            self._heap = [e for e in self._heap if e[2] is not None]
            heapq.heapify(self._heap)
            self._dead = 0
        return True

    def run_until(self, horizon: float) -> None:
        heap = self._heap
        while heap and heap[0][0] <= horizon:
            ev = heapq.heappop(heap)
            fn = ev[2]
            if fn is None:
                self._dead -= 1
                continue
            # Mark executed *before* the callback: a nested cancel of this
            # same (already-popped) event must be a no-op, or _dead drifts.
            ev[2] = None
            self.now = ev[0]
            fn()
            self.processed += 1
        self.now = max(self.now, horizon)

    def empty(self) -> bool:
        return len(self._heap) == self._dead


class SimExecutor(Executor):
    """Discrete-event backend: jobs are generators of bounded phases.

    Owns the virtual clock, the per-slot run-end event handles (cancelled
    on stop instead of token-bumped, so stale closures never linger in the
    heap), and the phase machinery (:meth:`advance`) that turns a job's
    behaviour generator into wake/block/lock transitions against the
    shared core.
    """

    single_threaded = True

    def __init__(self) -> None:
        self.clock = SimClock()
        self._run_events: dict[int, list] = {}   # sid -> pending run-end handle

    # ---------------------------------------------------- Executor protocol
    @property
    def now(self) -> float:
        return self.clock.now

    def defer(self, dt: float, fn: Callable[[], None]) -> None:
        self.clock.after(dt, fn)

    def guard(self) -> ContextManager:
        # Single-threaded event loop: lifecycle code needs no locking.
        return _NULL_GUARD

    def deliver_kick(self, slot: Slot, preempt: bool) -> None:
        if not slot.online:
            return
        if slot.current is None:
            self.core.schedule_next(slot)
        elif preempt:
            self.core.preempt_slot(slot)

    def job_started(self, slot: Slot) -> None:
        self._arm_run_end(slot)

    def job_stopping(self, slot: Slot) -> None:
        ev = self._run_events.pop(slot.sid, None)
        if ev is not None:
            self.clock.cancel(ev)                # cancel in-flight run-end event

    def job_preempted(self, job: Job, slot: Slot, used: float) -> None:
        job.burst_remaining -= used
        if job.burst_remaining <= 1e-12:
            # Raced with burst completion; let the phase machine finish it.
            job.burst_remaining = 0.0
            self.advance(job)
        else:
            self.core.requeue(job)

    def interrupt(self, slot: Slot) -> None:
        self.core.preempt_slot(slot)

    def slot_added(self, slot: Slot) -> None:
        self.clock.after(0.0, lambda: self.core.schedule_next(slot))

    # ------------------------------------------------------- run-end events
    def _arm_run_end(self, slot: Slot) -> None:
        job = slot.current
        run_for = min(job.burst_remaining, slot.slice_budget)
        stale = self._run_events.get(slot.sid)
        if stale is not None:                    # defensive: never two armed
            self.clock.cancel(stale)
        self._run_events[slot.sid] = self.clock.after(
            run_for, lambda: self._run_end(slot))

    def _run_end(self, slot: Slot) -> None:
        # Cancellation handles staleness: if this fires, the run it was
        # armed for is still current (stop_job cancels on every stop path).
        self._run_events.pop(slot.sid, None)
        if slot.current is None:
            return
        core = self.core
        job = slot.current
        used = core.now - slot.run_started
        job.burst_remaining -= used
        if job.burst_remaining <= 1e-12:
            job.burst_remaining = 0.0
            core.stop_job(slot, used, reason="complete")
            self.advance(job, from_slot=slot)
            core.schedule_next(slot)
        else:
            # Slice expiry: charge, requeue, pick next (paper: re-enqueue path).
            core.stop_job(slot, used, reason="slice")
            core.requeue(job)
            core.schedule_next(slot)

    # ------------------------------------------------------- phase machinery
    def add_job(self, job: Job, at: float = 0.0) -> None:
        self.core.jobs[job.jid] = job
        self.clock.at(at, lambda: self.advance(job))

    def advance(self, job: Job, from_slot: Optional[Slot] = None) -> None:
        """Drive the job's behaviour generator until it needs CPU or sleeps.

        Phases are advanced with ``generator.send(resume_value)`` so that
        zero-time probes (``TryLock``) can return results into the workload
        generator (spin-acquire loops, see ``core.locks.spin_acquire``).
        """
        core = self.core
        if job.state == JobState.EXITED:
            return
        while True:
            try:
                # send(None) on a fresh generator is next(); resume_value is
                # only ever non-None after the generator has started.
                value, job.resume_value = job.resume_value, None
                ph = job.behavior.send(value)
            except StopIteration:
                self._exit(job)
                return
            except Exception as e:               # noqa: BLE001
                # Behaviour crashed mid-phase: the sim analogue of a live
                # chunk raising -- contain it (locks, hints, retry policy).
                core.panic_job(job, exc=e, trace_back=traceback.format_exc())
                return
            if isinstance(ph, Burst):
                job.burst_remaining = ph.duration
                job.current_request = ph.request_id
                if from_slot is not None and from_slot.online:
                    # Back-to-back burst (no voluntary sleep): requeue, not
                    # wakeup -- no sleeper credit, and the policy decides
                    # whether the job keeps the slot (FIFO front / vruntime
                    # order / fair-server window all apply here).
                    job.state = JobState.RUNNABLE
                    job.wakeup_time = -1.0
                    core.requeue(job)
                    core.schedule_next(from_slot)
                else:
                    core.wake(job)
                return
            elif isinstance(ph, Block):
                job.state = JobState.BLOCKED
                self.clock.after(ph.duration, lambda j=job: self.advance(j))
                return
            elif isinstance(ph, TryLock):
                job.resume_value = ph.lock.try_acquire(job)
            elif isinstance(ph, RequestBegin):
                job.request_started_at = core.now
            elif isinstance(ph, RequestEnd):
                job.completed_requests += 1
                core.metrics.record_request(
                    job.group.name, core.now - job.request_started_at, core.now)
            elif isinstance(ph, AcquireLock):
                lock: SimLock = ph.lock
                if lock.try_acquire(job):
                    job.resume_value = True
                    continue
                lock.park(job)
                job.state = JobState.LOCK_WAIT       # parked; release hands off
                return
            elif isinstance(ph, ReleaseLock):
                woken = ph.lock.release(job)
                if woken is not None:
                    woken.resume_value = True
                    self.advance(woken)              # hand-off: waiter proceeds
            elif isinstance(ph, PanicExit):
                # Stuck-spinlock watchdog: same containment path as a
                # crashed behaviour (PostgreSQL PANICs the process; a job
                # with a RetryPolicy models the restarted backend).
                core.panic_job(job, reason="stuck_spinlock")
                return
            elif isinstance(ph, Exit):
                self._exit(job)
                return
            else:
                raise TypeError(f"unknown phase {ph!r}")

    def _exit(self, job: Job) -> None:
        job.state = JobState.EXITED
        self.release_held_locks(job)

    def release_held_locks(self, job: Job) -> None:
        """Sleep-discipline releases hand the lock to a parked waiter; a
        job exiting (or panicking) with waiters parked must resume them or
        they sleep forever holding a granted lock."""
        for lock in list(job.held_locks):
            woken = lock.release(job)
            if woken is not None:
                woken.resume_value = True
                self.advance(woken)

    def restart_job(self, job: Job) -> bool:
        factory = job.behavior_factory
        if factory is None:
            return False                 # dead generator, no way to rebuild
        job.behavior = factory()
        job.resume_value = None
        job.burst_remaining = 0.0
        job.current_request = None
        return True

    def resume_retry(self, job: Job) -> None:
        self.advance(job)                # fresh generator wakes at its burst


class SchedKernel(SchedCore):
    """Sim-mode scheduling kernel: a thin facade over :class:`SchedCore`
    with a :class:`SimExecutor` backend.

    Shares one keyword signature with :class:`~repro_torch.core.live.LiveKernel`
    (``policy, n_slots, kick_latency, tracer, metrics, ...``), so
    :func:`repro_torch.core.build.build_kernel` is a thin mode switch.  The old
    positional form beyond ``(n_slots, policy)`` still works but warns.
    """

    _LEGACY_POSITIONAL = ("hints", "metrics", "kick_latency",
                          "hints_enabled", "seed")

    def __init__(
        self,
        n_slots: int,
        policy: Policy,
        *legacy,
        hints: Optional[HintTable] = None,
        metrics: Optional[Metrics] = None,
        kick_latency: float = 0.0,
        hints_enabled: bool = True,
        seed: int = 0,
        tracer: Optional[SchedTracer] = None,
    ):
        if legacy:
            if len(legacy) > len(self._LEGACY_POSITIONAL):
                raise TypeError(
                    f"SchedKernel takes at most "
                    f"{2 + len(self._LEGACY_POSITIONAL)} positional arguments")
            warnings.warn(
                "positional SchedKernel arguments beyond (n_slots, policy) "
                "are deprecated; pass hints/metrics/kick_latency/"
                "hints_enabled/seed by keyword (or use build_kernel)",
                DeprecationWarning, stacklevel=2)
            over = dict(zip(self._LEGACY_POSITIONAL, legacy))
            hints = over.get("hints", hints)
            metrics = over.get("metrics", metrics)
            kick_latency = over.get("kick_latency", kick_latency)
            hints_enabled = over.get("hints_enabled", hints_enabled)
            seed = over.get("seed", seed)
        super().__init__(n_slots, policy, SimExecutor(), hints=hints,
                         metrics=metrics, kick_latency=kick_latency,
                         hints_enabled=hints_enabled, tracer=tracer)
        self._rng_state = seed or 1

    @property
    def clock(self) -> SimClock:
        return self.executor.clock

    def create_lock(self, name: str = "") -> SimLock:
        return SimLock(self, name)

    # ------------------------------------------------------------ job control
    def add_job(self, job: Job, at: float = 0.0) -> None:
        self.executor.add_job(job, at)

    def run(self, horizon: float, warmup: float = 0.0) -> Metrics:
        self.metrics.window_start = warmup
        self.metrics.window_end = horizon
        self.clock.run_until(horizon)
        self._settle_accounting()
        return self.metrics

    def _settle_accounting(self) -> None:
        """Charge partially-elapsed runs at the horizon so utilization sums."""
        for slot in self.slots:
            job = slot.current
            if job is not None:
                used = self.now - slot.run_started
                if used > 0:
                    self.metrics.record_run(slot.sid, job.kind, job.group.name, used, self.now)
                    slot.run_started = self.now
