"""The shared scheduling core: one policy surface, pluggable execution.

This module is the single implementation of the scheduling machinery that
both execution modes share (DESIGN.md section 2).  :class:`SchedCore` owns

* **slots** -- execution units (device slots on a pod; CPUs in the paper),
  each with a local DSQ;
* the **group/job registries** (cgroup analogue, task table);
* the **job lifecycle** -- enqueue (wake/requeue), dispatch
  (:meth:`SchedCore.schedule_next`), start/stop bookkeeping, preemption;
* **hint -> boost wiring** (priority-inversion avoidance), **metrics**, and
  the **trace plane** (:mod:`repro_torch.core.trace`): every lifecycle edge emits
  a structured event into an optional :class:`SchedTracer`;

parameterized by a narrow :class:`Executor` protocol with two backends:

* ``SimExecutor`` (``repro_torch.core.kernel``) -- the deterministic discrete-event
  clock driving generator-based jobs in virtual time;
* ``ThreadExecutor`` (``repro_torch.core.live``) -- worker threads driving real
  (device) ``run_chunk`` jobs, with chunk-granular preempt polling.

Policies (:class:`Policy`) attach to the *core*, never to a backend, so the
same policy object behaves identically under simulation and deployment --
the sim/live parity invariant (tests/test_parity.py).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from contextlib import nullcontext
from typing import Callable, ContextManager, Optional

from .dsq import GroupDSQ, LocalDSQ
from .hints import HintTable
from .metrics import Metrics
from .task import Job, JobState, Tier, WorkloadGroup
from .trace import SchedTracer

DEFAULT_SLICE = 0.003  # 3 ms bounded execution interval (paper section 5.1.1)

_NULL_GUARD = nullcontext()


def _trace_noop(kind, *, slot=None, job=None, **args) -> None:
    """Pre-bound no-op installed as ``core.trace`` when no tracer is
    attached: plain function, no self binding, no tracer lookup.  Hot
    emitters additionally guard on ``core._traced`` so untraced runs never
    even build the kwargs dict."""


class Slot:
    """An execution unit: one mesh-slice program context (a CPU, in the paper).

    Holds only backend-independent execution state.  Policy-private state
    (e.g. the RT fair-server window) lives in the policy; backend-private
    state (run-end tokens, preempt flags) lives in the executor.
    """

    def __init__(self, sid: int):
        self.sid = sid
        self.local_dsq = LocalDSQ()
        self.current: Optional[Job] = None
        self.run_started = 0.0
        self.slice_budget = 0.0
        self.online = True            # False once drained (elasticity)

    @property
    def idle(self) -> bool:
        return self.current is None and len(self.local_dsq) == 0

    def __repr__(self) -> str:  # pragma: no cover
        cur = self.current.name if self.current else "-"
        return f"Slot({self.sid}, cur={cur}, q={len(self.local_dsq)})"


class Policy(ABC):
    """sched_ext-style policy callback surface (DESIGN.md section 3).

    ``attach`` receives the :class:`SchedCore` (the facades subclass it, so
    ``self.kernel`` works against either backend).  Callbacks are always
    invoked with the core's mutation guard held; policies never advance time
    themselves, they only mutate queue state and request kicks.
    """

    name = "abstract"

    def attach(self, kernel: "SchedCore") -> None:
        self.kernel = kernel

    @abstractmethod
    def enqueue(self, job: Job, requeue: bool = False) -> None:
        """Job became runnable (wakeup) or must be requeued (preempt/slice)."""

    @abstractmethod
    def dispatch(self, slot: Slot) -> None:
        """Slot needs work and its local DSQ is empty: pull if possible."""

    def pick_next(self, slot: Slot):
        """Select the next job for a free slot: local DSQ first, then pull
        via :meth:`dispatch`. Policies may override the pick order (e.g. the
        RT fair-server window)."""
        nxt = slot.local_dsq.pop_front()
        while nxt is not None and nxt.state != JobState.RUNNABLE:
            nxt = slot.local_dsq.pop_front()
        if nxt is None:
            k = self.kernel
            k.metrics.dispatches += 1
            if k._traced:
                k.trace("dispatch", slot=slot.sid)
            self.dispatch(slot)
            nxt = slot.local_dsq.pop_front()
            while nxt is not None and nxt.state != JobState.RUNNABLE:
                nxt = slot.local_dsq.pop_front()
        return nxt

    def running(self, job: Job, slot: Slot) -> None:
        """Job starts executing on slot."""

    def stopping(self, job: Job, slot: Slot, used: float) -> None:
        """Job stops executing (block/preempt/slice/exit); charge service."""

    def task_slice(self, job: Job) -> float:
        return DEFAULT_SLICE

    def on_boost(self, job: Job) -> None:
        """Hint boost fired for a queued/running background job."""

    def on_unboost(self, job: Job) -> None:
        pass

    def periodic(self) -> None:
        """Optional periodic work (load balancing); driven by the core timer."""

    periodic_interval: Optional[float] = None

    def queued_count(self) -> int:
        """Number of runnable jobs waiting in this policy's queues (local
        DSQs + group DSQs).  Used by event-driven executors to bound how
        many parked workers an enqueue wakes.  Policies with private queues
        (e.g. the RT global fair rq) must override and add them in."""
        k = self.kernel
        n = sum(len(s.local_dsq) for s in k.slots if s.online)
        n += sum(len(g.dsq) for g in k.groups.values() if g.dsq is not None)
        return n


class Executor(ABC):
    """Narrow backend protocol: how the core's decisions are carried out.

    The core calls *down* into the executor for time, deferred callbacks,
    mutual exclusion, and kick delivery; the executor calls *up* into the
    core's lifecycle methods (``schedule_next`` / ``start_job`` /
    ``stop_job`` / ``preempt_slot``) when its execution model needs them.

    ``single_threaded`` declares that all core/policy/tracer access happens
    on one thread, letting the core drop tracer locking (sim backend).
    """

    core: "SchedCore"
    single_threaded = False

    def bind(self, core: "SchedCore") -> None:
        self.core = core

    @property
    @abstractmethod
    def now(self) -> float:
        """Current time on this backend's clock (virtual or monotonic)."""

    @abstractmethod
    def defer(self, dt: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` after ``dt`` seconds on this backend's clock."""

    @abstractmethod
    def guard(self) -> ContextManager:
        """Mutation guard for scheduler state.  Re-entrant: lifecycle code
        nests freely.  Sim: a no-op (single-threaded event loop); threads: a
        condition variable that wakes idle workers on exit."""

    @abstractmethod
    def deliver_kick(self, slot: Slot, preempt: bool) -> None:
        """Backend-specific kick delivery: sim dispatches/preempts at the
        current event; threads set a chunk-granular preempt flag and notify."""

    # ---- optional lifecycle hooks -------------------------------------
    def job_started(self, slot: Slot) -> None:
        """Dispatch tail after :meth:`SchedCore.start_job` (sim arms the
        run-end event; threads run the chunk inline in the worker)."""

    def job_stopping(self, slot: Slot) -> None:
        """Stop head before the policy is charged (sim cancels the pending
        run-end event)."""

    def job_preempted(self, job: Job, slot: Slot, used: float) -> None:
        """Continuation for a job forced off a slot mid-execution."""

    def release_held_locks(self, job: Job) -> None:
        """Force-release every engine lock the job still holds (panic /
        exit containment).  The sim backend overrides this to resume
        parked waiters that the release hands the lock to."""
        for lock in list(job.held_locks):
            lock.release(job)

    def restart_job(self, job: Job) -> bool:
        """Prepare a faulted job for a retry restart; False if this
        backend cannot restart it (quarantine instead).  Live chunks are
        plain callables and re-invoke naturally; the sim backend needs a
        ``behavior_factory`` to rebuild the dead generator."""
        return True

    def resume_retry(self, job: Job) -> None:
        """Re-admit a restarted job after its backoff delay: live wakes it
        (the chunk re-runs on dispatch); sim re-enters the phase machinery
        so the rebuilt generator wakes itself at its first burst."""
        self.core.wake(job)

    def interrupt(self, slot: Slot) -> None:
        """Force the current job off ``slot`` (drain): sim preempts at the
        current event; threads request a chunk-boundary stop."""

    def work_enqueued(self, job: Job) -> None:
        """A job just entered the policy's queues (wake/requeue).  Called
        with the mutation guard held.  Event-driven executors use this to
        arm their guard-exit wake-scan; the sim backend ignores it."""

    def slot_added(self, slot: Slot) -> None:
        """A slot joined the pool (elastic scale-up)."""

    def start(self) -> None:
        """Begin executing (no-op for the event-driven sim)."""

    def stop(self) -> None:
        """Stop executing and release backend resources."""


class SchedCore:
    """Backend-independent scheduling core shared by sim and live kernels.

    ``SchedKernel`` (sim) and ``LiveKernel`` (threads) are thin facades over
    this class; all enqueue/dispatch/start/stop/preempt logic and the
    hint-boost wiring live here, once.
    """

    def __init__(
        self,
        n_slots: int,
        policy: Policy,
        executor: Executor,
        hints: Optional[HintTable] = None,
        metrics: Optional[Metrics] = None,
        kick_latency: float = 0.0,
        hints_enabled: bool = True,
        tracer: Optional[SchedTracer] = None,
    ):
        self.executor = executor
        self.slots = [Slot(i) for i in range(n_slots)]
        self.policy = policy
        self.hints = hints or HintTable()
        self.hints_enabled = hints_enabled
        self.metrics = metrics or Metrics()
        self.tracer = tracer
        self._traced = tracer is not None
        if not self._traced:
            # Shadow the bound method with a module-level no-op: untraced
            # emit sites that aren't individually guarded cost one plain
            # call, no kwargs-dict plumbing inside.
            self.trace = _trace_noop
        elif getattr(executor, "single_threaded", False):
            # Single-threaded event loop: the tracer ring needs no mutex.
            tracer.set_threadsafe(False)
        self.kick_latency = kick_latency
        self.jobs: dict[int, Job] = {}
        self.groups: dict[str, WorkloadGroup] = {}
        self.on_panic: Optional[Callable[[Job], None]] = None
        executor.bind(self)
        policy.attach(self)
        self.hints.on_boost = self._hint_boost
        self.hints.on_unboost = self._hint_unboost
        if policy.periodic_interval:
            self._schedule_periodic()

    # ------------------------------------------------------------- utilities
    @property
    def now(self) -> float:
        return self.executor.now

    def trace(self, kind: str, *, slot: Optional[int] = None,
              job: Optional[Job] = None, **args) -> None:
        """Emit a lifecycle event into the tracer.  When untraced this
        method is shadowed by a pre-bound no-op (see ``__init__``) and hot
        emitters skip the call entirely via ``self._traced``.  The
        timestamp comes from the executor clock, so sim and live runs
        share one event schema under their respective time bases."""
        self.tracer.emit(kind, self.executor.now, slot=slot, job=job, **args)

    def create_group(self, name: str, tier: Tier, weight: float = 100.0,
                     parent: Optional[WorkloadGroup] = None, **kw) -> WorkloadGroup:
        g = WorkloadGroup(name, tier, weight, parent=parent, **kw)
        g.dsq = GroupDSQ()          # custom DSQ (background deferred dispatch)
        self.groups[name] = g
        return g

    def online_slots(self) -> list:
        return [s for s in self.slots if s.online]

    # ------------------------------------------------------------- enqueue
    def wake(self, job: Job) -> None:
        """Job becomes runnable; hand to the policy's enqueue path."""
        with self.executor.guard():
            if job.state == JobState.EXITED:
                return
            self.jobs.setdefault(job.jid, job)
            job.state = JobState.RUNNABLE
            job.wakeup_time = self.now
            job.location = None
            if self._traced:
                self.trace("wake", job=job)
                self.trace("enqueue", job=job, requeue=False)
            # Arm *before* enqueue: the policy kicks the chosen slot from
            # inside enqueue(), and event-driven executors pair each kick
            # with one armed unit (a serviced enqueue needs no wake-scan).
            self.executor.work_enqueued(job)
            self.policy.enqueue(job, requeue=False)

    def requeue(self, job: Job) -> None:
        with self.executor.guard():
            job.state = JobState.RUNNABLE
            job.location = None
            if self._traced:
                self.trace("enqueue", job=job, requeue=True)
            self.executor.work_enqueued(job)   # before enqueue: see wake()
            self.policy.enqueue(job, requeue=True)

    # ------------------------------------------------------------- kicks
    def kick(self, slot: Slot, preempt: bool = False) -> None:
        """Wake an idle slot, or (preempt=True) force the running job off.

        ``kick_latency`` models the accelerator chunk-boundary adaptation: a kick
        takes effect only once the in-flight device program retires.
        """
        self.metrics.kicks += 1
        if self._traced:
            self.trace("kick", slot=slot.sid, preempt=preempt)
        if self.kick_latency > 0:
            self.executor.defer(self.kick_latency,
                                lambda: self.executor.deliver_kick(slot, preempt))
        else:
            self.executor.deliver_kick(slot, preempt)

    # ------------------------------------------------------------- dispatch
    def schedule_next(self, slot: Slot) -> None:
        """Fill a free slot: policy pick, shared start bookkeeping, then the
        backend's execution tail (arm a run-end event / run the chunk)."""
        if not slot.online or slot.current is not None:
            return
        nxt = self.policy.pick_next(slot)
        if nxt is None:
            return                               # idle
        self.start_job(slot, nxt)
        self.executor.job_started(slot)

    # --------------------------------------------------------- start / stop
    def start_job(self, slot: Slot, job: Job) -> None:
        """Shared bookkeeping when a job begins running on a slot."""
        assert job.state == JobState.RUNNABLE, f"{job} not runnable"
        job.state = JobState.RUNNING
        job.location = None
        if job.wakeup_time >= 0.0:
            self.metrics.record_wakeup(job.group.name, self.now - job.wakeup_time, self.now)
            job.wakeup_time = -1.0               # record only first start per wake
        job.prev_slot = slot.sid
        slot.current = job
        slot.run_started = self.now
        slot.slice_budget = self.policy.task_slice(job)
        if self._traced:
            self.trace("start_job", slot=slot.sid, job=job)
        self.policy.running(job, slot)

    def stop_job(self, slot: Slot, used: float, reason: str = "stop") -> Job:
        """Shared bookkeeping when the current job stops (block / preempt /
        slice expiry / exit); charges the policy and the metrics.
        ``reason`` is recorded in the trace only ("complete" / "slice" /
        "preempt" / live chunk statuses)."""
        job = slot.current
        assert job is not None
        self.executor.job_stopping(slot)         # cancel in-flight run-end event
        self.policy.stopping(job, slot, used)
        self.metrics.record_run(slot.sid, job.kind, job.group.name, used, self.now)
        if self._traced:
            self.trace("stop_job", slot=slot.sid, job=job, used=used,
                       reason=reason)
        slot.current = None
        return job

    # ------------------------------------------------------------- preempt
    def preempt_slot(self, slot: Slot) -> None:
        """Force the running job off ``slot`` now; the backend decides the
        job's continuation (burst accounting in sim; chunk epilogue live)."""
        job = slot.current
        if job is None:
            return
        self.metrics.preemptions += 1
        used = self.now - slot.run_started
        if self._traced:
            self.trace("preempt_slot", slot=slot.sid, job=job)
        self.stop_job(slot, used, reason="preempt")
        self.executor.job_preempted(job, slot, used)
        self.schedule_next(slot)

    # ------------------------------------------------------ fault containment
    def panic_job(self, job: Job, slot: Optional[Slot] = None,
                  exc: Optional[BaseException] = None, trace_back: str = "",
                  reason: str = "exception") -> None:
        """Contain a faulted job (DESIGN.md section 12).

        The one panic path for both backends: trace + count the panic,
        force-release the job's held locks (resuming any waiter the
        release hands a lock to), purge its hint-table entries so boosts
        it caused or carried expire now, notify ``on_panic``, then either
        restart the job under its :class:`~repro_torch.core.task.RetryPolicy`
        (bounded, exponential backoff) or quarantine it to EXITED.  The
        job must already be off its slot (``stop_job`` ran)."""
        with self.executor.guard():
            if job.state == JobState.EXITED:
                return
            job.panic = True
            job.last_panic = repr(exc) if exc is not None else reason
            self.metrics.panics.append(job.name)
            if self._traced:
                self.trace("panic", job=job,
                           slot=slot.sid if slot is not None else None,
                           reason=reason, error=job.last_panic,
                           traceback=trace_back, retries=job.retries)
            self.executor.release_held_locks(job)
            self.hints.purge_job(job)
            if self.on_panic is not None:
                self.on_panic(job)
            pol = job.retry_policy
            if (pol is not None and job.retries < pol.max_retries
                    and self.executor.restart_job(job)):
                job.retries += 1
                self.metrics.retries += 1
                job.state = JobState.BLOCKED
                delay = pol.delay(job.retries)
                if self._traced:
                    self.trace("retry", job=job, attempt=job.retries,
                               delay=delay)
                self.executor.defer(delay,
                                    lambda: self.executor.resume_retry(job))
            else:
                self.quarantine_job(job)

    def quarantine_job(self, job: Job) -> None:
        """Poison a crash-looping job: EXITED for good, never re-woken
        (``wake`` refuses EXITED jobs), counted and traced."""
        with self.executor.guard():
            job.quarantined = True
            job.state = JobState.EXITED
            self.metrics.quarantines += 1
            if self._traced:
                self.trace("quarantine", job=job, retries=job.retries)

    # ----------------------------------------------------------- hint wiring
    def _hint_boost(self, job: Job) -> None:
        with self.executor.guard():
            if self._traced:
                self.trace("boost", job=job,
                           boost_group=job.boost_group.name
                           if job.boost_group else "")
            self.policy.on_boost(job)

    def _hint_unboost(self, job: Job) -> None:
        with self.executor.guard():
            if self._traced:
                self.trace("unboost", job=job)
            self.policy.on_unboost(job)

    # ----------------------------------------------------------- elasticity
    def add_slot(self) -> Slot:
        with self.executor.guard():
            slot = Slot(len(self.slots))
            self.slots.append(slot)
            self.trace("slot_add", slot=slot.sid)
        self.executor.slot_added(slot)
        return slot

    def drain_slot(self, sid: int) -> None:
        """Take a slot offline: requeue its work elsewhere (node failure /
        elastic downscale)."""
        with self.executor.guard():
            slot = self.slots[sid]
            slot.online = False
            self.trace("slot_drain", slot=sid)
            if slot.current is not None:
                self.executor.interrupt(slot)
            while True:
                job = slot.local_dsq.pop_front()
                if job is None:
                    break
                self.requeue(job)

    # ------------------------------------------------------------- periodic
    def _schedule_periodic(self) -> None:
        interval = self.policy.periodic_interval

        def tick() -> None:
            with self.executor.guard():
                self.policy.periodic()
            self.executor.defer(interval, tick)
        self.executor.defer(interval, tick)
