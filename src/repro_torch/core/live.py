"""Live-mode execution backend: the same SchedCore and Policy objects as
the simulator, driving real (device) work on worker threads.

The shared scheduling machinery lives in :mod:`repro_torch.core.base`
(:class:`~repro_torch.core.base.SchedCore`); this module contributes the
**thread** backend (DESIGN.md section 2):

* :class:`ThreadExecutor` -- one host worker thread per slot; jobs provide
  ``run_chunk(budget_s) -> "done" | "blocked" | "yield"`` executing one
  bounded chunk of real work (a training microbatch, a batched decode step,
  a prefill chunk).  Preemption is chunk-granular: a kick records a
  per-slot preempt request which long chunks may poll via
  :meth:`LiveKernel.preempt_requested`, and the scheduler simply does not
  re-dispatch background work while time-sensitive work is queued.
* :class:`LiveKernel` -- the live facade over :class:`SchedCore`
  (``start`` / ``stop`` / ``create_lock``).

Locks: :class:`LiveLock` is the engine-lock analogue of ``SimLock`` -- a
real ``threading.Lock`` instrumented with HintTable reporting, so the
priority-inversion machinery (boosting) works identically in live mode.
"""
from __future__ import annotations

import itertools
import threading
import time
import traceback
import warnings
from contextlib import contextmanager
from typing import Callable, ContextManager, Optional

from .base import Executor, Policy, SchedCore, Slot
from .hints import HintTable
from .metrics import Metrics
from .task import Job, JobState
from .trace import SchedTracer, bind_thread

_live_ids = itertools.count(1)


class LiveJob(Job):
    def __init__(self, group, run_chunk: Callable[[float], str],
                 name: str = "", kind: str = "live", retry_policy=None):
        super().__init__(group, behavior=None, name=name or f"live{next(_live_ids)}",
                         kind=kind, retry_policy=retry_policy)
        self._run_chunk = run_chunk


class ThreadExecutor(Executor):
    """Worker-thread backend: real wall-clock time, chunk-granular dispatch.

    The mutation guard is a re-entrant lock, so hint callbacks and nested
    lifecycle calls (enqueue -> kick -> ...) are safe from any thread --
    including worker threads already inside the guard.

    Two dispatch modes (DESIGN.md section 13):

    * ``"event"`` (default) -- per-slot :class:`threading.Event` parking with
      targeted wakeups: ``deliver_kick`` wakes only the kicked slot, and idle
      workers park indefinitely.  Enqueues that bypass the kick path (e.g. a
      direct enqueue onto a busy slot's DSQ) are covered by a bounded
      wake-scan on outermost guard exit, armed only when work was actually
      enqueued (``work_enqueued``), so an idle fleet never spins.
    * ``"polling"`` -- the legacy global condition variable with a
      ``wait(timeout=poll_interval)`` tick and ``notify_all`` on every guard
      exit (thundering herd).  Kept as the serving benchmark's pre-change
      baseline and as a conservative fallback.
    """

    def __init__(self, dispatch: str = "event",
                 poll_interval: float = 0.05) -> None:
        if dispatch not in ("event", "polling"):
            raise ValueError(f"dispatch must be 'event' or 'polling', "
                             f"got {dispatch!r}")
        self._t0 = time.monotonic()
        self._t0_ns = time.time_ns()             # wall clock beside _t0
        self._mu = threading.RLock()
        self._cond = threading.Condition(self._mu)   # polling-mode parking
        self._dispatch_mode = dispatch
        self._poll = poll_interval
        self._depth = 0                          # guard nesting (under _mu)
        self._stop = False
        self._started = False
        self._threads: list = []
        self._timers: list = []
        self._preempt: set[int] = set()          # sids with a pending preempt
        self._events: dict[int, threading.Event] = {}   # sid -> park event
        self._parked: set[int] = set()           # sids currently parked
        self._enq_count = 0                      # enqueues not yet serviced
                                                 # by a kick or wake-scan
        self._tl = threading.local()             # worker epilogue marker
        # Job-state settle watchers (engine shutdown path): its own small
        # lock so watchers never contend with the scheduling hot path.
        self._settle = threading.Condition(threading.Lock())
        self._settle_waiters = 0

    # ---------------------------------------------------- Executor protocol
    @property
    def now(self) -> float:
        return time.monotonic() - self._t0

    def defer(self, dt: float, fn: Callable[[], None]) -> None:
        if dt <= 0:
            fn()
            return
        handle: list = []
        t = threading.Timer(dt, self._fire_deferred, args=(fn, handle))
        handle.append(t)
        t.daemon = True
        with self._mu:
            if self._stop:
                return
            self._timers.append(t)
        t.start()

    def _fire_deferred(self, fn: Callable[[], None], handle: list) -> None:
        with self._mu:
            # Self-prune: a fired timer must not linger in _timers (they
            # used to accumulate until the next defer() swept them).
            if handle:
                try:
                    self._timers.remove(handle[0])
                except ValueError:
                    pass
            if self._stop:
                return
        fn()

    @contextmanager
    def _guard(self):
        with self._mu:
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
                if self._dispatch_mode == "polling":
                    self._cond.notify_all()
                elif self._depth == 0 and self._enq_count:
                    n, self._enq_count = self._enq_count, 0
                    self._wake_idle_workers(n)

    def guard(self) -> ContextManager:
        return self._guard()

    def work_enqueued(self, job) -> None:
        # Arms the guard-exit wake-scan: only actual enqueues wake parked
        # workers, so a worker re-parking (also a guard exit) cannot wake
        # itself in a spin loop.  Each unit is cancelled by the kick that
        # services it (deliver_kick), so the scan only covers kickless
        # enqueues -- the safety net, not the common path.
        self._enq_count += 1

    def _wake_idle_workers(self, n_armed: int) -> None:
        """Targeted wakeups on outermost guard exit after an enqueue: wake
        at most as many parked idle workers as there are unserviced
        enqueues (and never more than the policy has queued) -- no
        thundering herd, and none at all when the queues are empty.  Caller
        holds the mutation lock."""
        if self._stop or not self._parked:
            return
        n = min(n_armed, self.core.policy.queued_count())
        for sid in list(self._parked):
            if n <= 0:
                break
            slot = self.core.slots[sid]
            if slot.online and slot.current is None:
                evt = self._events.get(sid)
                if evt is not None and not evt.is_set():
                    evt.set()
                    n -= 1

    def deliver_kick(self, slot: Slot, preempt: bool) -> None:
        with self._mu:
            if preempt and slot.current is not None:
                self.core.metrics.preemptions += 1
                self.core.trace("preempt_slot", slot=slot.sid,
                                job=slot.current)
                self._preempt.add(slot.sid)
            if self._dispatch_mode == "polling":
                self._cond.notify_all()
            else:
                # This kick services one pending enqueue: the kicked slot
                # either unparks here or rescans at its next chunk
                # boundary, so the guard-exit wake-scan need not also fire.
                if self._enq_count:
                    self._enq_count -= 1
                if (not preempt and slot.current is None
                        and getattr(self._tl, "rescan_sid", None) == slot.sid):
                    # Redundant self-kick: a worker epilogue requeued work
                    # and the policy kicked the worker's own (momentarily
                    # idle) slot -- that worker rescans immediately after,
                    # so setting its event would only cause a futile
                    # park/unpark cycle on its next idle pass.
                    return
                evt = self._events.get(slot.sid)
                if evt is not None:
                    evt.set()                    # wake only the kicked slot

    def interrupt(self, slot: Slot) -> None:
        # Chunk-granular: the worker stops the job at the chunk boundary and
        # the policy (which only sees online slots) migrates it elsewhere.
        with self._mu:
            if slot.current is not None:
                self._preempt.add(slot.sid)
            if self._dispatch_mode == "polling":
                self._cond.notify_all()
            else:
                evt = self._events.get(slot.sid)
                if evt is not None:
                    evt.set()

    def slot_added(self, slot: Slot) -> None:
        with self._mu:
            self._events.setdefault(slot.sid, threading.Event())
            self._reap_threads_locked()
            if self._started and not self._stop:
                self._spawn_worker(slot)
            if self._dispatch_mode == "polling":
                self._cond.notify_all()

    def preempt_requested(self, slot: Slot) -> bool:
        """Chunk-granular preempt poll for long-running chunks."""
        return slot.sid in self._preempt

    # -------------------------------------------------------------- workers
    def start(self) -> None:
        with self._mu:
            self._started = True
            for slot in self.core.slots:
                self._events.setdefault(slot.sid, threading.Event())
                self._spawn_worker(slot)

    def _spawn_worker(self, slot: Slot) -> None:
        t = threading.Thread(target=self._worker, args=(slot,), daemon=True)
        self._threads.append(t)
        t.start()

    def _reap_threads_locked(self) -> None:
        # Exited workers (stopped executors, drained re-spawns) used to
        # accumulate here forever and get joined again on every stop.
        self._threads = [t for t in self._threads if t.is_alive()]

    def stop(self) -> None:
        with self._mu:
            self._stop = True
            for t in self._timers:
                t.cancel()
            self._timers.clear()
            self._cond.notify_all()
            for evt in self._events.values():
                evt.set()                        # unpark everyone to exit
            threads = list(self._threads)
        with self._settle:
            self._settle.notify_all()
        for t in threads:
            t.join(timeout=5.0)
        with self._mu:
            self._reap_threads_locked()

    def wait_job_settle(self, job, states=("blocked", "exited", "new"),
                        timeout: float = 2.0) -> str:
        """Block until ``job.state`` settles into one of ``states`` (or the
        executor stops / ``timeout`` lapses); returns the final state value.
        Event-driven replacement for busy-polling job state at shutdown:
        worker epilogues notify after every chunk's state transition."""
        deadline = time.monotonic() + timeout
        with self._settle:
            self._settle_waiters += 1
            try:
                while True:
                    state = job.state.value
                    if state in states or self._stop:
                        return state
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return state
                    self._settle.wait(remaining)
            finally:
                self._settle_waiters -= 1

    def _notify_settle(self) -> None:
        if self._settle_waiters:
            with self._settle:
                self._settle.notify_all()

    def _worker(self, slot: Slot) -> None:
        core = self.core
        evt = None
        with self._mu:
            evt = self._events.setdefault(slot.sid, threading.Event())
        while True:
            job = None
            park = False
            with self._guard():
                if self._stop:
                    return
                if slot.online:
                    core.schedule_next(slot)     # shared dispatch + start
                    job = slot.current
                if job is None:
                    if self._dispatch_mode == "polling":
                        self._cond.wait(timeout=self._poll)
                    else:
                        # Clear-then-park under the lock: any kick or
                        # enqueue serialized after this point re-sets the
                        # event, so the wait below can never miss a wakeup.
                        evt.clear()
                        self._parked.add(slot.sid)
                        park = True
                        if core._traced:
                            core.trace("park", slot=slot.sid)
                else:
                    self._preempt.discard(slot.sid)
                    budget = slot.slice_budget
                    runner = getattr(job, "_run_chunk", None) or job.run_chunk
            if job is None:
                if park:
                    t_park = time.monotonic()
                    evt.wait()                   # park until targeted wakeup
                    waited = time.monotonic() - t_park
                    with self._mu:
                        self._parked.discard(slot.sid)
                    if core._traced:
                        core.trace("unpark", slot=slot.sid, waited=waited)
                continue
            t0 = time.monotonic()
            err: Optional[BaseException] = None
            tb = ""
            traced = core._traced
            if traced:
                bind_thread(core.tracer)             # the chunk's spans
            try:
                status = runner(budget)              # real work, no lock held
            except Exception as e:                   # noqa: BLE001
                # A crashed chunk is a *panic*, not a completion: traced,
                # counted, locks force-released, retry policy applied.
                status = "panic"
                err, tb = e, traceback.format_exc()
            if traced:
                bind_thread(None)
            used = time.monotonic() - t0
            # Mark the epilogue window (thread-local): a requeue in here
            # often kicks this worker's own just-idled slot, and this
            # worker rescans immediately on loop-around, so deliver_kick
            # can skip setting our park event (see deliver_kick).
            self._tl.rescan_sid = slot.sid
            try:
                with self._guard():
                    core.stop_job(slot, used, reason=status)  # shared stop bookkeeping
                    self._preempt.discard(slot.sid)
                    if status == "panic":
                        core.panic_job(job, slot=slot, exc=err, trace_back=tb)
                    elif status == "done":
                        job.state = JobState.EXITED
                    elif status == "blocked":
                        job.state = JobState.BLOCKED
                    else:
                        core.requeue(job)
            finally:
                self._tl.rescan_sid = None
            self._notify_settle()


class LiveKernel(SchedCore):
    """Thread-based kernel: a thin facade over :class:`SchedCore` with a
    :class:`ThreadExecutor` backend.

    Shares one keyword signature with :class:`~repro_torch.core.kernel.SchedKernel`
    (``policy, n_slots, kick_latency, tracer, metrics, ...``) so
    :func:`repro_torch.core.build.build_kernel` is a thin mode switch; ``seed`` is
    accepted for signature parity and unused (real threads, real clock).
    The old positional form beyond ``(n_slots, policy)`` still works but
    warns.
    """

    _LEGACY_POSITIONAL = ("hints", "hints_enabled", "kick_latency")

    def __init__(self, n_slots: int, policy: Policy, *legacy,
                 hints: Optional[HintTable] = None,
                 metrics: Optional[Metrics] = None,
                 kick_latency: float = 0.0,
                 hints_enabled: bool = True,
                 seed: int = 0,
                 tracer: Optional[SchedTracer] = None,
                 dispatch: str = "event",
                 poll_interval: float = 0.05):
        if legacy:
            if len(legacy) > len(self._LEGACY_POSITIONAL):
                raise TypeError(
                    f"LiveKernel takes at most "
                    f"{2 + len(self._LEGACY_POSITIONAL)} positional arguments")
            warnings.warn(
                "positional LiveKernel arguments beyond (n_slots, policy) "
                "are deprecated; pass hints/hints_enabled/kick_latency by "
                "keyword (or use build_kernel)",
                DeprecationWarning, stacklevel=2)
            over = dict(zip(self._LEGACY_POSITIONAL, legacy))
            hints = over.get("hints", hints)
            hints_enabled = over.get("hints_enabled", hints_enabled)
            kick_latency = over.get("kick_latency", kick_latency)
        del seed                                   # parity-only, no sim RNG
        executor = ThreadExecutor(dispatch=dispatch,
                                  poll_interval=poll_interval)
        super().__init__(n_slots, policy, executor, hints=hints,
                         metrics=metrics, kick_latency=kick_latency,
                         hints_enabled=hints_enabled, tracer=tracer)
        if tracer is not None:
            # events are stamped with executor.now: spans take its zero
            tracer.set_anchor(executor._t0, executor._t0_ns)

    def start(self) -> None:
        self.executor.start()

    def stop(self) -> None:
        self.executor.stop()

    def create_lock(self, name: str = "") -> "LiveLock":
        return LiveLock(self, name)

    def preempt_requested(self, slot: Slot) -> bool:
        return self.executor.preempt_requested(slot)


class LiveLock:
    """Engine lock with hint instrumentation (LWLock analogue, live mode)."""

    _ids = itertools.count(10_000)

    def __init__(self, kernel: SchedCore, name: str = ""):
        self.lock_id = next(self._ids)
        self.name = name or f"livelock{self.lock_id}"
        self.kernel = kernel
        self._lock = threading.Lock()
        self.holder: Optional[Job] = None

    def acquire(self, job: Job, timeout: float = 30.0) -> bool:
        if not self._lock.acquire(blocking=False):
            holder = self.holder
            self.kernel.trace(
                "lock_wait", job=job, lock=self.name, lock_id=self.lock_id,
                holder=holder.name if holder else "",
                holder_jid=holder.jid if holder else -1)
            if self.kernel.hints_enabled:
                self.kernel.hints.report_wait_start(job, self.lock_id)
            ok = self._lock.acquire(timeout=timeout)
            if not ok:
                # Timed out: retract the wait entry, or the hint table
                # keeps boosting the holder on behalf of a waiter that
                # gave up long ago (unbounded priority inversion).
                self.kernel.trace("lock_timeout", job=job, lock=self.name,
                                  lock_id=self.lock_id)
                if self.kernel.hints_enabled:
                    self.kernel.hints.report_wait_end(job, self.lock_id)
                return False
        self.holder = job
        job.held_locks.add(self)
        self.kernel.trace("lock_acquire", job=job, lock=self.name,
                          lock_id=self.lock_id)
        if self.kernel.hints_enabled:
            self.kernel.hints.report_wait_end(job, self.lock_id)
            self.kernel.hints.report_lock_acquired(job, self.lock_id)
        return True

    def release(self, job: Job) -> None:
        if self.holder is not job:
            # Already force-released by the panic path (or never held):
            # releasing the raw threading.Lock again would raise in
            # whatever thread got here second.
            job.held_locks.discard(self)
            return
        self.holder = None
        job.held_locks.discard(self)
        self.kernel.trace("lock_release", job=job, lock=self.name,
                          lock_id=self.lock_id)
        if self.kernel.hints_enabled:
            self.kernel.hints.report_lock_released(job, self.lock_id)
        self._lock.release()
