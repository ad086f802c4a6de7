"""RT baseline: SCHED_FIFO / SCHED_RR analogue (paper sections 2, 3, 6.6).

Time-sensitive-tier jobs are real-time (priority 99); background-tier jobs
fall into an embedded fair (normal) class below them, exactly like the
paper's Table 2 configurations (FIFO/RR prio 99 + NORMAL weight 1).

Modelled mechanisms:

* **per-slot RT runqueues** (as in Linux): a waking RT task goes to its
  previous CPU if it can preempt the current task (lower class), else
  ``find_lowest_rq`` (an idle slot, then one running fair-class work),
  else it queues on its previous slot behind the same-priority runner --
  under FIFO that runner never yields, which is the 50:50 collapse;
* **pull balancing**: a slot that runs out of RT work pulls a queued
  (pushable) RT task from an overloaded slot -- keeps MIN:MAX healthy;
* FIFO: runnable RT task runs until it blocks (infinite slice); RR: 100 ms
  quanta (Linux RR_TIMESLICE default), expired tasks requeue at the tail --
  a bursty task that blocks early loses the remainder of its turn and then
  waits out its neighbour's full quantum, the failure the paper shows;
* no virtual-runtime accounting inside the RT class (the paper's point);
* **RT throttling / fair server**: the normal class is guaranteed ~5% of
  each slot-second (Linux sched_rt_runtime_us = 950000/1000000): when a
  slot's RT usage reaches 95% of the 1 s window and fair work is runnable,
  the slot serves the fair class for the rest of the window. This is what
  lets the lock-holding background task limp forward in Table 4 and what
  puts the occasional ~tens-of-ms spike in the RT tail latencies.
"""
from __future__ import annotations

import itertools

from ..base import Policy, Slot
from ..dsq import GroupDSQ
from ..task import Job, JobState, Tier
from ..vruntime import WEIGHT_SCALE

FAIR_SLICE = 0.003
RT_WINDOW = 1.0               # throttling window
RT_RUNTIME_FRAC = 0.95        # RT may use 95% of each window
FAIR_BUDGET = 0.05            # fair-server budget per window (~5%)


class RTPolicy(Policy):
    """quantum=None -> SCHED_FIFO; quantum=0.1 -> SCHED_RR."""

    def __init__(self, quantum=None):
        self.quantum = quantum
        self.name = "fifo" if quantum is None else "rr"
        # Per-instance FIFO sequence: two kernels built in one process must
        # observe identical tie-break sequences (was a module global).
        self._seq = itertools.count()
        self.fair_queue = GroupDSQ()          # global fair rq, keyed by vruntime
        self.fair_vmin = 0.0
        self.rt_since: dict[int, float] = {}  # sid -> RT usage since last fair grant
        # sid -> fair-server window end: policy-private per-slot state (was a
        # field bolted onto Slot; the core's Slot is now policy-agnostic).
        self.fair_until: dict[int, float] = {}

    # ------------------------------------------------------------------
    def queued_count(self) -> int:
        # The global fair rq is policy-private state the generic scan
        # (local + group DSQs) cannot see.
        return super().queued_count() + len(self.fair_queue)

    def _is_rt(self, job: Job) -> bool:
        return job.tier == Tier.TIME_SENSITIVE

    def _allowed(self, job: Job, slot: Slot) -> bool:
        if job.pinned_slot is not None and job.pinned_slot != slot.sid:
            return False
        aff = job.group.slot_affinity
        return aff is None or slot.sid in aff

    def _fair_served_until(self, slot: Slot) -> float:
        return self.fair_until.get(slot.sid, 0.0)

    def task_slice(self, job: Job) -> float:
        if self._is_rt(job):
            # FIFO has no quantum; the 10 ms re-arm is the scheduler tick
            # (the task requeues at the *front*, so it runs to block), and it
            # is what gives RT-throttling its per-tick accounting.
            return self.quantum if self.quantum is not None else 0.010
        return FAIR_SLICE

    # --------------------------------------------------------------- enqueue
    def enqueue(self, job: Job, requeue: bool = False) -> None:
        if self._is_rt(job):
            self._enqueue_rt(job, requeue)
        else:
            self._enqueue_fair(job, requeue)

    def _enqueue_rt(self, job: Job, requeue: bool) -> None:
        kernel = self.kernel
        if requeue:
            slot = kernel.slots[job.prev_slot]
            if not slot.online:
                slot = self._find_lowest_rq(job) or kernel.online_slots()[0]
            if self.quantum is None:
                # FIFO: a preempted task resumes ahead of its queue.
                slot.local_dsq.push(job, -float(next(self._seq)))
            else:
                # RR: expired quantum -> tail of its slot's queue.
                slot.local_dsq.push(job, float(next(self._seq)))
            job.location = ("local", slot)
            if slot.current is None:
                kernel.kick(slot, preempt=False)
            return
        # Wakeup path: select_task_rq_rt analogue.
        prev = kernel.slots[job.prev_slot] if 0 <= job.prev_slot < len(kernel.slots) else None
        slot = None
        preempt = False
        if (prev is not None and prev.online and self._allowed(job, prev)
                and (prev.current is None or
                     (not self._is_rt(prev.current)
                      and kernel.now >= self._fair_served_until(prev)))):
            slot = prev
            preempt = prev.current is not None
        else:
            slot = self._find_lowest_rq(job)
            preempt = slot is not None and slot.current is not None
        if slot is None:
            # Everyone runs same-priority RT: stay on prev (or any allowed).
            slot = prev if prev is not None and prev.online and self._allowed(job, prev) \
                else next(s for s in kernel.online_slots() if self._allowed(job, s))
            preempt = False
        slot.local_dsq.push(job, float(next(self._seq)))
        job.location = ("local", slot)
        if slot.current is None:
            kernel.kick(slot, preempt=False)
        elif preempt:
            kernel.kick(slot, preempt=True)

    def _find_lowest_rq(self, job: Job):
        """cpupri analogue: an idle slot, else one running fair-class work
        (not inside a fair-server window)."""
        kernel = self.kernel
        for s in kernel.online_slots():
            if s.current is None and self._allowed(job, s):
                return s
        for s in kernel.online_slots():
            cur = s.current
            if (cur is not None and not self._is_rt(cur) and self._allowed(job, s)
                    and kernel.now >= self._fair_served_until(s)):
                return s
        return None

    def _enqueue_fair(self, job: Job, requeue: bool) -> None:
        kernel = self.kernel
        floor = self.fair_vmin - FAIR_SLICE * WEIGHT_SCALE
        if not requeue and job.vruntime < floor:
            job.vruntime = floor
        self.fair_queue.push(job, job.vruntime)
        job.location = ("fair", self)
        for slot in kernel.online_slots():
            if slot.idle and self._allowed(job, slot):
                kernel.kick(slot, preempt=False)
                return
        self._maybe_fair_serve()

    # -------------------------------------------------------------- dispatch
    def pick_next(self, slot: Slot):
        """During a fair-server window the slot serves the fair class first."""
        if self.kernel.now < self._fair_served_until(slot):
            job = slot.local_dsq.pop_first_where(
                lambda j: not self._is_rt(j) and j.state == JobState.RUNNABLE)
            if job is None:
                job = self.fair_queue.pop_first_where(
                    lambda j: j.state == JobState.RUNNABLE and self._allowed(j, slot))
            if job is not None:
                job.location = None
                return job
        return super().pick_next(slot)

    def dispatch(self, slot: Slot) -> None:
        kernel = self.kernel
        serving_fair = kernel.now < self._fair_served_until(slot)
        if not serving_fair:
            # pull_rt_task analogue: steal a queued, pushable RT task from an
            # overloaded slot before dropping to fair work.
            for other in kernel.online_slots():
                if other is slot or len(other.local_dsq) == 0:
                    continue
                if other.current is not None and any(
                        self._is_rt(j) for j in other.local_dsq.jobs()):
                    job = other.local_dsq.pop_first_where(
                        lambda j: (self._is_rt(j) and j.pinned_slot is None
                                   and j.state == JobState.RUNNABLE
                                   and self._allowed(j, slot)))
                    if job is not None:
                        job.prev_slot = slot.sid
                        slot.local_dsq.push(job, float(next(self._seq)))
                        job.location = ("local", slot)
                        kernel.metrics.lb_migrations += 1
                        return
        job = self.fair_queue.pop_first_where(
            lambda j: j.state == JobState.RUNNABLE and self._allowed(j, slot))
        if job is not None:
            slot.local_dsq.push(job, float("inf"))   # fair work sorts last
            job.location = ("local", slot)

    # ------------------------------------------------------------- charging
    def running(self, job: Job, slot: Slot) -> None:
        if not self._is_rt(job) and self.kernel.now < self._fair_served_until(slot):
            slot.slice_budget = min(slot.slice_budget,
                                    max(self._fair_served_until(slot) - self.kernel.now, 1e-4))

    def stopping(self, job: Job, slot: Slot, used: float) -> None:
        job.total_cpu += used
        job.group.usage_time += used
        job.last_ran = self.kernel.now
        if self._is_rt(job):
            self._account_rt(slot, used)
        else:
            job.vruntime += used * (WEIGHT_SCALE / max(job.group.effective_weight(), 1e-9))
            if job.vruntime > self.fair_vmin:
                self.fair_vmin = job.vruntime

    # ------------------------------------------------------- RT throttling
    def _account_rt(self, slot: Slot, used: float) -> None:
        """Rolling RT bandwidth control: once a slot has accumulated 95% of
        a window's worth of RT runtime since the last fair-server grant, it
        owes the fair class its 5% -- open a 50 ms grant if fair work is
        starved (Linux sched_rt_runtime_us / DL-server semantics)."""
        self.rt_since[slot.sid] = self.rt_since.get(slot.sid, 0.0) + used
        self._check_grant(slot)

    def _check_grant(self, slot: Slot) -> bool:
        if self.rt_since.get(slot.sid, 0.0) < RT_RUNTIME_FRAC * RT_WINDOW:
            return False
        if self.kernel.now < self._fair_served_until(slot):
            return False
        if not any(j.state == JobState.RUNNABLE and self._allowed(j, slot)
                   for j in self.fair_queue.jobs()):
            return False
        self.rt_since[slot.sid] = 0.0
        self.fair_until[slot.sid] = self.kernel.now + FAIR_BUDGET
        return True

    def _maybe_fair_serve(self) -> None:
        """A fair task became runnable with every slot saturated by RT:
        grant immediately on any slot that already owes the fair class."""
        for slot in self.kernel.online_slots():
            if self._check_grant(slot):
                if slot.current is not None and self._is_rt(slot.current):
                    self.kernel.kick(slot, preempt=True)
                return
