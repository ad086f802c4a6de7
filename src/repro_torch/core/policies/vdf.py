"""VDF -- the EEVDF baseline analogue (paper sections 2, 3).

Faithfully models the mechanisms the paper identifies as EEVDF's failure
modes under mixed database workloads:

* **per-slot runqueues** ordered by *virtual deadline*
  (``vdeadline = vruntime + slice / weight``), weight-scaled charging,
  sleeper-credit clamping at wakeup;
* **run-to-parity**: a waking task does not preempt the current task; it
  waits for the current slice to finish (EEVDF's RUN_TO_PARITY default).
  Only idle-class current tasks are preempted immediately (see IdlePolicy);
* **wakeup placement**: previous slot if idle, else a *deterministic*
  idle-sibling scan from slot 0, else fall back to the previous slot. Since
  background work keeps most slots busy, bursty tasks repeatedly land on the
  few slots another bursty task just vacated -> pile-ups (paper Figure 2);
* **gated newidle balancing**: a slot going idle pulls queued work from the
  busiest runqueue *only if* its average idle period exceeds the migration
  cost -- bursty tasks' sub-millisecond sleeps fail the gate, so pile-ups
  are not corrected at idle time;
* **periodic load balancing** every ``lb_interval`` using PELT-style
  decaying per-slot load averages; migrates one *queued* task that is not
  cache-hot (ran within MIGRATION_COST) from the most- to the least-loaded
  runqueue. Because bursty tasks are queued only briefly (and are usually
  cache-hot when they are), the periodic balancer mostly evacuates the
  long-queued low-weight background tasks -- which is exactly what empties
  bursty slots and feeds the placement pathology, while only *eventually*
  correcting bursty pile-ups (paper: "By the time load-balancing kicks in,
  throughput has already been impacted").
"""
from __future__ import annotations

from ..kernel import Policy, Slot
from ..task import Job, JobState
from ..vruntime import WEIGHT_SCALE

BASE_SLICE = 0.0015          # EEVDF base slice analogue
SLEEPER_CREDIT = 0.0015      # wakeup vruntime clamp (sched_latency analogue)
MIGRATION_COST = 0.0005      # newidle gate + cache-hot filter (0.5 ms)
LB_INTERVAL = 0.008          # periodic load-balance cadence
PELT_DECAY = 0.6             # per-tick decay of the load average


class VDFPolicy(Policy):
    name = "vdf"
    periodic_interval = LB_INTERVAL

    def __init__(self, base_slice: float = BASE_SLICE):
        self.base_slice = base_slice
        self.rq_vmin: dict[int, float] = {}
        self.idle_ewma: dict[int, float] = {}
        self.idle_since: dict[int, float] = {}
        self.load_avg: dict[int, float] = {}     # PELT-style slot load
        self.util_avg: dict[int, float] = {}     # PELT-style slot utilization
        self.win_wsec: dict[int, float] = {}     # weight-seconds this LB window
        self.win_busy: dict[int, float] = {}     # busy-seconds this LB window
        self._fallback_cursor = 0
        self._lb_fails = 0                       # active-balance escalation

    # ------------------------------------------------------------------
    def task_slice(self, job: Job) -> float:
        return self.base_slice

    def _weight(self, job: Job) -> float:
        return max(job.group.effective_weight(), 1e-9)

    def _deadline(self, job: Job) -> float:
        return job.vruntime + self.base_slice * (WEIGHT_SCALE / self._weight(job))

    def _preempts(self, new: Job, cur: Job) -> bool:
        return False          # RUN_TO_PARITY: wait for the current slice

    # --------------------------------------------------------------- enqueue
    def enqueue(self, job: Job, requeue: bool = False) -> None:
        kernel = self.kernel
        if requeue and kernel.slots[job.prev_slot].online:
            # Slice expiry / preemption: stay on the current runqueue.
            slot = kernel.slots[job.prev_slot]
        else:
            slot = self._place(job)
            # Sleeper credit: clamp vruntime near the rq's min (CFS-style,
            # unscaled constant credit).
            floor = self.rq_vmin.get(slot.sid, 0.0) - SLEEPER_CREDIT
            if job.vruntime < floor:
                job.vruntime = floor
        job.vdeadline = self._deadline(job)
        slot.local_dsq.push(job, job.vdeadline)
        job.location = ("local", slot)
        if slot.current is None:
            kernel.kick(slot, preempt=False)
        elif not requeue and self._preempts(job, slot.current):
            kernel.kick(slot, preempt=True)

    def _place(self, job: Job) -> Slot:
        """EEVDF wakeup placement (see module docstring).

        1. previous slot if idle (wake_affine_idle);
        2. wake-affine: wakeups delivered by another slot (the network-RX
           IRQ slot, for TPC-C-over-TCP backends) pull the wakee toward the
           waker's slot when it is not overloaded;
        3. deterministic idle-sibling scan from the target;
        4. fall back to the target (queue there).
        Steps 2-4 are what stack bursty tasks onto the few briefly-idle
        slots (paper Figure 2's staircase).
        """
        kernel = self.kernel
        slots = kernel.online_slots()
        if job.pinned_slot is not None:
            return kernel.slots[job.pinned_slot]
        prev = kernel.slots[job.prev_slot] if 0 <= job.prev_slot < len(kernel.slots) else None
        if prev is not None and prev.online and prev.idle:
            return prev
        target = prev
        if job.waker_slot is not None:
            waker = kernel.slots[job.waker_slot]
            # wake_affine: pull toward the waker's slot only when it is no
            # more loaded than prev (CFS compares load averages).
            if (waker.online and len(waker.local_dsq) == 0
                    and (prev is None or self.load_avg.get(waker.sid, 0.0)
                         <= self.load_avg.get(prev.sid, 0.0))):
                target = waker
        # Deterministic idle-sibling scan from the target slot. SIS_UTIL:
        # scan depth shrinks with average utilization -- under a saturating
        # background load the scan is skipped entirely and wakeups fall back
        # to the target, stacking bursty tasks (paper Figure 2).
        start = target.sid if target is not None else 0
        n = len(kernel.slots)
        avg_util = (sum(self.util_avg.get(s.sid, 0.0) for s in slots)
                    / max(len(slots), 1))
        depth = min(n, int(round(n * max(0.0, 1.0 - avg_util) * 1.5)))
        for i in range(depth):
            s = kernel.slots[(start + i) % n]
            if s.online and self._scan_idle(s):
                return s
        # Scan failed: fall back to the target slot (queue there).
        if target is not None and target.online:
            return target
        if prev is not None and prev.online:
            return prev
        # No previous slot (fork/exec placement): least-loaded, rotating ties.
        n = len(slots)
        self._fallback_cursor = (self._fallback_cursor + 1) % n
        order = slots[self._fallback_cursor:] + slots[:self._fallback_cursor]
        return min(order, key=lambda s: self.load_avg.get(s.sid, 0.0))

    def _scan_idle(self, slot: Slot) -> bool:
        """Does the idle-sibling scan consider this slot idle?"""
        return slot.idle

    # -------------------------------------------------------------- dispatch
    def dispatch(self, slot: Slot) -> None:
        """Local rq empty -> newidle balance, gated on average idle period."""
        now = self.kernel.now
        if self.idle_ewma.get(slot.sid, 1.0) >= MIGRATION_COST:
            busiest = max((s for s in self.kernel.online_slots() if s is not slot),
                          key=lambda s: len(s.local_dsq), default=None)
            if busiest is not None and len(busiest.local_dsq) > 0:
                job = self._detach_one(busiest)
                if job is not None:
                    self.kernel.metrics.lb_migrations += 1
                    job.prev_slot = slot.sid
                    slot.local_dsq.push(job, job.vdeadline)
                    job.location = ("local", slot)
                    return
        self.idle_since[slot.sid] = now

    def _detach_one(self, rq: Slot):
        """Pick a migratable queued task: not pinned, runnable, not cache-hot."""
        now = self.kernel.now
        return rq.local_dsq.pop_first_where(
            lambda j: (j.pinned_slot is None and j.state == JobState.RUNNABLE
                       and now - getattr(j, "last_ran", -1.0) >= MIGRATION_COST))

    def running(self, job: Job, slot: Slot) -> None:
        start = self.idle_since.pop(slot.sid, None)
        if start is not None:
            dur = self.kernel.now - start
            prev = self.idle_ewma.get(slot.sid, 1.0)
            self.idle_ewma[slot.sid] = 0.75 * prev + 0.25 * dur

    def stopping(self, job: Job, slot: Slot, used: float) -> None:
        job.vruntime += used * (WEIGHT_SCALE / self._weight(job))
        job.total_cpu += used
        job.group.usage_time += used
        job.last_ran = self.kernel.now
        self.win_wsec[slot.sid] = self.win_wsec.get(slot.sid, 0.0) + self._weight(job) * used
        self.win_busy[slot.sid] = self.win_busy.get(slot.sid, 0.0) + used
        vmin = self.rq_vmin.get(slot.sid, 0.0)
        if job.vruntime > vmin:
            self.rq_vmin[slot.sid] = job.vruntime

    # -------------------------------------------------------------- periodic
    def periodic(self) -> None:
        """Update PELT loads; move one cold queued task busiest -> idlest."""
        slots = self.kernel.online_slots()
        for s in slots:
            w = self.win_wsec.pop(s.sid, 0.0) / LB_INTERVAL
            self.load_avg[s.sid] = PELT_DECAY * self.load_avg.get(s.sid, 0.0) \
                + (1.0 - PELT_DECAY) * w
            b = min(1.0, self.win_busy.pop(s.sid, 0.0) / LB_INTERVAL)
            self.util_avg[s.sid] = PELT_DECAY * self.util_avg.get(s.sid, 0.0) \
                + (1.0 - PELT_DECAY) * b
        if len(slots) < 2:
            return
        busiest = max(slots, key=lambda s: self.load_avg.get(s.sid, 0.0))
        idlest = min(slots, key=lambda s: self.load_avg.get(s.sid, 0.0))
        if busiest is idlest or len(busiest.local_dsq) == 0:
            return
        if self.load_avg.get(busiest.sid, 0.0) <= 1.25 * self.load_avg.get(idlest.sid, 0.0):
            return
        job = self._detach_one(busiest)
        if job is None:
            # active balance: after repeated failures, migrate even a
            # cache-hot queued task (CFS nr_balance_failed escalation).
            self._lb_fails += 1
            if self._lb_fails < 3:
                return
            job = busiest.local_dsq.pop_first_where(
                lambda j: j.pinned_slot is None and j.state == JobState.RUNNABLE)
            if job is None:
                return
        self._lb_fails = 0
        self.kernel.metrics.lb_migrations += 1
        job.prev_slot = idlest.sid
        job.vdeadline = self._deadline(job)
        idlest.local_dsq.push(job, job.vdeadline)
        job.location = ("local", idlest)
        if idlest.current is None:
            self.kernel.kick(idlest, preempt=False)
