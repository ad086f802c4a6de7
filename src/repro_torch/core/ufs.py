"""UFS -- the selectively unfair scheduler (paper sections 4 and 5).

Two tiers with strict precedence:

* **time-sensitive**: *direct-to-slot enqueue* -- pick a slot that can run the
  job promptly (idle, or running background work -> preemption kick), insert
  into its local DSQ ordered by task vruntime;
* **background**: *group-queue enqueue* -- push onto the job's group DSQ and
  register the group in the runnable tree; idle slots *pull* work on demand
  via the dispatch callback (deferred, reactive load distribution).

Weight-proportional sharing within each tier comes from two-level
weight-scaled virtual runtime (``repro_torch.core.vruntime``); priority-inversion
avoidance from hint-driven boosting (``repro_torch.core.hints``), which temporarily
treats a background lock holder as time-sensitive until it releases the lock.
"""
from __future__ import annotations

from typing import Optional

from . import vruntime as vrt
from .base import Policy, Slot
from .runnable_tree import RunnableTree
from .task import Job, JobState, Tier, WorkloadGroup

MAX_DISPATCH_RETRIES = 8   # bounded loop, eBPF-verifier style (paper 5.1.3)
UFS_SLICE = 0.0015         # bounded execution interval (matches Table 3 latencies)


class UFSPolicy(Policy):
    name = "ufs"

    def __init__(self, slice_s: float = UFS_SLICE):
        self.slice_s = slice_s
        self.tree = RunnableTree()
        self._rr_cursor = 0      # round-robin start for idle-slot scans

    # ------------------------------------------------------------------
    def task_slice(self, job: Job) -> float:
        return self.slice_s

    # ------------------------------------------------------------- enqueue
    def enqueue(self, job: Job, requeue: bool = False) -> None:
        """sched_ext ``enqueue``: state lookup, vruntime clamp, then
        direct-to-slot (TS) or group-queue (BG) insertion (paper 5.1.2)."""
        group = job.group
        if not requeue:
            # Clamp credit hoarding on wakeup only: a requeued (still-active)
            # task keeps its earned position (paper 5.1.2 targets tasks
            # "idle for a long time").
            vrt.clamp_task_vruntime(job, self.slice_s)
        if job.tier == Tier.TIME_SENSITIVE:
            self._enqueue_direct(job)
        else:
            self._enqueue_group(job, group)

    def _enqueue_direct(self, job: Job) -> None:
        kernel = self.kernel
        slot, preempt = self._select_slot(job)
        slot.local_dsq.push(job, job.vruntime)
        job.location = ("local", slot)
        if slot.current is None:
            kernel.kick(slot, preempt=False)            # wake the idle slot
        elif preempt:
            kernel.kick(slot, preempt=True)             # preemption kick
        # else: other TS work is running; vruntime decides queue position.

    def _select_slot(self, job: Job) -> tuple:
        """Direct-to-CPU placement: prefer the previous slot if it can run the
        job promptly, else any idle slot, else any slot running background
        work (kick), else the least TS-loaded slot. Round-robin scan start
        balances placement from the beginning (paper section 4)."""
        kernel = self.kernel
        slots = kernel.online_slots()
        if job.pinned_slot is not None:
            slot = kernel.slots[job.pinned_slot]
            preempt = slot.current is not None and slot.current.tier == Tier.BACKGROUND
            return slot, preempt
        affinity = job.group.slot_affinity
        if affinity is not None:
            allowed = [s for s in slots if s.sid in affinity]
            if allowed:
                slots = allowed
            else:
                # The affinity mask matches no online slot (drained away or
                # misconfigured): fall back to the full online set rather
                # than crash the placement path.
                affinity = None
        # 1. previous slot, if idle or running background work.
        prev = kernel.slots[job.prev_slot] if 0 <= job.prev_slot < len(kernel.slots) else None
        if prev is not None and prev.online and (affinity is None or prev.sid in affinity):
            if prev.current is None and len(prev.local_dsq) == 0:
                return prev, False
            if prev.current is not None and prev.current.tier == Tier.BACKGROUND:
                return prev, True
        # 2. any idle slot (rotating scan start avoids stacking).
        n = len(slots)
        for i in range(n):
            s = slots[(self._rr_cursor + i) % n]
            if s.current is None and len(s.local_dsq) == 0:
                self._rr_cursor = (self._rr_cursor + i + 1) % n
                return s, False
        # 3. any slot running background work -> preempt it.
        for i in range(n):
            s = slots[(self._rr_cursor + i) % n]
            if s.current is not None and s.current.tier == Tier.BACKGROUND:
                self._rr_cursor = (self._rr_cursor + i + 1) % n
                return s, True
        # 4. all slots busy with TS work: least-loaded local DSQ.
        best = min(slots, key=lambda s: (len(s.local_dsq), s.sid))
        return best, False

    def _enqueue_group(self, job: Job, group: WorkloadGroup) -> None:
        group.dsq.push(job, job.vruntime)
        job.location = ("group", group)
        if group not in self.tree:
            # Clamp stale credit only for groups that were *genuinely* idle;
            # a group whose single task just round-tripped through a slice
            # keeps its earned (weight-proportional) position.
            if self.kernel.now - group.last_active > 2 * self.slice_s:
                vrt.clamp_group_vruntime(group, self.tree.min_vruntime(),
                                         self.slice_s)
            self.tree.insert(group)
        # A BG arrival never preempts, but an *idle* slot should pull now.
        for slot in self.kernel.online_slots():
            if slot.idle:
                self.kernel.kick(slot, preempt=False)
                break

    # ------------------------------------------------------------- dispatch
    def dispatch(self, slot: Slot) -> None:
        """Slot's local DSQ is empty -> no time-sensitive work needs it; pull
        the least-served background group's least-served task (paper 5.1.3)."""
        for _ in range(MAX_DISPATCH_RETRIES):
            group = self.tree.peek_min()
            if group is None:
                return
            if len(group.dsq) == 0:
                self.tree.remove(group)      # empty -> stash bookkeeping node
                continue
            if not self._eligible(group, slot):
                # Rate-capped or affinity-excluded group: charge and rotate.
                self.tree.remove(group)
                vrt.charge_group(group, self.slice_s)
                self.tree.insert(group)
                continue
            job = group.dsq.pop_front()
            if job.state != JobState.RUNNABLE:   # vanished (exited/boosted away)
                continue
            job.location = None
            slot.local_dsq.push(job, job.vruntime)
            vrt.charge_group(group, self.slice_s)
            group.last_active = self.kernel.now
            self.tree.remove(group)
            if len(group.dsq) > 0:
                self.tree.insert(group)          # re-key by updated vruntime
            return

    def _eligible(self, group: WorkloadGroup, slot: Slot) -> bool:
        if group.slot_affinity is not None and slot.sid not in group.slot_affinity:
            return False
        if group.rate_cap is not None:
            elapsed = max(self.kernel.now, 1e-9)
            capacity = elapsed * len(self.kernel.online_slots())
            if group.usage_time >= group.rate_cap * capacity:
                return False
        return True

    # ------------------------------------------------------------- charging
    def stopping(self, job: Job, slot: Slot, used: float) -> None:
        vdelta = vrt.charge_task(job, used)
        job.last_ran = self.kernel.now
        group = job.sched_group()
        if job.vruntime > group.task_vmax:
            # Task-level watermark: the clamp reference for re-entering
            # tasks. Weight-scaled task vruntimes are directly comparable
            # across groups, which yields weight-proportional sharing within
            # the TS tier (Figure 8) without tree dispatch.
            group.task_vmax = job.vruntime
        if group.tier == Tier.TIME_SENSITIVE:
            group.vruntime += vdelta              # service accounting/metrics

    # ------------------------------------------------------------- boosting
    def on_boost(self, job: Job) -> None:
        """A background lock holder was boosted into the TS tier: enter at
        the inherited group's current vruntime level (no stale credit, no
        stale debt from the background scale) and, if queued in its group
        DSQ, move to the direct-to-slot path immediately."""
        if job.boost_group is not None:
            job.vruntime = job.boost_group.task_vmax
        if job.state != JobState.RUNNABLE or job.location is None:
            return
        kind, ref = job.location
        if kind == "group":
            ref.dsq.remove(job)
            job.location = None
            self._enqueue_direct(job)
        # if already on a local DSQ or running, tier change suffices.

    def on_unboost(self, job: Job) -> None:
        """Boost expired (lock released): demote a queued job back to the
        background path so it does not keep borrowed priority."""
        job.vruntime = job.group.task_vmax     # re-baseline on the BG scale
        if job.state != JobState.RUNNABLE or job.location is None:
            return
        kind, ref = job.location
        if kind == "local":
            ref.local_dsq.remove(job)
            job.location = None
            self._enqueue_group(job, job.group)
