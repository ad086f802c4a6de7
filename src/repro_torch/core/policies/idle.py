"""IDLE baseline: SCHED_IDLE analogue for background work on top of VDF.

Background-tier jobs run with the idle-class weight (3, as in CFS's
WEIGHT_IDLEPRIO), sort after every normal job on their runqueue, and never
trigger wakeup preemption. The paper observes that this configuration shares
EEVDF's placement pathology -- which it does here by construction, since the
placement path is inherited unchanged.
"""
from __future__ import annotations

from ..task import Job, Tier
from ..vruntime import WEIGHT_SCALE
from .vdf import VDFPolicy

IDLE_WEIGHT = 3.0
IDLE_KEY_OFFSET = 1e12   # idle-class jobs sort after all normal jobs


class IdlePolicy(VDFPolicy):
    name = "idle"

    def _is_idle_class(self, job: Job) -> bool:
        return job.group.tier == Tier.BACKGROUND and not job.boosted

    def _weight(self, job: Job) -> float:
        if self._is_idle_class(job):
            return IDLE_WEIGHT
        return super()._weight(job)

    def _deadline(self, job: Job) -> float:
        d = job.vruntime + self.base_slice * (WEIGHT_SCALE / self._weight(job))
        if self._is_idle_class(job):
            d += IDLE_KEY_OFFSET
        return d

    def _preempts(self, new: Job, cur: Job) -> bool:
        if self._is_idle_class(new):
            return False                      # idle class never preempts
        if self._is_idle_class(cur):
            return True                       # any normal task preempts idle
        return super()._preempts(new, cur)

    def _scan_idle(self, slot) -> bool:
        """sched_idle_cpu(): a slot running only idle-class work counts as
        idle for wakeup placement -- which funnels every waking bursty task
        toward the same idle-class slots and stacks them (the paper finds
        IDLE shares EEVDF's failure mode)."""
        if slot.idle:
            return True
        cur = slot.current
        if cur is None or not self._is_idle_class(cur):
            return False
        return all(self._is_idle_class(j) for j in slot.local_dsq.jobs())
