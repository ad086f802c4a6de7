"""Instrumented engine locks (PostgreSQL LWLock / spinlock analogues).

Engine resources (KV-page allocator, parameter-publish stream, checkpoint
stream) are guarded by these locks. Every transition writes application
hints into the shared :class:`~repro_torch.core.hints.HintTable`, mirroring the
paper's instrumentation of PostgreSQL's wait-event reporting path
(pgstat_report_wait_start/end, paper section 5.2).

Two acquisition disciplines:

* **spin** (:func:`spin_acquire`, PostgreSQL spinlock): the poll consumes a
  short CPU burst, then sleeps with exponential backoff; release does *not*
  hand off -- waiters acquire at their next poll. A watchdog PANICs the job
  after ``PANIC_ATTEMPTS`` failed polls, reproducing PostgreSQL's stuck-
  spinlock PANIC (paper sections 2, 6.6). Crucially, a waiter that never
  gets CPU can never even poll -- which is exactly what Table 4 observes
  under FIFO.
* **sleep** (``AcquireLock`` phase, LWLock analogue): waiters park; release
  hands the lock to the first waiter.
"""
from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Iterator, Optional

from .task import Block, Burst, Job, PanicExit, TryLock

if TYPE_CHECKING:  # pragma: no cover
    from .base import SchedCore

_lock_ids = itertools.count(1)

# PostgreSQL s_lock-style backoff constants.
MIN_BACKOFF = 1e-3        # 1 ms
MAX_BACKOFF = 1.0         # 1 s
BACKOFF_GROWTH = 1.5
PANIC_ATTEMPTS = 1000     # stuck-spinlock watchdog
POLL_COST = 5e-6          # CPU cost of one spin/poll round


class SimLock:
    """A sim-mode engine lock, created via ``kernel.create_lock``."""

    def __init__(self, kernel: "SchedCore", name: str = ""):
        self.lock_id = next(_lock_ids)
        self.name = name or f"lock{self.lock_id}"
        self.kernel = kernel
        self.holder: Optional[Job] = None
        self.parked: list[Job] = []                # sleep-discipline waiters
        self.acquired_at: dict[int, float] = {}    # jid -> acquisition time (metrics)

    # ------------------------------------------------------------------
    def try_acquire(self, job: Job) -> bool:
        if self.holder is None:
            self._grant(job)
            return True
        self.kernel.trace("lock_wait", job=job, lock=self.name,
                          lock_id=self.lock_id, holder=self.holder.name,
                          holder_jid=self.holder.jid)
        if self.kernel.hints_enabled:
            self.kernel.hints.report_wait_start(job, self.lock_id)
        return False

    def _grant(self, job: Job) -> None:
        self.holder = job
        job.held_locks.add(self)
        self.acquired_at[job.jid] = self.kernel.now
        self.kernel.trace("lock_acquire", job=job, lock=self.name,
                          lock_id=self.lock_id)
        if self.kernel.hints_enabled:
            self.kernel.hints.report_wait_end(job, self.lock_id)
            self.kernel.hints.report_lock_acquired(job, self.lock_id)

    def park(self, job: Job) -> None:
        self.parked.append(job)

    def release(self, job: Job) -> Optional[Job]:
        """Release; returns a parked waiter granted ownership (sleep
        discipline), or None (spin waiters re-poll on their own)."""
        assert self.holder is job, f"{job} releasing {self.name} it does not hold"
        self.holder = None
        job.held_locks.discard(self)
        self.kernel.trace("lock_release", job=job, lock=self.name,
                          lock_id=self.lock_id)
        if self.kernel.hints_enabled:
            self.kernel.hints.report_lock_released(job, self.lock_id)
        if self.parked:
            nxt = self.parked.pop(0)
            self._grant(nxt)
            return nxt
        return None


def spin_acquire(lock: SimLock, poll_cost: float = POLL_COST,
                 panic_attempts: int = PANIC_ATTEMPTS) -> Iterator:
    """Generator fragment (``yield from spin_acquire(lock)``) implementing
    PostgreSQL spinlock acquisition under the phase protocol."""
    attempts = 0
    backoff = 0.0
    while True:
        yield Burst(poll_cost)            # the poll itself needs the CPU
        got = yield TryLock(lock)
        if got:
            return
        attempts += 1
        if attempts >= panic_attempts:
            yield PanicExit()
            return
        backoff = MIN_BACKOFF if backoff == 0.0 else min(backoff * BACKOFF_GROWTH, MAX_BACKOFF)
        yield Block(backoff)
