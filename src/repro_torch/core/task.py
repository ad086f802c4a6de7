"""Schedulable entities: jobs, workload groups (cgroup analogue), tiers.

Maps the paper's vocabulary onto the accelerator adaptation (DESIGN.md section 2):

* ``Tier``            -- the two UFS scheduling tiers (time-sensitive / background).
* ``WorkloadGroup``   -- cgroup analogue: hierarchical, weighted, with optional
                         rate caps (``cpu.max``) and slot affinity (``cpuset``).
* ``Job``             -- a "task" in paper terms: a process/backend emitting a
                         stream of bounded execution phases (bursts / blocks).

In sim mode a job's behaviour is a generator of :class:`Phase` objects; in live
mode the job wraps a callable that executes a real (device) chunk per dispatch.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional


@dataclass(frozen=True)
class RetryPolicy:
    """Per-job restart policy applied by the panic path (DESIGN.md
    section 12): a faulted job is restarted up to ``max_retries`` times
    with exponential backoff, then quarantined (EXITED, ``quarantined``
    set) so a crash-looping job can never occupy the scheduler forever.
    Jobs without a policy quarantine on the first panic."""

    max_retries: int = 3
    backoff: float = 0.005          # delay before the first restart
    backoff_growth: float = 2.0
    max_backoff: float = 0.25

    def delay(self, attempt: int) -> float:
        """Restart delay before retry ``attempt`` (1-based)."""
        return min(self.backoff * self.backoff_growth ** (attempt - 1),
                   self.max_backoff)


class Tier(enum.IntEnum):
    """UFS scheduling tiers. Lower value = higher precedence."""

    TIME_SENSITIVE = 0
    BACKGROUND = 1


class JobState(enum.Enum):
    NEW = "new"
    RUNNABLE = "runnable"      # waiting in a DSQ
    RUNNING = "running"        # occupying a slot
    BLOCKED = "blocked"        # sleeping (I/O, client think, lock backoff)
    LOCK_WAIT = "lock_wait"    # parked on an engine lock
    EXITED = "exited"


# Default cgroup cpu.weight in Linux.
DEFAULT_WEIGHT = 100.0
MIN_WEIGHT = 1.0
MAX_WEIGHT = 10_000.0


_group_ids = itertools.count()


class WorkloadGroup:
    """Hierarchical workload group -- the cgroup analogue.

    ``weight`` follows cgroup ``cpu.weight`` semantics (1..10000, default 100);
    the *effective* weight of a group resolves relative to its siblings through
    the hierarchy, as in the paper ("each cgroup's parameters are defined
    relative to its parent, with changes propagating accordingly").
    """

    def __init__(
        self,
        name: str,
        tier: Tier,
        weight: float = DEFAULT_WEIGHT,
        parent: Optional["WorkloadGroup"] = None,
        rate_cap: Optional[float] = None,
        slot_affinity: Optional[frozenset] = None,
    ):
        if not (MIN_WEIGHT <= weight <= MAX_WEIGHT):
            raise ValueError(f"weight {weight} outside [{MIN_WEIGHT}, {MAX_WEIGHT}]")
        self.gid = next(_group_ids)
        self.name = name
        self.tier = tier
        self.weight = float(weight)
        self.parent = parent
        self.children: list[WorkloadGroup] = []
        if parent is not None:
            if parent.tier != tier:
                raise ValueError("child group must share its parent's tier")
            parent.children.append(self)
        self.rate_cap = rate_cap                  # fraction of total slot-time, cpu.max analogue
        self.slot_affinity = slot_affinity        # cpuset analogue
        # --- scheduler state (owned by the policy) ---
        self.vruntime: float = 0.0                # group virtual runtime (runnable-tree key)
        self.task_vmax: float = 0.0               # high-watermark of member task vruntimes
        self.last_active: float = 0.0             # last dispatch charge (clamp gating)
        self.tree_epoch: int = -1                 # runnable-tree membership version
        self.usage_time: float = 0.0              # raw slot-seconds consumed (rate cap / metrics)

    # -- hierarchy -----------------------------------------------------------
    def effective_weight(self) -> float:
        """Weight resolved through the hierarchy: a child's share scales by its
        fraction of the sibling weight mass under its parent."""
        if self.parent is None:
            return self.weight
        sibling_mass = sum(c.weight for c in self.parent.children) or 1.0
        return self.parent.effective_weight() * (self.weight / sibling_mass)

    def set_weight(self, weight: float) -> None:
        """Dynamic reconfiguration (cgroup echo > cpu.weight analogue)."""
        if not (MIN_WEIGHT <= weight <= MAX_WEIGHT):
            raise ValueError(f"weight {weight} outside [{MIN_WEIGHT}, {MAX_WEIGHT}]")
        self.weight = float(weight)

    def __repr__(self) -> str:  # pragma: no cover
        return f"WorkloadGroup({self.name!r}, {self.tier.name}, w={self.weight})"


# ---------------------------------------------------------------------------
# Sim-mode job behaviour phases
# ---------------------------------------------------------------------------

@dataclass
class Burst:
    """Wants the execution unit for ``duration`` seconds (preemptible)."""

    duration: float
    request_id: Optional[int] = None   # if set, completing this burst completes a request


@dataclass
class Block:
    """Sleeps off-CPU for ``duration`` seconds (I/O, client think, backoff)."""

    duration: float


@dataclass
class TryLock:
    """Zero-time lock poll; the kernel ``send()``s back True/False. Used by
    the spin-acquire helper (``core.locks.spin_acquire``), whose CPU poll
    cost is modelled by a preceding :class:`Burst`."""

    lock: object          # core.locks.SimLock


@dataclass
class AcquireLock:
    """Sleep-discipline acquisition (LWLock analogue): park until hand-off."""

    lock: object


@dataclass
class ReleaseLock:
    lock: object


@dataclass
class PanicExit:
    """Stuck-spinlock watchdog fired (PostgreSQL PANIC analogue)."""


@dataclass
class RequestBegin:
    """Marks the client-visible start of a request (latency accounting)."""


@dataclass
class RequestEnd:
    pass


@dataclass
class Exit:
    pass


Phase = object  # union of the dataclasses above

_job_ids = itertools.count(1)


class Job:
    """A schedulable job.

    Sim mode: ``behavior`` is an iterator of phases. Live mode: ``run_chunk``
    is a callable ``(budget_s) -> (used_s, done)`` executing one bounded chunk
    of real work (e.g. a training microbatch or a decode iteration).
    """

    def __init__(
        self,
        group: WorkloadGroup,
        behavior: Optional[Iterator[Phase]] = None,
        run_chunk: Optional[Callable[[float], tuple]] = None,
        name: Optional[str] = None,
        kind: str = "generic",
        behavior_factory: Optional[Callable[[], Iterator[Phase]]] = None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.jid = next(_job_ids)
        self.name = name or f"job{self.jid}"
        self.kind = kind                      # "bursty" / "bound" / ... for metrics
        self.group = group
        self.behavior_factory = behavior_factory
        if behavior is None and behavior_factory is not None:
            behavior = behavior_factory()
        self.behavior = behavior
        self.run_chunk = run_chunk
        self.state = JobState.NEW
        # --- scheduler state ---
        self.vruntime: float = 0.0            # task virtual runtime (weight-scaled)
        self.prev_slot: int = -1              # last slot this job ran on
        self.boosted: bool = False            # hint-based priority-inversion boost
        self.boost_group = None               # TS group whose priority is inherited
        self.boost_count: int = 0             # times boosted (metrics / tests)
        self.pinned_slot: Optional[int] = None  # taskset analogue
        self.waker_slot: Optional[int] = None   # slot delivering wakeups (network RX IRQ)
        self.last_ran: float = -1.0             # cache-hot tracking (LB filters)
        self.location: Optional[tuple] = None   # ("local", slot)|("group", group) while queued
        # RT-class attributes for FIFO/RR baselines
        self.rt_priority: int = 0
        self.vdeadline: float = 0.0             # VDF baseline state
        # --- sim execution state ---
        self.burst_remaining: float = 0.0
        self.current_request: Optional[int] = None
        self.request_started_at: float = 0.0
        self.wakeup_time: float = 0.0         # when the job last became runnable
        self.resume_value = None              # value sent into the generator on resume
        self.total_cpu: float = 0.0
        self.completed_requests: int = 0
        self.held_locks: set = set()
        # --- fault containment state (DESIGN.md section 12) ---
        self.panic: bool = False              # a panic path fired for this job
        self.retry_policy = retry_policy      # None -> quarantine on first panic
        self.retries: int = 0                 # restarts consumed so far
        self.quarantined: bool = False        # EXITED via the quarantine path
        self.last_panic: str = ""             # repr of the last fault cause

    # Effective tier seen by the scheduler (boost lifts BG jobs into TS).
    @property
    def tier(self) -> Tier:
        if self.boosted:
            return Tier.TIME_SENSITIVE
        return self.group.tier

    def sched_group(self) -> WorkloadGroup:
        """Group used for scheduling/charging: a boosted job inherits the
        waiting time-sensitive task's group (priority inheritance)."""
        if self.boosted and self.boost_group is not None:
            return self.boost_group
        return self.group

    def __repr__(self) -> str:  # pragma: no cover
        return f"Job({self.name}, {self.group.name}, {self.state.value})"
