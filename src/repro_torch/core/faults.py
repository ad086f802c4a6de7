"""Deterministic fault injection for the scheduling core (DESIGN.md
section 12).

The paper's UFS argument is that background work can never hurt
time-sensitive work; that only holds if it survives jobs that *misbehave*.
This module is the crash-injection harness the containment tests drive:
deterministic injectors (counter-triggered, no randomness, no timing
dependence) usable from **both** backends --

* sim: a behaviour generator raises mid-phase
  (:func:`crashy_behavior`, :func:`crashing_holder`), the analogue of a
  backend process dying;
* live: a ``run_chunk`` callable raises (:func:`crashing_chunk`), or a
  side thread occupies a :class:`~repro_torch.core.live.LiveLock` so an
  ``acquire`` deterministically times out (:func:`occupy_lock`);
* either: a deferred :func:`drain_after` takes a slot offline mid-run.

Every injector funnels into the one panic path
(:meth:`~repro_torch.core.base.SchedCore.panic_job`), so the failure modes the
tests exercise are exactly the ones production would take.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Callable, Iterable, Optional

from .task import AcquireLock, Burst, Job, Phase, ReleaseLock


class FaultInjected(RuntimeError):
    """Raised by injectors at their trigger point."""


class FaultInjector:
    """Counter-triggered fault plan: ``plan`` maps site name -> the hit
    number (1-based) at which that site fires.  ``repeat`` makes a site
    fire on every hit at or past its trigger (crash loops); the default
    fires exactly once.

    >>> inj = FaultInjector({"chunk": 3})
    >>> [inj.fires("chunk") for _ in range(4)]
    [False, False, True, False]
    """

    def __init__(self, plan: Optional[dict] = None, repeat: bool = False):
        self.plan = dict(plan or {})
        self.repeat = repeat
        self.hits: Counter = Counter()
        self.fired: Counter = Counter()
        self._mu = threading.Lock()       # live chunks hit from worker threads

    def fires(self, site: str) -> bool:
        """Count a hit at ``site``; True when the plan says to fail."""
        with self._mu:
            self.hits[site] += 1
            at = self.plan.get(site)
            if at is None:
                return False
            n = self.hits[site]
            if n == at or (self.repeat and n > at):
                self.fired[site] += 1
                return True
            return False

    def check(self, site: str, exc: type = FaultInjected) -> None:
        """Raise ``exc`` when the plan fires at ``site``."""
        if self.fires(site):
            raise exc(f"injected fault at {site!r} (hit {self.hits[site]})")


# ---------------------------------------------------------------------------
# Live-backend injectors
# ---------------------------------------------------------------------------

def crashing_chunk(injector: FaultInjector, site: str = "chunk",
                   inner: Optional[Callable[[float], str]] = None,
                   ) -> Callable[[float], str]:
    """Wrap a live ``run_chunk`` so it raises when the injector fires.
    Without ``inner``, the chunk yields until the trigger point."""
    def chunk(budget: float) -> str:
        injector.check(site)
        return inner(budget) if inner is not None else "yield"
    return chunk


def occupy_lock(lock, job: Job, until: Optional[threading.Event] = None,
                ) -> threading.Event:
    """Acquire a :class:`~repro_torch.core.live.LiveLock` as ``job`` from a side
    thread and hold it until the returned event is set -- the
    deterministic driver for the ``acquire``-timeout path.  The acquire
    has happened by the time this returns."""
    release = until or threading.Event()
    held = threading.Event()

    def holder() -> None:
        lock.acquire(job)
        held.set()
        release.wait()
        lock.release(job)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    held.wait()
    return release


# ---------------------------------------------------------------------------
# Sim-backend injectors
# ---------------------------------------------------------------------------

def crashy_behavior(injector: FaultInjector, phases: Iterable[Phase],
                    site: str = "chunk"):
    """Yield ``phases``, consulting the injector before each -- the sim
    analogue of a chunk crash: the generator raises mid-stream and the
    phase machinery routes it to the panic path."""
    for ph in phases:
        injector.check(site)
        yield ph


def crashing_holder(lock, hold_cpu: float = 1e-3,
                    crash: bool = True) -> Callable[[], object]:
    """Behaviour *factory* (suitable for ``Job(behavior_factory=...)``, so
    retries rebuild it): acquire ``lock``, burn ``hold_cpu``, then raise
    while still holding it.  ``crash=False`` yields a well-behaved control
    run of the same shape."""
    def behavior():
        yield AcquireLock(lock)
        yield Burst(hold_cpu)
        if crash:
            raise FaultInjected(f"crash while holding {lock.name}")
        yield ReleaseLock(lock)
    return behavior


# ---------------------------------------------------------------------------
# Backend-agnostic injectors
# ---------------------------------------------------------------------------

def drain_after(kernel, sid: int, delay: float) -> None:
    """Take slot ``sid`` offline after ``delay`` on the kernel's clock
    (virtual or monotonic): slot-loss injection mid-run on either backend."""
    kernel.executor.defer(delay, lambda: kernel.drain_slot(sid))
