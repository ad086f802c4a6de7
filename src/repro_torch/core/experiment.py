"""Experiment harness: builds the paper's workload mixes against any policy.

Mirrors Table 1 / Table 2 of the paper:

* SOLO      -- N bursty workers alone (or N bound workers alone)
* MIN:MAX   -- bursty at maximum priority, bound at minimum
* 50:50     -- both at the same (high) priority

Weights per Table 2 / section 6: high = 10k, low = 1. Under UFS the
low-priority work lives in a background-tier group; under the baselines the
tier merely selects the scheduling class per Table 2 (RT vs normal, idle).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .build import build_kernel
from .metrics import Metrics
from .task import Job, Tier
from .trace import SchedTracer
from . import workloads as wl

HIGH_WEIGHT = 10_000.0
LOW_WEIGHT = 1.0


@dataclass
class MixResult:
    policy: str
    metrics: Metrics
    n_slots: int
    duration: float
    _summary: Optional[dict] = field(default=None, repr=False, compare=False)

    def summary(self) -> dict:
        """The unified ``Metrics.summary`` view (computed once)."""
        if self._summary is None:
            self._summary = self.metrics.summary(n_slots=self.n_slots)
        return self._summary

    def thr(self, group: str) -> float:
        row = self.summary()["groups"].get(group)
        return row["throughput"] if row else 0.0

    def lat(self, group: str) -> dict:
        row = self.summary()["groups"].get(group)
        return row["latency"] if row else self.metrics.latency_stats(group)


def run_mix(
    policy_name: str,
    n_slots: int = 8,
    n_bursty: int = 8,
    n_bound: int = 8,
    bound_tier: Tier = Tier.BACKGROUND,
    bound_weight: float = LOW_WEIGHT,
    bursty_weight: float = HIGH_WEIGHT,
    duration: float = 60.0,
    warmup: float = 60.0,
    seed: int = 0,
    hints_enabled: bool = True,
    bursty_groups: Optional[list] = None,   # [(name, weight, n), ...] overrides
    bound_groups: Optional[list] = None,
    query_cpu: float = wl.QUERY_CPU,
    kick_latency: float = 0.0,
    n_rx_slots: int = 1,
    tracer: Optional[SchedTracer] = None,
) -> MixResult:
    """Run one workload mix for ``duration`` seconds after ``warmup``.

    ``n_rx_slots`` models how many slots take network-RX interrupts (the
    wakeup source for client-driven bursty backends); wake-affine placement
    in the VDF baseline gravitates wakees toward these slots.  Pass a
    :class:`SchedTracer` to capture the run's scheduling events.
    """
    kernel = build_kernel("sim", policy=policy_name, n_slots=n_slots,
                          hints_enabled=hints_enabled,
                          kick_latency=kick_latency, tracer=tracer, seed=seed)

    if bursty_groups is None:
        bursty_groups = [("ts", bursty_weight, n_bursty)]
    if bound_groups is None:
        bound_groups = [("bg", bound_weight, n_bound)]

    jid = 0
    for gname, weight, n in bursty_groups:
        if n == 0:
            continue
        g = kernel.create_group(gname, Tier.TIME_SENSITIVE, weight)
        for i in range(n):
            job = Job(g, behavior=wl.bursty_worker(seed * 1000 + jid),
                      name=f"{gname}-{i}", kind="bursty")
            job.waker_slot = jid % max(1, n_rx_slots)
            kernel.add_job(job, at=0.0)
            jid += 1
    for gname, weight, n in bound_groups:
        if n == 0:
            continue
        g = kernel.create_group(gname, bound_tier, weight)
        for i in range(n):
            job = Job(g, behavior=wl.bound_worker(seed * 1000 + jid, query_cpu=query_cpu),
                      name=f"{gname}-{i}", kind="bound")
            kernel.add_job(job, at=0.0)
            jid += 1

    metrics = kernel.run(warmup + duration, warmup=warmup)
    return MixResult(policy_name, metrics, n_slots, duration)


def scenario(policy: str, mix: str, n_slots: int = 8, n: int = 8,
             duration: float = 60.0, warmup: float = 60.0, seed: int = 0,
             **kw) -> MixResult:
    """Named scenarios from Table 1."""
    if mix == "solo":
        return run_mix(policy, n_slots, n_bursty=n, n_bound=0,
                       duration=duration, warmup=warmup, seed=seed, **kw)
    if mix == "solo_bound":
        return run_mix(policy, n_slots, n_bursty=0, n_bound=n,
                       duration=duration, warmup=warmup, seed=seed, **kw)
    if mix == "minmax":
        return run_mix(policy, n_slots, n_bursty=n, n_bound=n,
                       bound_tier=Tier.BACKGROUND, bound_weight=LOW_WEIGHT,
                       duration=duration, warmup=warmup, seed=seed, **kw)
    if mix == "5050":
        return run_mix(policy, n_slots, n_bursty=n, n_bound=n,
                       bound_tier=Tier.TIME_SENSITIVE, bound_weight=HIGH_WEIGHT,
                       duration=duration, warmup=warmup, seed=seed, **kw)
    raise ValueError(f"unknown mix {mix!r}")
