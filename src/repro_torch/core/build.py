"""One construction path and one report surface for every kernel consumer.

Before this module each consumer (``experiment.py``, ``benchmarks/``,
``launch/serve.py``, ``launch/train.py``, ``examples/``) grew its own
kernel-construction convention and its own final-stats dict.  Now there is
exactly one of each:

* :func:`build_kernel` -- ``build_kernel("sim"|"live", policy=..., n_slots=...,
  tracer=...)``: a thin mode switch over the shared keyword signature of
  :class:`~repro_torch.core.kernel.SchedKernel` and
  :class:`~repro_torch.core.live.LiveKernel`;
* :class:`KernelReport` -- metrics summary + trace summary + hint counters
  in one JSON-serializable object, so drivers stop hand-assembling
  percentile dicts and print lines.
"""
from __future__ import annotations

import json
import math
from typing import Optional, Union

from .base import Policy, SchedCore
from .kernel import SchedKernel, SimExecutor
from .live import LiveKernel
from .metrics import Metrics
from .policies import make_policy
from .trace import SchedTracer

__all__ = ["build_kernel", "KernelReport"]

MODES = ("sim", "live")


def build_kernel(
    mode: str = "sim",
    *,
    policy: Union[str, Policy] = "ufs",
    n_slots: int = 1,
    kick_latency: float = 0.0,
    tracer: Optional[SchedTracer] = None,
    trace: bool = False,
    metrics: Optional[Metrics] = None,
    hints=None,
    hints_enabled: bool = True,
    seed: int = 0,
) -> SchedCore:
    """Build a scheduling kernel for either execution backend.

    ``policy`` is a registered policy name (``"ufs"``, ``"vdf"``, ...) or a
    :class:`Policy` instance.  ``trace=True`` attaches a fresh
    :class:`SchedTracer` when none is passed; the kernel's tracer is always
    reachable as ``kernel.tracer``.  ``seed`` only affects the sim backend.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {MODES}")
    if isinstance(policy, str):
        policy = make_policy(policy)
    if trace and tracer is None:
        tracer = SchedTracer()
    cls = SchedKernel if mode == "sim" else LiveKernel
    return cls(n_slots, policy, hints=hints, metrics=metrics,
               kick_latency=kick_latency, hints_enabled=hints_enabled,
               seed=seed, tracer=tracer)


def _finite(obj):
    """Recursively replace non-finite floats with None (strict-JSON safe)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


class KernelReport:
    """Unified end-of-run telemetry: ``Metrics.summary`` + ``TraceSummary``
    + hint counters, with one ``to_json``.  Serve/train/benchmarks build
    this instead of hand-assembling final-stats dicts."""

    def __init__(self, mode: str, policy: str, n_slots: int,
                 metrics: dict, trace: Optional[dict] = None,
                 hints: Optional[dict] = None):
        self.mode = mode
        self.policy = policy
        self.n_slots = n_slots
        self.metrics = metrics
        self.trace = trace
        self.hints = hints or {}

    @classmethod
    def from_kernel(cls, kernel: SchedCore,
                    groups: Optional[list] = None) -> "KernelReport":
        mode = "sim" if isinstance(kernel.executor, SimExecutor) else "live"
        tracer = kernel.tracer
        return cls(
            mode=mode,
            policy=getattr(kernel.policy, "name", type(kernel.policy).__name__),
            n_slots=len(kernel.slots),
            metrics=kernel.metrics.summary(groups=groups,
                                           n_slots=len(kernel.slots)),
            trace=tracer.summary().to_dict() if tracer is not None else None,
            hints={"writes": kernel.hints.writes, "boosts": kernel.hints.boosts},
        )

    def to_dict(self) -> dict:
        return {"mode": self.mode, "policy": self.policy,
                "n_slots": self.n_slots, "metrics": self.metrics,
                "trace": self.trace, "hints": self.hints}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(_finite(self.to_dict()), sort_keys=True,
                          indent=indent, allow_nan=False)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    # ------------------------------------------------------------------
    def pretty(self) -> str:
        """A few human-readable lines for driver stdout."""
        c = self.metrics["counters"]
        lines = [f"[{self.mode}/{self.policy}] slots={self.n_slots} "
                 f"preemptions={c['preemptions']} kicks={c['kicks']} "
                 f"dispatches={c['dispatches']} "
                 f"hint_writes={self.hints.get('writes', 0)} "
                 f"boosts={self.hints.get('boosts', 0)}"]
        for g, row in sorted(self.metrics["groups"].items()):
            lat = row["latency"]
            lat_txt = ""
            if lat["n"]:
                lat_txt = (f"  lat mean {lat['mean']*1e3:.2f} ms "
                           f"p95 {lat['p95']*1e3:.2f} ms (n={lat['n']})")
            lines.append(f"  group {g}: completed={row['completed']} "
                         f"cpu={row['cpu_s']:.3f}s{lat_txt}")
        if self.trace is not None:
            lines.append(f"  trace: {self.trace['events']} events "
                         f"({self.trace['dropped']} dropped), "
                         f"{self.trace['inversions_resolved']}/"
                         f"{self.trace['inversions']} inversions resolved")
        return "\n".join(lines)
