"""repro_torch.core -- UFS: the selectively unfair scheduler (the paper's
contribution), plus the scheduling kernel and baseline policies.

Public surface:

* :func:`build_kernel` -- the one construction path for both backends;
  :class:`KernelReport` -- the one telemetry read-out (metrics + trace)
* :class:`SchedKernel`, :class:`Slot`, :class:`SimClock` -- event-driven core
* :class:`SchedTracer` -- bounded ring buffer of scheduler lifecycle events
  (eBPF-tracepoint analogue) with Chrome-trace export and derived analyses
* :class:`UFSPolicy` and baselines via :func:`make_policy`
* :class:`Job`, :class:`WorkloadGroup`, :class:`Tier` -- schedulable entities
* :class:`HintTable` -- application-based scheduler hinting (eBPF-map analogue)
* workload generators for the paper's experiments
"""
from .task import (Job, JobState, Tier, WorkloadGroup, Burst, Block,
                   RequestBegin, RequestEnd, Exit, RetryPolicy)
from .faults import (FaultInjected, FaultInjector, crashing_chunk,
                     crashy_behavior, crashing_holder, occupy_lock,
                     drain_after)
from .trace import (SchedTracer, TraceEvent, TraceSummary, summarize,
                    busy_intervals, slot_busy_from_trace, wakeup_delays,
                    detect_inversions, to_chrome_trace, write_chrome_trace,
                    validate_events, validate_chrome_trace, TraceSchemaError)
from .base import SchedCore, Executor, Policy, Slot, DEFAULT_SLICE
from .kernel import SchedKernel, SimClock, SimExecutor
from .live import LiveKernel, LiveJob, LiveLock, ThreadExecutor
from .build import build_kernel, KernelReport
from .hints import HintTable
from .locks import SimLock, spin_acquire
from .metrics import Metrics, percentile, percentile_sorted
from .ufs import UFSPolicy
from .policies import make_policy, POLICIES

__all__ = [
    "Job", "JobState", "Tier", "WorkloadGroup", "Burst", "Block",
    "RequestBegin", "RequestEnd", "Exit", "RetryPolicy",
    "FaultInjected", "FaultInjector", "crashing_chunk", "crashy_behavior",
    "crashing_holder", "occupy_lock", "drain_after",
    "SchedCore", "Executor", "Policy", "Slot", "DEFAULT_SLICE",
    "SchedKernel", "SimClock", "SimExecutor",
    "LiveKernel", "LiveJob", "LiveLock", "ThreadExecutor",
    "build_kernel", "KernelReport",
    "SchedTracer", "TraceEvent", "TraceSummary", "summarize",
    "busy_intervals", "slot_busy_from_trace", "wakeup_delays",
    "detect_inversions", "to_chrome_trace", "write_chrome_trace",
    "validate_events", "validate_chrome_trace", "TraceSchemaError",
    "HintTable", "SimLock", "spin_acquire", "Metrics", "percentile",
    "percentile_sorted",
    "UFSPolicy", "make_policy", "POLICIES",
]
