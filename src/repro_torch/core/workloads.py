"""Sim-mode workload generators modelling the paper's mixed DB workloads.

Calibrated against the paper's own measurements (Table 3 SOLO: mean 3.06 ms,
p95 5.80 ms for TPC-C on dedicated cores):

* :func:`bursty_worker`    -- CPU-bursty interactive transactions (TPC-C
  analogue; in the accelerator adaptation: interactive decode / short queries).
  Closed loop: think -> request -> single Gamma(k=3) CPU burst -> reply.
* :func:`bound_worker`     -- CPU-bound analytics (TPC-H Q17-in-a-UDF
  analogue; accelerator: training / bulk prefill). Long bursts with rare, very short
  I/O waits; completing ``query_cpu`` seconds of CPU finishes one query.
* :func:`schbench_worker`  -- the schbench-style wakeup-latency workload.
* :func:`holder` / :func:`waiter` / :func:`burner` -- the Table 4
  priority-inversion micro-experiment.
"""
from __future__ import annotations

import random
from typing import Iterator, Optional

from .locks import spin_acquire
from .task import (Block, Burst, Exit, ReleaseLock, RequestBegin, RequestEnd)

# Calibration against Table 3 SOLO (mean 3.06 ms, p95 5.80 ms): a TPC-C
# transaction is ~2 ms of CPU in two bursts around ~1 ms of in-server
# non-CPU time (WAL flush, buffer I/O, row-lock waits), with a short client
# round-trip between transactions. CPU demand per worker ~= 60%.
BURST_CPU_MEAN = 2.0e-3      # total CPU per transaction (Gamma, shape 2)
TX_IO = 1.0e-3               # in-server non-CPU time per transaction
THINK_TIME = 0.3e-3          # client round-trip + client-side processing
QUERY_CPU = 1.0              # CPU seconds per analytics query


def bursty_worker(seed: int, think: float = THINK_TIME,
                  cpu_mean: float = BURST_CPU_MEAN,
                  tx_io: float = TX_IO) -> Iterator:
    """Closed-loop interactive worker (one backend serving one client)."""
    rng = random.Random(seed)
    while True:
        yield Block(think)
        yield RequestBegin()
        yield Burst(rng.gammavariate(1, cpu_mean / 2))
        yield Block(tx_io)
        yield Burst(rng.gammavariate(1, cpu_mean / 2))
        yield RequestEnd()


def bound_worker(seed: int, query_cpu: float = QUERY_CPU,
                 io: float = 0.0) -> Iterator:
    """CPU-bound analytics loop (UDF running TPC-H Q17 continuously over hot
    buffers: pure CPU, never voluntarily sleeps; ``io`` > 0 adds per-query
    I/O waits for colder working sets)."""
    rng = random.Random(seed)
    while True:
        yield RequestBegin()
        yield Burst(query_cpu * rng.uniform(0.95, 1.05))
        yield RequestEnd()
        if io > 0:
            yield Block(io)


def schbench_worker(seed: int, think: float = 100e-6, compute: float = 30e-6,
                    n_ops: int = 5) -> Iterator:
    """schbench analogue: frequent sleep/wakeup with short compute phases
    (-n 5 operations per compute phase, moderate cache-pressure settings)."""
    rng = random.Random(seed)
    while True:
        yield Block(rng.expovariate(1.0 / think))
        yield RequestBegin()
        for _ in range(n_ops):
            yield Burst(rng.expovariate(1.0 / compute))
        yield RequestEnd()


# ---------------------------------------------------------------------------
# Table 4 priority-inversion micro-experiment
# ---------------------------------------------------------------------------

def holder(lock, compute: float = 3.0) -> Iterator:
    """Background task: acquire the spinlock, compute (1e9 simple ops ~= 3 s),
    release (paper section 6.6)."""
    yield RequestBegin()
    yield from spin_acquire(lock)
    yield Burst(compute)
    yield ReleaseLock(lock)
    yield RequestEnd()
    yield Exit()


def waiter(lock, start_delay: float = 0.1, compute: float = 0.05) -> Iterator:
    """Time-sensitive task: wants the same spinlock immediately after."""
    yield Block(start_delay)
    yield RequestBegin()
    yield from spin_acquire(lock)
    yield Burst(compute)
    yield ReleaseLock(lock)
    yield RequestEnd()
    yield Exit()


def burner(start_delay: float = 0.2, chunk: float = 10.0,
           total: Optional[float] = None) -> Iterator:
    """Time-sensitive task: synthetic CPU-bound tight loop pinned with the
    others; starves the holder unless the scheduler intervenes."""
    yield Block(start_delay)
    done = 0.0
    while total is None or done < total:
        yield Burst(chunk)
        done += chunk
