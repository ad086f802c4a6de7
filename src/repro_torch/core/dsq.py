"""Dispatch queues (paper section 2, "sched_ext" background).

* :class:`LocalDSQ` -- per-slot run queue holding jobs intended to run on that
  slot soon; ordered by a policy-provided key (vruntime for UFS, virtual
  deadline for the VDF baseline, FIFO order for RT baselines).
* :class:`GroupDSQ` -- custom per-group queue for deferred background
  dispatch; ordered by task virtual runtime.

Implementation: an indexed binary heap with lazy deletion (DESIGN.md
section 11).  Entries are mutable ``[key, tie, job]`` cells kept in a
``heapq`` heap plus a ``jid -> cell`` index, so the hot operations are

* ``push``            -- O(log n)
* ``pop_front``       -- amortized O(log n) (plus draining dead cells)
* ``remove``          -- O(1): mark the indexed cell dead, prune lazily
* ``peek_front/key``  -- amortized O(1)

``remove`` is the operation that matters: the hint-boost path pulls a lock
holder out of an arbitrarily deep background DSQ on *every* priority
inversion, which was O(n) per boost on the previous sorted-list layout and
dominated deep-queue sim time.  Dead cells are pruned at the heap top on
every peek/pop and compacted wholesale once they outnumber live ones.

The tie counter is **per queue** (not module-global): two kernels built in
the same process observe identical tie-break sequences, so same-seed runs
are byte-identical run to run.  Ties are unique within a queue, so heap
comparisons never reach the ``job`` field.
"""
from __future__ import annotations

import heapq
from typing import Optional

from .task import Job

_COMPACT_MIN_DEAD = 16   # never compact tiny queues


class _OrderedQueue:
    __slots__ = ("_heap", "_index", "_tie", "_dead")

    def __init__(self) -> None:
        self._heap: list = []          # [key, tie, job-or-None] cells
        self._index: dict = {}         # jid -> live cell
        self._tie = 0
        self._dead = 0                 # dead cells still sitting in _heap

    def __len__(self) -> int:
        return len(self._index)

    def __bool__(self) -> bool:
        return bool(self._index)

    # ------------------------------------------------------------ internals
    def _prune(self) -> None:
        """Drop dead cells off the heap top."""
        heap = self._heap
        while heap and heap[0][2] is None:
            heapq.heappop(heap)
            self._dead -= 1

    def _compact(self) -> None:
        if self._dead > _COMPACT_MIN_DEAD and self._dead * 2 > len(self._heap):
            self._heap = [c for c in self._heap if c[2] is not None]
            heapq.heapify(self._heap)
            self._dead = 0

    # ------------------------------------------------------------- hot path
    def push(self, job: Job, key: float) -> None:
        old = self._index.get(job.jid)
        if old is not None:            # double-push: supersede the stale cell
            old[2] = None
            self._dead += 1
        self._tie += 1
        cell = [key, self._tie, job]
        self._index[job.jid] = cell
        heapq.heappush(self._heap, cell)

    def pop_front(self) -> Optional[Job]:
        self._prune()
        if not self._heap:
            return None
        key, tie, job = heapq.heappop(self._heap)
        del self._index[job.jid]
        return job

    def peek_front(self) -> Optional[Job]:
        self._prune()
        return self._heap[0][2] if self._heap else None

    def peek_key(self) -> Optional[float]:
        self._prune()
        return self._heap[0][0] if self._heap else None

    def remove(self, job: Job) -> bool:
        """Keyed removal: O(1) dead-marking via the jid index."""
        cell = self._index.get(job.jid)
        if cell is None or cell[2] is not job:
            return False
        cell[2] = None
        del self._index[job.jid]
        self._dead += 1
        self._compact()
        return True

    # ----------------------------------------------------------- cold path
    def pop_back(self) -> Optional[Job]:
        """O(n): the heap has no cheap max.  Only used by tests/tools."""
        if not self._index:
            return None
        cell = max(self._index.values())
        cell_job = cell[2]
        cell[2] = None
        del self._index[cell_job.jid]
        self._dead += 1
        self._compact()
        return cell_job

    def pop_first_where(self, pred) -> Optional[Job]:
        """Pop the first job (in key order) satisfying ``pred``.

        Pops cells off the heap while scanning and re-pushes the skipped
        ones afterwards; since cells keep their (key, tie), order is
        preserved exactly.  ``pred`` raising never loses entries.
        """
        heap = self._heap
        skipped: list = []
        found: Optional[Job] = None
        try:
            while heap:
                cell = heapq.heappop(heap)
                job = cell[2]
                if job is None:
                    self._dead -= 1
                    continue
                skipped.append(cell)     # keep provisionally: pred may raise
                if pred(job):
                    skipped.pop()
                    del self._index[job.jid]
                    found = job
                    break
        finally:
            for cell in skipped:
                heapq.heappush(heap, cell)
        return found

    def jobs(self) -> list:
        """Live jobs in key order (O(n log n); reporting/balancing only)."""
        return [c[2] for c in sorted(self._index.values())]

    def total_key_weight(self, keyfn) -> float:
        # Summed in key order so float accumulation matches the old sorted
        # layout bit for bit.
        return sum(keyfn(j) for j in self.jobs())


class LocalDSQ(_OrderedQueue):
    """Per-slot local dispatch queue."""
    __slots__ = ()


class GroupDSQ(_OrderedQueue):
    """Per-group custom dispatch queue, ordered by task vruntime: the task at
    the head has executed the least and runs first (paper section 5.1.3)."""
    __slots__ = ()
