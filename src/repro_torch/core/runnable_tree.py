"""The runnable tree (paper section 5.1.3, Figure 5).

Manages runnable *background* group queues, keyed by group virtual runtime.
The paper implements this as an eBPF red-black tree; here we use a binary
heap with lazy invalidation, which preserves the verifier-friendly contract
(bounded peek/remove/insert, no unbounded traversal) and gives the same
O(log n) operations:

* ``insert(group)``   -- (re)insert a group keyed by its current vruntime
* ``peek_min()``      -- group with the lowest vruntime (leftmost leaf)
* ``remove(group)``   -- drop a group (e.g. it became empty -> stashed)

A per-group epoch counter invalidates stale heap entries, mirroring how the
paper removes vanished cgroups during dispatch ("Verify active state").
The *stash* for empty groups' bookkeeping nodes is modelled by simply
dropping membership; re-insert is O(log n).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Optional

from .task import WorkloadGroup


class RunnableTree:
    def __init__(self) -> None:
        self._heap: list[tuple[float, int, int, WorkloadGroup]] = []
        self._seq = itertools.count()
        self._epoch = itertools.count()
        self._members: dict[int, int] = {}    # gid -> live epoch

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, group: WorkloadGroup) -> bool:
        return group.gid in self._members

    def insert(self, group: WorkloadGroup) -> None:
        """Insert or re-key ``group`` at its current ``group.vruntime``."""
        epoch = next(self._epoch)
        self._members[group.gid] = epoch
        group.tree_epoch = epoch
        heapq.heappush(self._heap, (group.vruntime, next(self._seq), epoch, group))

    def remove(self, group: WorkloadGroup) -> None:
        """Remove ``group`` (lazy: stale heap entries are skipped on peek)."""
        self._members.pop(group.gid, None)

    def peek_min(self) -> Optional[WorkloadGroup]:
        """Group with the minimum vruntime, or None if the tree is empty."""
        heap = self._heap
        while heap:
            vrt, _, epoch, group = heap[0]
            if self._members.get(group.gid) == epoch and group.vruntime == vrt:
                return group
            heapq.heappop(heap)   # stale (removed or re-keyed) -- discard
        return None

    def pop_min(self) -> Optional[WorkloadGroup]:
        group = self.peek_min()
        if group is not None:
            self.remove(group)
        return group

    def min_vruntime(self) -> float:
        g = self.peek_min()
        return g.vruntime if g is not None else 0.0
