"""Serving-side KV cache slot management.

The engine keeps a fixed pool of per-request cache slots inside the batched
model cache (batch dimension = pool size). The allocator's free-list is
guarded by a hint-instrumented LiveLock -- the engine-level analogue of the
shared-structure LWLocks the paper hints on: if a background task (bulk
prefill, compaction) holds the allocator while a time-sensitive decode
needs a slot, the scheduler boosts the holder.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.base import SchedCore
from ..core.live import LiveLock
from ..models.weights import tree_map


def cache_batch_axes(model, max_len: int):
    """Per-leaf batch-axis map for ``model.init_cache`` trees.

    Builds the cache at two batch sizes on the ``meta`` device (shapes only,
    no memory) and records, for every leaf, the first axis whose extent
    tracks the batch size.  Leaves with no batch axis (shared state) get
    ``-1``.
    """
    a = model.init_cache(2, max_len, device="meta")
    b = model.init_cache(3, max_len, device="meta")

    def axis(x, y):
        for d, (m, n) in enumerate(zip(x.shape, y.shape)):
            if m != n:
                return d
        return -1

    return tree_map(axis, a, b)


def make_write_slots(batch_axes):
    """Build ``write(pool, rows, slots) -> pool``, which publishes a batch of
    per-request cache rows into the pooled cache.

    ``rows`` is a cache tree whose batch axis indexes the rows to write and
    ``slots`` a host integer vector of destination pool rows.  Slot indices
    outside the pool (the engine pads with the pool size as its sentinel)
    are dropped, and their rows are not written; a negative index counts
    from the end, as in the reference's scatter.

    The result is a new tree: the pool it was given is not written, because
    the engine's overlapped decode keeps references to superseded snapshots
    (generation-counter discard path) and reads them outside the lock.
    """
    def write(pool, rows, slots):
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)

        def one(pool_leaf, rows_leaf, ax):
            if ax < 0:
                return pool_leaf
            n = pool_leaf.shape[ax]
            idx = np.where(slots < 0, slots + n, slots)
            keep = np.nonzero((idx >= 0) & (idx < n))[0]
            new = pool_leaf.clone()
            if keep.size:
                src = rows_leaf.index_select(
                    ax, torch.as_tensor(keep, device=rows_leaf.device))
                new.index_copy_(ax, torch.as_tensor(idx[keep], device=new.device),
                                src.to(new.dtype))
            return new

        return tree_map(one, pool, rows, batch_axes)

    return write


class CacheSlotPool:
    def __init__(self, kernel: SchedCore, n_slots: int):
        self.n = n_slots
        self.free = list(range(n_slots))
        self.lock = LiveLock(kernel, "kv-slot-allocator")
        self.in_use: dict[int, str] = {}

    def alloc(self, job, request_id: str) -> Optional[int]:
        if not self.lock.acquire(job):
            return None
        try:
            if not self.free:
                return None
            slot = self.free.pop()
            self.in_use[slot] = request_id
            return slot
        finally:
            self.lock.release(job)

    def release(self, job, slot: int) -> None:
        if not self.lock.acquire(job):
            return
        try:
            self.in_use.pop(slot, None)
            self.free.append(slot)
        finally:
            self.lock.release(job)
