"""Continuous-batching inference engine, scheduled by UFS in live mode.

The engine owns a fixed request-slot pool inside one batched model cache and
emits bounded *work items* to the scheduler:

* a **decode job** (time-sensitive tier): one chunk = one batched decode
  step over all active requests -- short device burst, then back to the
  queue (the CPU-bursty analogue);
* **prefill jobs** per admitted request (tier configurable: interactive
  prefill is time-sensitive, bulk/batch ingestion is background);
* the trainer's microbatch jobs (background tier) contend for the same
  slots -- the mixed workload of the paper, on real device work.

Requests carry ``tier``/``weight`` annotations -- the client-facing analogue
of the paper's ``SET task_tier/task_weight`` SQL interface.

Locking discipline (DESIGN.md section 13): ``self._lock`` guards **all**
mutable engine state -- ``pending``, ``active``, ``lengths``, ``completed``,
``_inflight_bulk``, the generation counter and the pooled ``caches``
reference -- but on the hot path it is *never held across device compute*:

* **decode** snapshots ``(gen, caches, toks, pos)`` under the lock, runs the
  model step and the host sync outside it, and merges the result back under
  the lock only if the generation counter is unchanged (a concurrent
  admission or bulk merge published new cache rows the snapshot lacks, so
  the stale step is discarded and retried);
* **admission** reserves slots under the lock (pool alloc + pending pop),
  prefills all admitted prompts in one padded batched call outside it, and
  publishes the rows with one scatter (``write_slots``) under it;
* **bulk prefill** computes its batch-1 cache outside the lock and takes it
  only to merge.

Every publish of new cache *rows* bumps ``self._gen``; row removals
(expire/finish) do not -- decode rows are independent, so clobbering a freed
row is harmless, while decoding against a snapshot that lacks a newly
admitted row would lose that request's first step.  ``CacheSlotPool``'s
LiveLock is only ever acquired while holding (or without) ``self._lock``,
never the reverse, so lock order stays acyclic.

``overlap_decode=False`` / ``batched_admission=False`` preserve the
pre-overhaul behavior (lock held across compute, per-request prefill inside
the admission loop), the reference serving benchmark's recorded baseline.

Device work: every thread issues to the default CUDA stream, so kernels run
in the order the threads issue them.  Model steps return new cache tensors
(out of place), so a snapshot held outside the lock stays valid while a
concurrent publish replaces ``self.caches``.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..core.live import LiveJob, LiveKernel
from ..core.task import Tier
from ..models.weights import tree_map
from .kv_cache import CacheSlotPool, cache_batch_axes, make_write_slots

_req_ids = itertools.count(1)


@dataclass
class Request:
    prompt: np.ndarray                  # (prompt_len,) int32
    max_new_tokens: int = 16
    tier: str = "time-sensitive"        # SET task_tier analogue
    weight: float = 10_000.0            # SET task_weight analogue
    deadline_s: Optional[float] = None  # fail if not finished within this
    rid: int = field(default_factory=lambda: next(_req_ids))
    submitted: float = 0.0
    first_token: Optional[float] = None
    finished: Optional[float] = None
    tokens: list = field(default_factory=list)
    token_times: list = field(default_factory=list)  # monotonic per token
    slot: Optional[int] = None
    error: Optional[str] = None         # "deadline" / "shutdown" when failed
    done_event: threading.Event = field(default_factory=threading.Event)

    @property
    def latency(self) -> Optional[float]:
        return None if self.finished is None else self.finished - self.submitted

    @property
    def ok(self) -> bool:
        return self.finished is not None and self.error is None


@dataclass
class EngineStats:
    """Hot-path engine counters, deliberately *outside* ``Metrics`` so the
    scheduler's ``Metrics.summary()`` (and the sim benchmark's
    ``summary_sha256``) is untouched by serving instrumentation."""
    decode_steps: int = 0
    decode_invalidations: int = 0       # stale snapshots discarded (gen raced)
    batched_admissions: int = 0         # padded multi-request prefill calls
    admitted: int = 0                   # requests activated via admission
    bulk_prefills: int = 0              # background prefills merged
    lock_hold_s: deque = field(default_factory=lambda: deque(maxlen=65536))

    def summary(self) -> dict:
        holds = sorted(self.lock_hold_s)

        def pct(p):
            if not holds:
                return 0.0
            return holds[min(len(holds) - 1, int(p * (len(holds) - 1)))]

        return {
            "decode_steps": self.decode_steps,
            "decode_invalidations": self.decode_invalidations,
            "batched_admissions": self.batched_admissions,
            "admitted": self.admitted,
            "bulk_prefills": self.bulk_prefills,
            "lock_hold_p50_us": pct(0.50) * 1e6,
            "lock_hold_p99_us": pct(0.99) * 1e6,
            "lock_hold_max_us": (holds[-1] if holds else 0.0) * 1e6,
            "lock_holds": len(holds),
        }


def _next_pow2(n: int) -> int:
    return 1 << max(3, (n - 1).bit_length())      # floor bucket at 8


class InferenceEngine:
    def __init__(self, model, params, kernel: LiveKernel, *,
                 max_batch: int = 8, max_len: int = 256,
                 group_name: str = "serve",
                 overlap_decode: bool = True,
                 batched_admission: bool = True):
        self.model = model
        self.params = params
        self.kernel = kernel
        self.max_batch = max_batch
        self.max_len = max_len
        self.overlap_decode = overlap_decode
        self.batched_admission = batched_admission
        self.group = kernel.create_group(group_name, Tier.TIME_SENSITIVE, 10_000.0)
        # Bulk-ingestion prefill runs in the background tier: the paper's
        # core idea applied inside serving -- long prefills use only slack
        # and are never dispatched ahead of interactive decode steps.
        self.bulk_group = kernel.create_group(group_name + "-bulk",
                                              Tier.BACKGROUND, 100.0)
        self.pool = CacheSlotPool(kernel, max_batch)
        self.caches = model.init_cache(max_batch, max_len)
        self.lengths = np.zeros((max_batch,), np.int32)
        self.active: dict[int, Request] = {}     # slot -> request
        self.pending: deque = deque()    # FIFO admission; popleft is O(1)
        self._inflight_bulk: dict[int, Request] = {}  # rid -> bulk req pre-slot
        self._lock = threading.Lock()
        self.completed: list = []
        self.stats = EngineStats()
        self._gen = 0                    # bumped on every cache-row publish
        self.device = getattr(model, "device", torch.device("cuda"))
        self._decode = model.decode_step
        # Batched ragged admission prefill: one padded call for all admits.
        # Optional -- models without prefill_batch fall back per-request.
        self._prefill_batch_fn = getattr(model, "prefill_batch", None)
        # One scatter publishes any number of cache rows at once; the
        # batch-axis map is probed shape-only (no device memory).
        self._batch_axes = cache_batch_axes(model, max_len)
        self._write_slots = make_write_slots(self._batch_axes)
        self._job = LiveJob(self.group, self._decode_chunk, name="decode-loop",
                            kind="bursty")
        self._running = False
        self._nudge_armed = False
        # Bulk prefill jobs parked on slot exhaustion (FIFO), and wakes
        # queued under the lock to be delivered after it is dropped.
        self._slot_waiters: deque = deque()
        self._slot_wakes: list = []

    # ----------------------------------------------------------------- API
    def start(self) -> None:
        self._running = True
        self.kernel.wake(self._job)

    def stop(self, drain: bool = True) -> None:
        """Graceful shutdown.  With ``drain`` (default) whatever is still
        in flight is *failed now*: never-admitted pending requests,
        mid-decode active requests and not-yet-landed bulk submissions get
        ``error="shutdown"`` and their ``done_event`` set, and active cache
        slots go back to the pool.  (A bulk request whose prefill already
        reserved a slot releases it itself when its merge step observes the
        error.)  With ``drain=False`` the loop finishes the in-flight batch
        first.  Either way the blocked decode loop is woken so it observes
        the shutdown and exits instead of sleeping forever."""
        with self._lock:
            self._running = False
            if drain:
                while self.pending:
                    self._fail_locked(self.pending.popleft(), "shutdown")
                for slot in list(self.active):
                    self._fail_locked(self.active[slot], "shutdown", slot=slot)
                for req in list(self._inflight_bulk.values()):
                    self._fail_locked(req, "shutdown")
            # Bulk prefill jobs parked on slot exhaustion must be woken to
            # observe the shutdown (their chunks fail the request and
            # exit); otherwise they would sleep forever.
            while self._slot_waiters:
                self._slot_wakes.append(self._slot_waiters.popleft())
        self._flush_slot_wakes()
        # Wake the (possibly parked) decode loop so it observes the
        # shutdown.  A chunk that already decided "blocked" may not have
        # parked yet, and waking a running job would double-dispatch it, so
        # wait for the job-state to settle before waking.  The executor's
        # event-driven settle wait replaces the old 1 ms busy-poll; the
        # bounded poll remains as a fallback for executors without it.
        settle = getattr(self.kernel.executor, "wait_job_settle", None)
        if settle is not None:
            state = settle(self._job, states=("blocked", "exited", "new"),
                           timeout=2.0)
            if state == "blocked":
                self.kernel.wake(self._job)
            return
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            state = self._job.state.value
            if state == "blocked":
                self.kernel.wake(self._job)
                return
            if state in ("exited", "new"):
                return                       # already done / never started
            time.sleep(0.001)                # running/runnable: let it land

    def _fail_locked(self, req: Request, error: str,
                     slot: Optional[int] = None) -> None:
        """Fail a request (deadline / shutdown): mark it, wake its waiter,
        and release its cache slot.  Caller holds ``self._lock``."""
        req.error = error
        req.finished = time.monotonic()
        self._inflight_bulk.pop(req.rid, None)
        if slot is not None:
            self.active.pop(slot, None)
            self.lengths[slot] = 0
            self.pool.release(self._job, slot)
            self._notify_slot_free_locked()
        self.completed.append(req)
        req.done_event.set()

    def _expire_locked(self, now: float) -> None:
        """Fail every request whose deadline has passed: pending and
        in-flight bulk requests before they occupy a slot, active ones
        releasing theirs.  Caller holds ``self._lock``."""
        expired = [r for r in self.pending
                   if r.deadline_s is not None
                   and now - r.submitted > r.deadline_s]
        for req in expired:
            self.pending.remove(req)
            self._fail_locked(req, "deadline")
        for req in list(self._inflight_bulk.values()):
            if (req.deadline_s is not None
                    and now - req.submitted > req.deadline_s):
                self._fail_locked(req, "deadline")
        for slot, req in list(self.active.items()):
            if (req.deadline_s is not None
                    and now - req.submitted > req.deadline_s):
                self._fail_locked(req, "deadline", slot=slot)

    def submit(self, req: Request) -> Request:
        req.submitted = time.monotonic()
        if req.tier == "background":
            # bulk request: its prefill is a background job; once prefilled
            # the request joins the (time-sensitive) decode batch.  Tracked
            # in _inflight_bulk until it lands a slot so stop(drain=True)
            # and deadline expiry can fail it (it used to be invisible:
            # its done_event waiter hung until deadline).
            with self._lock:
                self._inflight_bulk[req.rid] = req
            holder: list = []
            job = LiveJob(self.bulk_group,
                          lambda budget, r=req: self._bulk_prefill_chunk(
                              r, holder[0]),
                          name=f"bulk-prefill-{req.rid}", kind="bound")
            holder.append(job)
            self.kernel.wake(job)
            return req
        with self._lock:
            self.pending.append(req)
            # The loop may be publishing BLOCKED right now without having
            # seen this request (state reads "running" for a moment after
            # the chunk's block decision).  Only possible when the engine
            # looks idle; a deferred nudge re-checks and self-heals.  At
            # most one nudge chain is armed at a time -- defer() spawns a
            # timer thread, so arming per-submit would storm the hot path.
            arm = (not self.active and not self._nudge_armed)
            if arm:
                self._nudge_armed = True
        if self._job.state.value == "blocked":
            if arm:                          # wake supersedes the nudge:
                with self._lock:             # don't leak the armed flag
                    self._nudge_armed = False
            self.kernel.wake(self._job)      # new work arrived: wake the loop
        elif arm:
            self.kernel.executor.defer(0.002, self._nudge_decode_loop)
        return req

    def _nudge_decode_loop(self, delay: float = 0.002) -> None:
        """Self-healing wake for the submit/park race: retries with backoff
        while pending work is stranded; never wakes a non-blocked job (that
        would double-dispatch it)."""
        with self._lock:
            if not (self.pending and self._running):
                self._nudge_armed = False    # under _lock: arm/clear race-free
                return
        if self._job.state.value == "blocked":
            with self._lock:
                self._nudge_armed = False
            self.kernel.wake(self._job)
            return
        nxt = min(delay * 1.5, 0.05)
        self.kernel.executor.defer(nxt, lambda: self._nudge_decode_loop(nxt))

    # --------------------------------------------- slot-exhaustion parking
    def _notify_slot_free_locked(self) -> None:
        """A cache slot went back to the pool: queue a wake for one parked
        bulk-prefill waiter.  Caller holds ``self._lock``; the wake itself
        is delivered by :meth:`_flush_slot_wakes` after the lock drops
        (kernel calls are never made under the engine lock)."""
        if self._slot_waiters:
            self._slot_wakes.append(self._slot_waiters.popleft())

    def _flush_slot_wakes(self) -> None:
        with self._lock:
            if not self._slot_wakes:
                return
            wakes, self._slot_wakes = self._slot_wakes, []
        for job in wakes:
            self._wake_when_settled(job)

    def _wake_when_settled(self, job, delay: float = 0.001) -> None:
        """Wake a bulk-prefill job parked on slot exhaustion.  Normally it
        settled into BLOCKED long ago; if the wake races the job's own
        epilogue (state reads running/runnable for a moment after its chunk
        returned "blocked"), retry on a deferred timer -- waking a
        non-blocked job would double-dispatch it."""
        state = job.state.value
        if state == "blocked":
            self.kernel.wake(job)
        elif state != "exited":
            nxt = min(delay * 2, 0.05)
            self.kernel.executor.defer(
                nxt, lambda: self._wake_when_settled(job, nxt))

    # ------------------------------------------------------------ internals
    @contextmanager
    def _held(self):
        """Engine lock + hold-time sample (acquire-to-release, so the
        benchmark's decode-lock hold stat reflects actual exclusion, not
        wait time)."""
        with self._lock:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.stats.lock_hold_s.append(time.perf_counter() - t0)

    def _tokens(self, a):
        """Host int32 tokens -> tensor on the model's device."""
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _bulk_prefill_chunk(self, req: Request, job) -> str:
        try:
            return self._bulk_prefill_impl(req, job)
        finally:
            self._flush_slot_wakes()

    def _bulk_prefill_impl(self, req: Request, job) -> str:
        with self._lock:
            if req.error is not None or not self._running:
                # Failed (drain/deadline) or shutting down: deregister any
                # stale waiter entry so a future release is not wasted on a
                # job that will immediately exit.
                try:
                    self._slot_waiters.remove(job)
                except ValueError:
                    pass
                if req.error is None:
                    self._fail_locked(req, "shutdown")
                return "done"
            # Register as a slot waiter *before* trying to allocate: a
            # release racing this chunk can then never slip between a
            # failed alloc and the registration (that wake would be lost
            # and the job stranded).  Spurious wakes are harmless -- the
            # chunk just retries -- lost ones are not.
            if job not in self._slot_waiters:
                self._slot_waiters.append(job)
        slot = self.pool.alloc(job, str(req.rid))
        if slot is None:
            # Slot-exhausted: park until a release hands us the slot.
            # (The old path returned "yield" here; under load that
            # yield-spin of every queued bulk job starved the decode loop
            # that would have freed the slots -- a livelock.)
            return "blocked"
        with self._lock:
            try:
                self._slot_waiters.remove(job)
                consumed = False
            except ValueError:
                consumed = True  # a release notification popped us already
            if consumed:
                # We got a slot by allocation AND swallowed a wake meant
                # for a waiter: pass the signal on so it is not lost.
                self._notify_slot_free_locked()
        # Prefill outside the engine lock: it reads only immutable state
        # (params, the request's own prompt). The slot is reserved, so no
        # other writer targets this cache row until we publish it below.
        plen = len(req.prompt)
        batch = {"tokens": self._tokens(req.prompt[None, :])}
        logits, caches1 = self.model.prefill(self.params, batch, self.max_len)
        tok = int(logits[0, -1].argmax())  # sync outside lock
        wake = False
        with self._held():
            now = time.monotonic()
            if req.error is not None or not self._running:
                # Failed while we were prefilling (drain or deadline):
                # hand the reserved slot back and do not activate.
                self.pool.release(self._job, slot)
                self._notify_slot_free_locked()
                if req.error is None:
                    self._fail_locked(req, "shutdown")
            else:
                if self.overlap_decode:
                    self.caches = self._write_slots(
                        self.caches, caches1,
                        [slot])
                else:
                    self.caches = _write_slot(self.caches, caches1, slot)
                self._gen += 1           # new row published: stale decode
                self.lengths[slot] = plen
                req.tokens.append(tok)
                req.first_token = now
                req.token_times.append(now)
                self.active[slot] = req
                self._inflight_bulk.pop(req.rid, None)
                self.stats.bulk_prefills += 1
                wake = True
        if wake and self._job.state.value == "blocked":
            self.kernel.wake(self._job)
        return "done"

    # ----------------------------------------------------------- admission
    def _reserve_admissions_locked(self) -> list:
        """Pop admissible pending requests and reserve a pool slot for
        each; their prefill runs outside the lock.  Caller holds it."""
        admits = []
        while self.pending:
            slot = self.pool.alloc(self._job, str(self.pending[0].rid))
            if slot is None:
                break                        # pool exhausted: retry next chunk
            req = self.pending.popleft()
            req.slot = slot
            admits.append((req, slot))
        return admits

    def _prefill_admissions(self, admits: list) -> None:
        """Prefill + activate a batch of reserved admissions.  Compute runs
        outside the lock; activation re-checks ``_running`` under it (a
        drain between reservation and merge must fail the requests and
        return their slots, or they would be invisible to shutdown)."""
        if self.batched_admission and self._prefill_batch_fn is not None:
            self._prefill_admissions_batched(admits)
            return
        for req, slot in admits:
            batch = {"tokens": self._tokens(req.prompt[None, :])}
            logits, rows = self.model.prefill(self.params, batch, self.max_len)
            tok = int(logits[0, -1].argmax())
            with self._held():
                if not self._running:
                    self._fail_locked(req, "shutdown", slot=slot)
                    continue
                if self.overlap_decode:
                    self.caches = self._write_slots(
                        self.caches, rows, [slot])
                else:
                    self.caches = _write_slot(self.caches, rows, slot)
                self._gen += 1
                self._activate_locked(req, slot, tok, time.monotonic())

    def _prefill_admissions_batched(self, admits: list) -> None:
        """One padded prefill for all admitted prompts: rows are padded to
        ``max_batch`` and prompt length to a power-of-two bucket, so the
        call sees one shape per length bucket, not per batch shape.
        Padding rows carry slot index ``max_batch`` -- out of range, so the
        publish scatter drops them (``mode="drop"``; -1 would wrap)."""
        L = _next_pow2(max(len(r.prompt) for r, _ in admits))
        toks = np.zeros((self.max_batch, L), np.int32)
        lengths = np.ones((self.max_batch,), np.int32)
        slots = np.full((self.max_batch,), self.max_batch, np.int32)
        for i, (req, slot) in enumerate(admits):
            plen = len(req.prompt)
            toks[i, :plen] = req.prompt
            lengths[i] = plen
            slots[i] = slot
        batch = {"tokens": self._tokens(toks),
                 "lengths": self._tokens(lengths)}
        logits, rows = self._prefill_batch_fn(self.params, batch, self.max_len)
        first = logits[:, 0].argmax(dim=-1).cpu().numpy()  # host sync
        self.stats.batched_admissions += 1
        failed = []
        with self._held():
            if not self._running:
                failed = admits
            else:
                self.caches = self._write_slots(self.caches, rows,
                                                slots)
                self._gen += 1
                now = time.monotonic()
                for i, (req, slot) in enumerate(admits):
                    self._activate_locked(req, slot, int(first[i]), now)
            if failed:
                for req, slot in failed:
                    self._fail_locked(req, "shutdown", slot=slot)

    def _activate_locked(self, req: Request, slot: int, tok: int,
                         now: float) -> None:
        self.lengths[slot] = len(req.prompt)
        req.tokens.append(tok)
        req.first_token = now
        req.token_times.append(now)
        self.active[slot] = req
        self.stats.admitted += 1

    # ------------------------------------------------------------ mechanics
    def _decode_chunk(self, budget: float) -> str:
        try:
            if not self.overlap_decode:
                return self._decode_chunk_legacy(budget)
            return self._decode_chunk_impl(budget)
        finally:
            # Deliver any slot-free wakes queued while the lock was held
            # (finish / expiry released slots with bulk waiters parked).
            self._flush_slot_wakes()

    def _decode_chunk_impl(self, budget: float) -> str:
        # --- phase 1 (locked): expire + reserve admissions ---------------
        with self._held():
            self._expire_locked(time.monotonic())
            admits = self._reserve_admissions_locked() if self._running else []
        # --- phase 2 (unlocked): batched admission prefill ---------------
        if admits:
            self._prefill_admissions(admits)
        # --- phase 3 (locked): snapshot --------------------------------
        with self._held():
            if not self.active:
                if self._running and self.pending and self.pool.free:
                    # An arrival landed between admission (phase 1) and
                    # here while slots are free: retry immediately instead
                    # of parking over runnable work.  (Without free slots
                    # the pending work waits on a bulk merge, which wakes
                    # the loop itself -- yielding would just spin.)
                    return "yield"
                return "blocked" if self._running else "done"
            gen = self._gen
            caches = self.caches
            pos = int(self.lengths.max())
            toks = np.zeros((self.max_batch, 1), np.int32)
            snap_slots = []
            for slot, req in self.active.items():
                toks[slot, 0] = req.tokens[-1]
                snap_slots.append(slot)
        # --- phase 4 (unlocked): device decode + host sync ---------------
        logits, new_caches = self._decode(self.params, caches,
                                          self._tokens(toks), pos)
        nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
        # --- phase 5 (locked): merge or discard --------------------------
        with self._held():
            if self._gen != gen:
                # A concurrent admission/bulk merge published rows this
                # snapshot lacks; committing would lose their prefill
                # state.  Discard and retry -- per-row results for
                # still-active slots are recomputed next chunk.
                self.stats.decode_invalidations += 1
                return "yield"
            self.caches = new_caches
            self.stats.decode_steps += 1
            now = time.monotonic()
            finished = []
            for slot in snap_slots:
                req = self.active.get(slot)
                if req is None:
                    continue             # finished/expired mid-step: row is
                                         # free, clobbering it was harmless
                req.tokens.append(int(nxt[slot]))
                req.token_times.append(now)
                self.lengths[slot] += 1
                if (len(req.tokens) >= req.max_new_tokens
                        or self.lengths[slot] >= self.max_len - 1):
                    req.finished = now
                    finished.append(slot)
            for slot in finished:
                req = self.active.pop(slot)
                self.completed.append(req)
                req.done_event.set()
                self.pool.release(self._job, slot)
                self._notify_slot_free_locked()
                self.lengths[slot] = 0
            return ("yield" if (self.active or self.pending or self._running)
                    else "done")

    def _decode_chunk_legacy(self, budget: float) -> str:
        """Pre-overhaul chunk: admit + one batched decode step with the
        engine lock held for the whole read->decode->write cycle.  Kept as
        the serving benchmark's recorded baseline (``overlap_decode=False``)."""
        with self._held():
            self._expire_locked(time.monotonic())
            self._admit_locked()
            if not self.active:
                return "blocked" if self._running else "done"
            pos = int(self.lengths.max())
            toks = np.zeros((self.max_batch, 1), np.int32)
            for slot, req in self.active.items():
                toks[slot, 0] = req.tokens[-1]
            logits, self.caches = self._decode(self.params, self.caches,
                                               self._tokens(toks), pos)
            nxt = logits[:, 0].argmax(dim=-1).cpu().numpy()
            self.stats.decode_steps += 1
            now = time.monotonic()
            finished = []
            for slot, req in list(self.active.items()):
                req.tokens.append(int(nxt[slot]))
                req.token_times.append(now)
                self.lengths[slot] += 1
                if len(req.tokens) >= req.max_new_tokens or self.lengths[slot] >= self.max_len - 1:
                    req.finished = now
                    finished.append(slot)
            for slot in finished:
                req = self.active.pop(slot)
                self.completed.append(req)
                req.done_event.set()
                self.pool.release(self._job, slot)
                self._notify_slot_free_locked()
                self.lengths[slot] = 0
            return "yield" if (self.active or self.pending or self._running) else "done"

    def _admit_locked(self) -> None:
        """Legacy admission: prefill per-request *inside* the engine lock
        (prompts are short in the demo; long prompts become chunked prefill
        jobs in examples/mixed_serving.py). Caller holds ``self._lock``."""
        while self.pending:
            req = self.pending[0]
            slot = self.pool.alloc(self._job, str(req.rid))
            if slot is None:
                return                       # pool exhausted: retry next chunk
            self.pending.popleft()
            # single-request prefill into the pooled cache at `slot`
            batch = {"tokens": self._tokens(req.prompt[None, :])}
            logits, caches1 = self.model.prefill(self.params, batch, self.max_len)
            self.caches = _write_slot(self.caches, caches1, slot)
            tok = int(logits[0, -1].argmax())
            self._activate_locked(req, slot, tok, time.monotonic())


def _write_slot(pool_caches, single_caches, slot: int):
    """Copy a batch-1 cache tree into row ``slot`` of a new copy of the
    pooled caches.  The batch dim is the first dim where the single cache
    has size 1 and the pool has the pool size (layer dims of stacked
    segments match on both).  Legacy path -- the hot path uses the
    ``make_write_slots`` scatter."""
    def write(pool_leaf, one_leaf):
        for d in range(pool_leaf.dim()):
            if one_leaf.shape[d] == 1 and pool_leaf.shape[d] > 1:
                new = pool_leaf.clone()
                new.narrow(d, slot, 1).copy_(one_leaf.to(pool_leaf.dtype))
                return new
        return pool_leaf
    return tree_map(write, pool_caches, single_caches)
