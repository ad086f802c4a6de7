"""Drive the port's serving entry for one window: the UFS live kernel, an
``InferenceEngine`` over a thin proxy of the model, the cell's traffic
offered by one generator thread (this one), and the records the
statistics and the check read afterwards.

The proxy forwards ``prefill``, ``prefill_batch`` and ``decode_step``
unchanged and logs each call: its shape (rows, tokens, decode position),
its thread and its host interval, by which the traced run attributes
device time to step kinds (``profiling``).  It changes nothing the program
computes.  (A ``record_function`` range would not serve: the profiler
records host operations only on the thread that started it, and the
engine calls the model from the scheduler's threads.)
"""
from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field



@dataclass
class Call:
    kind: str             # prefill | prefill_batch | decode_step
    t: float              # host monotonic time of the call
    rows: int
    tokens: int           # positions per row (1 for a decode step)
    pos: int = 0          # decode position shared by the batch
    tid: int = 0          # native id of the calling thread
    t0_ns: int = 0        # wall-clock ns at the call and at its return
    t1_ns: int = 0


class Proxy:
    """The model as the engine sees it; every other attribute is the
    model's own."""

    def __init__(self, model):
        self._model = model
        self.calls: list = []
        self._mu = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _call(self, kind, fn, rows, n, pos, *args):
        call = Call(kind, time.monotonic(), int(rows), int(n), int(pos),
                    threading.get_native_id(), time.time_ns())
        try:
            return fn(*args)
        finally:
            call.t1_ns = time.time_ns()
            with self._mu:
                self.calls.append(call)

    def prefill(self, params, batch, smax):
        rows, n = batch["tokens"].shape
        return self._call("prefill", self._model.prefill, rows, n, 0,
                          params, batch, smax)

    def prefill_batch(self, params, batch, smax):
        rows, n = batch["tokens"].shape
        return self._call("prefill_batch", self._model.prefill_batch, rows,
                          n, 0, params, batch, smax)

    def decode_step(self, params, caches, token, pos):
        return self._call("decode_step", self._model.decode_step,
                          token.shape[0], 1, pos, params, caches, token, pos)


@dataclass
class Rec:
    """One offered request: the generator's item, when it was due and
    sent, and the engine's ``Request`` it became."""
    item: object
    due: float
    sent: float
    req: object

    @property
    def tier(self):
        return self.item.tier

    @property
    def prompt(self):
        return self.item.prompt

    @property
    def ok(self):
        return self.req.ok and len(self.req.tokens) == self.item.new_tokens

    @property
    def first_token(self):
        return self.req.first_token

    @property
    def token_times(self):
        return self.req.token_times

    @property
    def tokens(self):
        return self.req.tokens


@dataclass
class Window:
    t_open: float
    t_close: float
    t_open_ns: int = 0        # wall-clock ns at t_open
    records: list = field(default_factory=list)
    lateness: list = field(default_factory=list)
    decode_steps: int = 0
    lock_holds: list = field(default_factory=list)
    unfinished: int = 0


class Server:
    """The engine and its scheduler kernel for one run."""

    def __init__(self, model, params, engine_cfg: dict, *,
                 trace_scheduler: bool):
        from repro_torch import core
        from repro_torch.serving.engine import InferenceEngine, Request
        self.Request = Request
        self.proxy = Proxy(model)
        # traced runs keep the two scheduler events the dispatch-wait
        # metric reads, in a ring large enough for a window and its drain
        tracer = (core.SchedTracer(capacity=1 << 21,
                                   kinds=("enqueue", "start_job"))
                  if trace_scheduler else None)
        self.kernel = core.build_kernel("live", policy=engine_cfg["policy"],
                                        n_slots=engine_cfg["n_slots"],
                                        tracer=tracer)
        # the live kernel's clock (its tracer's) is seconds since it was
        # built; this offset turns it into host monotonic time
        self.clock_offset = time.monotonic() - self.kernel.now
        self.panics: list = []
        self.kernel.on_panic = self._panicked
        self.engine = InferenceEngine(self.proxy, params, self.kernel,
                                      max_batch=engine_cfg["max_batch"],
                                      max_len=engine_cfg["max_len"])
        self.kernel.start()
        self.engine.start()

    def _panicked(self, job) -> None:
        """A scheduled job of the program raised: record and report it (the
        kernel contains the fault; its requests then never finish)."""
        self.panics.append((job.name, job.last_panic))
        log(f"panic in {job.name}: {job.last_panic}")

    def submit(self, item, due: float) -> Rec:
        req = self.Request(prompt=item.prompt, max_new_tokens=item.new_tokens,
                           tier=item.tier, weight=item.weight)
        sent = time.monotonic()
        self.engine.submit(req)
        return Rec(item, due, sent, req)

    def stop(self) -> None:
        try:
            self.engine.stop()
        finally:
            self.kernel.stop()


def warm(server: Server, items, timeout: float = 240.0) -> None:
    """Serve the mix's warm-up requests one at a time, each to its end."""
    for it in items:
        rec = server.submit(it, time.monotonic())
        end = time.monotonic() + timeout
        while not rec.req.done_event.wait(0.5):
            if server.panics or time.monotonic() > end:
                break
        if not rec.ok:
            raise RuntimeError(f"warm-up request failed: tier {it.tier}, "
                               f"prompt {len(it.prompt)}, {rec.req.error}, "
                               f"panics {server.panics}")


def run_window(server: Server, traffic, seconds: float, *,
               drain_s: float = 60.0, on_close=None) -> Window:
    """Offer the traffic for ``seconds``: open tiers at their due times,
    closed tiers kept at their outstanding count.  At the close call
    ``on_close``, then wait (up to ``drain_s``) for every request sent to
    finish.

    The generator sleeps until the next due time or until a closed-tier
    request completes: one watcher thread a closed-tier request blocks on
    its ``done_event`` and wakes it, so nothing polls beside the engine's
    threads."""
    stats = server.engine.stats
    steps0 = stats.decode_steps
    holds0 = len(stats.lock_hold_s)
    opened = traffic.open_items()
    closed = traffic.closed_tiers()
    wake = threading.Condition()
    done: list = []                      # (tier index, slot) completed

    def watch(rec, k, j):
        rec.req.done_event.wait()
        with wake:
            done.append((k, j))
            wake.notify()

    def send(k, j, due):
        rec = server.submit(traffic.closed(k, nxt[k]), due)
        nxt[k] += 1
        threading.Thread(target=watch, args=(rec, k, j), daemon=True,
                         name="bench-watch").start()
        return rec

    t_open = time.monotonic()
    w = Window(t_open, t_open + seconds, time.time_ns())
    t_close = w.t_close
    nxt = {k: 0 for k, _ in closed}
    for k, tier in closed:
        for j in range(int(tier["outstanding"])):
            w.records.append(send(k, j, t_open))
    i = 0
    while True:
        now = time.monotonic()
        if now >= t_close:
            break
        while i < len(opened) and t_open + opened[i].due <= now:
            due = t_open + opened[i].due
            rec = server.submit(opened[i], due)
            w.lateness.append(rec.sent - due)
            w.records.append(rec)
            i += 1
        with wake:
            ready, done[:] = list(done), []
        for k, j in ready:
            w.records.append(send(k, j, now))
        until = t_close if i >= len(opened) else min(
            t_close, t_open + opened[i].due)
        with wake:
            if not done:
                wake.wait(max(0.0, until - time.monotonic()))
    if on_close is not None:
        on_close()
    w.decode_steps = stats.decode_steps - steps0
    holds = list(stats.lock_hold_s)
    w.lock_holds = holds[holds0:] if len(holds) >= holds0 else holds
    deadline = time.monotonic() + drain_s
    for rec in w.records:
        if not rec.req.done_event.wait(max(0.0, deadline - time.monotonic())):
            w.unfinished += 1
    return w


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)

