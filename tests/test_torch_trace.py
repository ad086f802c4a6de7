"""Program spans in the port's tracer, on the CPU: how they nest and what
they carry through a served request, one clock with the scheduler's
events and the wall clock, the Chrome export, the ring's drop count, and
no span made where no tracer is bound."""
import json
import time

import numpy as np
import pytest

from repro_torch.configs import get_arch
from repro_torch.core import (SchedTracer, bind_thread, build_kernel, span,
                              to_chrome_trace, validate_chrome_trace)
from repro_torch.core import trace
from repro_torch.core.trace import busy_intervals
from repro_torch.launch import serve
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import InferenceEngine, Request


class _Stamped:
    """The model as the engine sees it, stamping ``time.time_ns()`` inside
    every decode step."""

    def __init__(self, model):
        self._model = model
        self.stamps = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, params, caches, token, pos):
        self.stamps.append(time.time_ns())
        return self._model.decode_step(params, caches, token, pos)


def _serve(tracer, tiers=("time-sensitive", "background"), new_tokens=4):
    """Serve one request of each tier, one after the other, through a
    reduced llama on the live kernel; returns the kernel, the stamping
    model and the requests."""
    cfg = get_arch("llama3.2-1b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    stamped = _Stamped(model)
    kernel = build_kernel("live", policy="ufs", n_slots=2, tracer=tracer)
    engine = InferenceEngine(stamped, params, kernel, max_batch=1,
                             max_len=64)
    kernel.start()
    engine.start()
    reqs = []
    try:
        for i, tier in enumerate(tiers):
            prompt = np.arange(1, 6 + 3 * i, dtype=np.int32)
            req = engine.submit(Request(prompt=prompt, tier=tier,
                                        max_new_tokens=new_tokens))
            assert req.done_event.wait(timeout=60)
            reqs.append(req)
    finally:
        engine.stop()
        kernel.stop()
    return kernel, stamped, reqs


@pytest.fixture(scope="module")
def served():
    tracer = SchedTracer(capacity=1 << 16)
    kernel, stamped, reqs = _serve(tracer)
    assert all(r.ok for r in reqs), [r.error for r in reqs]
    return tracer, kernel, stamped, reqs


def test_spans_nest_under_their_parents(served):
    tracer, _, _, _ = served
    spans = tracer.spans
    by_id = {s.sid: s for s in spans}
    parents = {
        "engine.admit": {"engine.decode_chunk"},
        "engine.decode": {"engine.decode_chunk"},
        "engine.sync": {"engine.decode"},
        "engine.lock": {"engine.decode_chunk", "engine.admit",
                        "engine.bulk_prefill"},
        "model.decode_step": {"engine.decode"},
        "model.embed": {"model.decode_step"},
        "model.views": {"model.decode_step"},
        "model.layer": {"model.decode_step"},
        "model.logits": {"model.decode_step"},
        "attn.qkv": {"model.layer"}, "attn.rope": {"model.layer"},
        "attn.cache_copy": {"model.layer"}, "attn.kv_write": {"model.layer"},
        "attn.k2": {"model.layer"}, "attn.out": {"model.layer"},
        "layer.mlp": {"model.layer"},
    }
    seen = {s.name for s in spans}
    assert set(parents) | {"engine.decode_chunk", "engine.bulk_prefill",
                           "request.queued"} <= seen
    for s in spans:
        assert s.t0 <= s.t1
        if s.name in parents:
            parent = by_id[s.parent]
            assert parent.name in parents[s.name], (s, parent)
            assert parent.tid == s.tid
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1
        else:
            assert s.parent == -1, s
    layers = [s.args["index"] for s in spans if s.name == "model.layer"]
    n = get_arch("llama3.2-1b").reduced().n_layers
    assert layers == list(range(n)) * (len(layers) // n)


def test_one_requests_spans_share_its_rid(served):
    tracer, _, _, (ts, bulk) = served
    spans = tracer.spans
    queued = {s.args["rid"]: s for s in spans if s.name == "request.queued"}
    assert queued[ts.rid].args["tier"] == "time-sensitive"
    assert queued[bulk.rid].args["tier"] == "background"
    assert all(s.detached for s in queued.values())
    admits = [s for s in spans if s.name == "engine.admit"]
    assert [s.args["rids"] for s in admits] == [[ts.rid]]
    assert [s.args["rid"] for s in spans
            if s.name == "engine.bulk_prefill"] == [bulk.rid]
    # every token after a request's first is one merged decode step
    for req in (ts, bulk):
        merged = [s for s in spans if s.name == "engine.decode_chunk"
                  and s.args.get("outcome") == "merged"
                  and req.rid in s.args["rids"]]
        assert len(merged) == len(req.tokens) - 1
        assert all(s.args["jid"] >= 0 for s in merged)
    outcomes = {s.args.get("outcome") for s in spans
                if s.name == "engine.decode_chunk"}
    assert outcomes <= {"merged", "discarded", "blocked", "yield"}


def test_spans_and_events_lie_on_one_clock(served):
    tracer, kernel, stamped, _ = served
    runs = [iv for ivs in busy_intervals(tracer.events).values()
            for iv in ivs]
    chunks = [s for s in tracer.spans if s.name == "engine.decode_chunk"]
    assert chunks
    for s in chunks:
        # the chunk runs between its job's start_job and stop_job events
        assert any(iv["jid"] == s.args["jid"]
                   and iv["start"] <= s.t0 and s.t1 <= iv["stop"]
                   for iv in runs), s
    # the anchor maps a span to the wall clock read inside it
    steps = [s for s in tracer.spans if s.name == "engine.decode"]
    assert len(steps) == len(stamped.stamps)
    for s, wall in zip(steps, stamped.stamps):
        assert (tracer.to_wall_ns(s.t0) - 1_000_000 <= wall
                <= tracer.to_wall_ns(s.t1) + 1_000_000)
    assert tracer.anchor_mono == kernel.executor._t0


def test_chrome_export_with_spans_validates(served, tmp_path):
    tracer, kernel, _, reqs = served
    spans = tracer.spans
    doc = to_chrome_trace(tracer.events, end=kernel.now, spans=spans)
    assert validate_chrome_trace(doc) == len(doc["traceEvents"])
    got = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    assert len(got) == len(spans)
    requests = {e["tid"] for e in got if e["pid"] == trace.PID_REQUESTS}
    assert requests == {r.rid for r in reqs}
    threads = {e["tid"] for e in got if e["pid"] == trace.PID_THREADS}
    assert threads == {s.tid for s in spans if not s.detached}
    # without spans the export is what it was
    bare = to_chrome_trace(tracer.events, end=kernel.now)
    assert not [e for e in bare["traceEvents"]
                if e["pid"] in (trace.PID_THREADS, trace.PID_REQUESTS)]
    summary = tracer.summary()
    assert (summary.spans, summary.spans_dropped) == (len(spans), 0)


def test_the_span_ring_counts_its_drops():
    tracer = SchedTracer(capacity=4)
    prev = bind_thread(tracer)
    try:
        for i in range(10):
            with span("outer", "i", i) as outer:
                with span("inner") as inner:
                    assert inner.parent == outer.sid
    finally:
        bind_thread(prev)
    assert len(tracer.spans) == 4
    assert tracer.spans_dropped == 16
    summary = tracer.summary()
    assert (summary.spans, summary.spans_dropped) == (4, 16)
    assert summary.to_dict()["spans_dropped"] == 16
    assert [s.args["i"] for s in tracer.spans if s.name == "outer"] == [8, 9]
    tracer.clear()
    assert (tracer.spans, tracer.spans_dropped) == ([], 0)


def test_no_span_is_made_without_a_tracer(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was made with no tracer bound")
    monkeypatch.setattr(trace.Span, "__init__", refuse)
    monkeypatch.setattr(trace.SpanRecord, "__new__", refuse)
    assert trace.thread_tracer() is None
    with span("anything", "rid", 1) as sp:
        assert sp is None
    _, stamped, reqs = _serve(None, new_tokens=3)
    assert all(r.ok and len(r.tokens) == 3 for r in reqs)
    assert stamped.stamps


@pytest.mark.timeout(120)
def test_serve_trace_out_holds_the_spans(tmp_path, capsys):
    out = tmp_path / "trace.json"
    serve.main(["--device", "cpu", "--arch", "llama3.2-1b", "--requests", "2",
                "--max-new-tokens", "3", "--trace-out", str(out)])
    assert "completed 2/2 requests" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    validate_chrome_trace(doc)
    names = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "span"}
    assert {"engine.decode_chunk", "engine.decode", "model.layer",
            "attn.k2", "request.queued"} <= names
