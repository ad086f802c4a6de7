"""The span readers (``bench/metrics/decode_*``, ``benchlib/spans.py``) on
a made-up run with known answers, on the harness's run as it is (no
spans: nothing to read, no error), and on a tiny traced window on the CPU
(``bench/attribution.py``), where the chunk reading needs no card."""
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import attribution  # noqa: E402
from benchlib import discover, manifest as M, spans  # noqa: E402
from repro_torch.core.trace import SpanRecord  # noqa: E402
from test_bench_reference import tiny  # noqa: E402

MAN = M.load(BENCH.parent / "BENCHMARK.json")
CELL = "llama-3-8b-1slot.azure-chat-batch"
SEED = 2 ** 31 + 4321
MS = 1_000_000                        # ns
DECODE, BULK = 7, 8                   # native thread ids of the spans
P_DECODE, P_BULK = 107, 108           # the profiler's ids of those threads
P_CLOCK = 109                         # a thread that makes no spans


def _span(name, t0_ms, t1_ms, sid, parent=-1, tid=DECODE, **args):
    return SpanRecord(name, t0_ms / 1e3, t1_ms / 1e3, sid, parent, tid,
                      args or None)


def _made_up_run():
    """Two decode steps on one thread and a bulk prefill on another.

    Step 1, 0-10 ms: model.decode_step 0.5-8 holding model.layer 1-7,
    which holds attn.k2 2-4; engine.sync 8.2-9.8.  Step 2, 20-30 ms:
    model.decode_step 20.5-28; engine.sync 28.2-29.8.  The device runs
    0-1.5, 3-5, 9-9.9 and 21-27.9 ms.  The bulk thread's prefills at
    1.9, 24.9 and 34.9 ms each make one call."""
    sp = [
        _span("engine.decode_chunk", -0.5, 10.5, 0, jid=1, rids=[1],
              outcome="merged"),
        _span("engine.decode", 0, 10, 1, 0, pos=5),
        _span("model.decode_step", 0.5, 8, 2, 1),
        _span("model.layer", 1, 7, 3, 2, index=0),
        _span("attn.k2", 2, 4, 4, 3),
        _span("engine.sync", 8.2, 9.8, 5, 1),
        _span("engine.decode_chunk", 19.5, 30.5, 6, jid=1, rids=[1],
              outcome="merged"),
        _span("engine.decode", 20, 30, 7, 6, pos=6),
        _span("model.decode_step", 20.5, 28, 8, 7),
        _span("engine.sync", 28.2, 29.8, 9, 7),
        _span("engine.decode_chunk", 31, 31.5, 10, jid=1, rids=[1],
              outcome="blocked"),
        _span("engine.bulk_prefill", 1.9, 2.2, 11, tid=BULK, rid=2),
        _span("engine.bulk_prefill", 24.9, 25.2, 13, tid=BULK, rid=4),
        _span("engine.bulk_prefill", 34.9, 35.2, 14, tid=BULK, rid=5),
        SpanRecord("request.queued", 0.0, 0.035, 12, -1, DECODE,
                   {"rid": 3, "tier": "time-sensitive"}, True),
    ]
    calls = [
        # step 1: two launches, the RoPE copy's wait, the argmax's wait
        (int(1.2 * MS), int(1.3 * MS), "cudaLaunchKernel", P_DECODE),
        (int(2.5 * MS), int(2.6 * MS), "cudaLaunchKernel", P_DECODE),
        (int(3.0 * MS), int(3.1 * MS), "cudaMemcpyAsync", P_DECODE),
        (int(3.1 * MS), int(3.2 * MS), "cudaStreamSynchronize", P_DECODE),
        (int(8.3 * MS), int(9.5 * MS), "cudaStreamSynchronize", P_DECODE),
        # step 2: one launch, the argmax's wait ends past engine.sync
        (int(20.6 * MS), int(20.7 * MS), "cuLaunchKernel", P_DECODE),
        (int(28.3 * MS), int(29.9 * MS), "cudaStreamSynchronize", P_DECODE),
        # the bulk thread, inside both steps' times: not the steps' calls
        (int(2.0 * MS), int(2.1 * MS), "cudaLaunchKernel", P_BULK),
        (int(25.0 * MS), int(25.1 * MS), "cudaStreamSynchronize", P_BULK),
        (int(35.0 * MS), int(35.1 * MS), "cudaLaunchKernel", P_BULK),
        # a thread with no spans, timing the clocks inside both steps
        (int(6.0 * MS), int(6.01 * MS), "cudaStreamQuery", P_CLOCK),
        (int(27.95 * MS), int(27.96 * MS), "cudaStreamQuery", P_CLOCK),
    ]
    ops = [(0, int(1.5 * MS)), (3 * MS, 5 * MS), (9 * MS, int(9.9 * MS)),
           (21 * MS, int(27.9 * MS))]
    tl = SimpleNamespace(device_ops=ops, host_calls=sorted(calls),
                         offset_ns=[], window_ns=(-MS, 30 * MS))
    return SimpleNamespace(spans=sp, span_ns=lambda t: round(t * 1e9),
                           timeline=tl)


def _read(name, run):
    return discover.metric_reader(name)(run)


def test_readers_on_a_made_up_run():
    run = _made_up_run()
    # chunks that merged a step: 11 ms each
    assert _read("decode_chunk_p95_ms", run) == pytest.approx(11.0)
    # idle in step 1: 1.5-3 and 5-9 in model.layer, 9.9-10 after
    # engine.sync; step 2: 20-21 before model.decode_step, 27.9-30 in it
    # (8.7 ms of 20)
    assert _read("decode_step_idle_pct", run) == pytest.approx(43.5)
    assert _read("decode_launches_per_step", run) == pytest.approx(2.0)
    assert _read("decode_syncs_per_step", run) == pytest.approx(1.5)
    v = spans.step_view(run)
    assert v.tids == {P_DECODE: DECODE, P_BULK: BULK}
    assert v.sync_outside == [(pytest.approx(0.1 * MS, abs=1), 20 * MS)]
    assert v.idle_by_span == pytest.approx({
        "model.layer": 5.5 * MS, "model.decode_step": 2.1 * MS,
        "engine.decode": 1.1 * MS})
    assert sum(v.idle_by_span.values()) == pytest.approx(v.idle_ns)
    # step 1's argmax wait lies inside engine.sync, step 2's 0.1 ms past it
    assert v.sync_inside == 1
    lines = spans.gap_lines(v)
    assert len(lines) == 5
    assert lines[0] == ("4.000 ms in model.layer {'index': 0}: "
                        "cudaStreamSynchronize x1")
    assert lines[1] == ("2.100 ms in model.decode_step: "
                        "cudaStreamSynchronize x1")
    assert lines[2] == ("1.500 ms in model.layer {'index': 0}: "
                        "cudaLaunchKernel x1")
    assert lines[3] == ("1.000 ms in engine.decode {'pos': 6}: "
                        "cuLaunchKernel x1")
    assert lines[4] == "0.100 ms in engine.decode {'pos': 5}: no runtime call"


def test_the_report_of_a_made_up_run(capsys):
    run = _made_up_run()
    run.timeline.notes = []
    run.collections = [(2, 0.005, 0.0085)]       # over step 1's 5-9 ms gap
    run.window = SimpleNamespace(t_open=100.0, t_open_ns=10**18)
    tracer = SimpleNamespace(spans=run.spans, spans_dropped=0,
                             anchor_mono=99.0,
                             to_wall_ns=lambda t: 10**18 + round((t - 1) * 1e9))
    out = attribution.report(run, tracer, [])
    assert out["metrics"]["decode_syncs_per_step"] == pytest.approx(1.5)
    got = out["attribution"]
    assert (got["steps"], got["sync_inside"]) == (2, 1)
    assert got["covered_pct"] == pytest.approx(100 * 5.5 / 8.7)
    err = capsys.readouterr().err
    assert "wall clock at its open (ns): 0" in err
    assert "argmax sync inside engine.sync in 1 of 2 steps" in err
    assert ("4.000 ms in model.layer {'index': 0}: cudaStreamSynchronize x1;"
            " collection: gen 2 3.500 ms") in err


def test_clock_points_follow_a_wandering_offset():
    """The profiler's clock runs 0.6 ms behind the host's, then 1.5 ms
    behind, then level: each mark is found, and a time between two marks
    gets the offset between theirs."""
    offset = {1_000 * MS: -600_000, 1_100 * MS: -1_500_000,
              1_200 * MS: 40_000}
    marks, calls = [], []
    for host, off in offset.items():
        marks.append((host - 2_000, host + 2_000, "cudaStreamQuery"))
        calls.append((host + off - 500, host + off + 500, "cudaStreamQuery",
                      9))
        # another thread's query 4 ms off: not the one the mark timed
        calls.append((host + off + 4 * MS, host + off + 4 * MS + 500,
                      "cudaStreamQuery", 8))
        calls.append((host + off - 300, host + off, "cudaLaunchKernel", 9))
    # a mark held up 3 ms by a pause of the host places nothing
    marks.append((1_150 * MS, 1_153 * MS, "cudaStreamQuery"))
    calls.append((1_151 * MS, 1_151 * MS + 500, "cudaStreamQuery", 9))
    points = spans.clock_points(marks, sorted(calls))
    assert points == sorted(offset.items())
    to_prof = spans.to_profiler(points)
    assert to_prof(1_050 * MS) == 1_050 * MS - 1_050_000
    assert to_prof(900 * MS) == 900 * MS - 600_000
    assert to_prof(1_300 * MS) == 1_300 * MS + 40_000
    assert spans.to_profiler([])(5) == 5


def test_readers_read_nothing_from_the_harness_run():
    """The harness's run carries no spans and its timeline no device
    intervals: every span reader returns None."""
    run = SimpleNamespace(timeline=SimpleNamespace(window_s=1.0))
    for name in attribution.SPAN_METRICS:
        assert _read(name, run) is None


def test_a_tiny_traced_window_on_the_cpu():
    run, tracer = attribution.traced_window(
        MAN, BENCH.parent, CELL, SEED, 2.0, device="cpu",
        cfg=tiny("llama-3-8b-1slot"), rates={"time-sensitive": 2.0},
        drain_s=30.0)
    assert run.window.decode_steps > 0
    assert run.spans and tracer.spans_dropped == 0
    p95 = _read("decode_chunk_p95_ms", run)
    assert p95 is not None and p95 > 0
    merged = spans.chunk_ms(run)
    assert len(merged) >= run.window.decode_steps - 1
    assert min(merged) <= p95 <= max(merged)
    assert run.timeline is None
    assert _read("decode_step_idle_pct", run) is None
    assert all(run.window.t_open <= tracer.anchor_mono + s.t0
               < run.window.t_close for s in run.spans)
    assert run.span_ns(0.0) == tracer.anchor_ns
    assert time.time_ns() - run.span_ns(run.spans[-1].t1) > 0
