"""The port's serving path on the CPU: its stub model against the reference
stub on the same weights, the cache-row scatter, and the reference's
engine scenarios (tests/test_serving_hotpath.py, tests/test_live_serving.py)
re-run on the port's engine under the port's copy of the UFS scheduler."""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.stub import TinyStubModel as JStub
from repro_torch.configs import get_arch
from repro_torch.core.live import LiveKernel
from repro_torch.core.policies import make_policy
from repro_torch.kernels.build import LaunchCounter
from repro_torch.launch import serve
from repro_torch.models.transformer import Model
from repro_torch.serving.engine import InferenceEngine, Request
from repro_torch.serving.kv_cache import cache_batch_axes, make_write_slots
from repro_torch.serving.stub import TinyStubModel


def _wait_for(cond, timeout=5.0, dt=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(dt)
    return cond()


def _stub_engine(max_batch=4, max_len=64, n_slots=2, **engine_kw):
    model = TinyStubModel(device="cpu")
    params = model.init_params(0)
    kernel = LiveKernel(n_slots, make_policy("ufs"),
                        **engine_kw.pop("kernel_kw", {}))
    engine = InferenceEngine(model, params, kernel,
                             max_batch=max_batch, max_len=max_len,
                             **engine_kw)
    return model, params, kernel, engine


def _direct_greedy(model, params, prompt, n_tokens, max_len=64):
    logits, caches = model.prefill(
        params, {"tokens": torch.from_numpy(prompt[None, :])}, max_len)
    toks = [int(logits[0, -1].argmax())]
    pos = len(prompt)
    while len(toks) < n_tokens:
        lg, caches = model.decode_step(
            params, caches, torch.tensor([[toks[-1]]], dtype=torch.int32), pos)
        toks.append(int(lg[0, 0].argmax()))
        pos += 1
    return toks


# ------------------------------------------------------ stub vs reference
def test_stub_matches_reference_stub():
    """Same numpy weights: prefill, batched prefill and decode logits within
    2e-5 of the reference stub, greedy tokens identical."""
    jm = JStub()
    jp = jm.init_params(5)
    tm = TinyStubModel(device="cpu")
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp))
    prompts = [np.arange(1, 1 + n, dtype=np.int32) for n in (3, 6, 2)]
    toks = np.zeros((3, 6), np.int32)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    jl, jc = jm.prefill_batch(jp, {"tokens": jnp.asarray(toks),
                                   "lengths": jnp.asarray(lengths)}, 64)
    tl, tc = tm.prefill_batch(tp, {"tokens": torch.from_numpy(toks),
                                   "lengths": torch.from_numpy(lengths)}, 64)
    assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 2e-5
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
        assert np.array_equal(nxt, tl[:, 0].argmax(-1).numpy()[:, None])
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), 6 + step)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), 6 + step)
        assert np.max(np.abs(tl.numpy() - np.asarray(jl))) < 2e-5
    jl1, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompts[1][None])}, 64)
    tl1, _ = tm.prefill(tp, {"tokens": torch.from_numpy(prompts[1][None])}, 64)
    assert np.max(np.abs(tl1.numpy() - np.asarray(jl1))) < 2e-5


def test_stub_batched_prefill_matches_single():
    """Right-padded batched prefill equals per-request prefill: each row's
    recurrent state is gathered at lengths-1."""
    model = TinyStubModel(device="cpu")
    params = model.init_params(3)
    prompts = [np.arange(1, 1 + n, dtype=np.int32) for n in (3, 5, 2)]
    toks = np.zeros((3, 8), np.int32)
    lengths = np.array([len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    blogits, bcache = model.prefill_batch(
        params, {"tokens": toks, "lengths": lengths}, 64)
    for i, p in enumerate(prompts):
        slogits, scache = model.prefill(params, {"tokens": p[None, :]}, 64)
        torch.testing.assert_close(blogits[i, 0], slogits[0, -1],
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(bcache["h"][i], scache["h"][0],
                                   rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ write slots
def test_write_slots_drops_sentinel_rows():
    """Slot index = pool size (the padding sentinel) is dropped, not
    written and not an error; the pool given is left as it was."""
    model = TinyStubModel(d_model=4, device="cpu")
    write = make_write_slots(cache_batch_axes(model, 16))
    pool = {"h": torch.zeros((4, 4))}
    rows = {"h": torch.ones((2, 4))}
    out = write(pool, rows, np.array([1, 4], np.int32))
    assert out["h"][1].tolist() == [1.0] * 4
    for r in (0, 2, 3):
        assert out["h"][r].tolist() == [0.0] * 4, f"row {r} clobbered"
    assert torch.count_nonzero(pool["h"]) == 0, "pool written in place"


def test_write_slots_on_model_cache_tree():
    """The stacked layer axis is skipped: the batch axis of a transformer
    cache leaf is axis 1, and rows land there."""
    cfg = get_arch("llama3.2-1b").reduced()
    model = Model(cfg, device="cpu")
    axes = cache_batch_axes(model, 8)
    assert axes == [{"k": 1, "v": 1}]
    pool = model.init_cache(3, 8)
    rows = [{n: torch.full_like(t[:, :2], 7.0) for n, t in pool[0].items()}]
    out = make_write_slots(axes)(pool, rows, [2, 3])
    assert torch.all(out[0]["k"][:, 2] == 7.0)
    assert torch.all(out[0]["k"][:, :2] == 0.0)


# ------------------------------------------------------- engine end-to-end
@pytest.mark.timeout(60)
def test_hotpath_engine_matches_direct_decode():
    """Overlapped decode + batched admission produce the same greedy tokens
    as a direct unscheduled prefill+decode loop, across a ragged batch."""
    model, params, kernel, engine = _stub_engine(max_batch=4)
    kernel.start()
    engine.start()
    prompts = [np.arange(1, 1 + n, dtype=np.int32) for n in (4, 7, 2)]
    reqs = [engine.submit(Request(prompt=p, max_new_tokens=6))
            for p in prompts]
    for r in reqs:
        assert r.done_event.wait(timeout=30)
        assert r.ok
    engine.stop()
    kernel.stop()
    for p, r in zip(prompts, reqs):
        assert r.tokens == _direct_greedy(model, params, p, 6)
    assert engine.stats.decode_steps > 0
    assert engine.stats.batched_admissions >= 1


@pytest.mark.timeout(60)
def test_legacy_modes_still_serve():
    """The baseline flags (lock across compute, per-request admission,
    polling dispatch) keep producing correct tokens."""
    model, params, kernel, engine = _stub_engine(
        max_batch=2, overlap_decode=False, batched_admission=False,
        kernel_kw={"dispatch": "polling"})
    kernel.start()
    engine.start()
    p = np.arange(1, 6, dtype=np.int32)
    r = engine.submit(Request(prompt=p, max_new_tokens=5))
    assert r.done_event.wait(timeout=30) and r.ok
    engine.stop()
    kernel.stop()
    assert r.tokens == _direct_greedy(model, params, p, 5)


@pytest.mark.timeout(60)
def test_decode_snapshot_invalidated_by_concurrent_publish():
    """If the generation counter moves between snapshot and merge, the
    decode step is discarded (not committed over the newer rows) and
    retried -- tokens stay correct and the discard is counted."""
    model, params, kernel, engine = _stub_engine(max_batch=2)
    orig = engine._decode
    fired = []

    def bump_after_decode(prms, caches, toks, pos):
        out = orig(prms, caches, toks, pos)
        if not fired:
            fired.append(1)
            with engine._lock:          # simulate a concurrent row publish
                engine._gen += 1
        return out

    engine._decode = bump_after_decode
    kernel.start()
    engine.start()
    p = np.arange(1, 5, dtype=np.int32)
    r = engine.submit(Request(prompt=p, max_new_tokens=5))
    assert r.done_event.wait(timeout=30) and r.ok
    engine.stop()
    kernel.stop()
    assert engine.stats.decode_invalidations == 1
    assert r.tokens == _direct_greedy(model, params, p, 5)


@pytest.mark.timeout(60)
def test_bulk_prefill_vs_decode_under_slot_exhaustion():
    """More bulk requests than cache slots: prefill jobs park until decode
    frees a slot; everyone completes and the pool drains back to full."""
    model, params, kernel, engine = _stub_engine(max_batch=2)
    kernel.start()
    engine.start()
    reqs = [engine.submit(Request(prompt=np.arange(1, 4, dtype=np.int32),
                                  tier="background", max_new_tokens=4))
            for _ in range(5)]
    for r in reqs:
        assert r.done_event.wait(timeout=30), "bulk request starved"
        assert r.ok, r.error
    engine.stop()
    kernel.stop()
    assert sorted(engine.pool.free) == [0, 1]
    assert engine.stats.bulk_prefills == 5
    expect = _direct_greedy(model, params, np.arange(1, 4, dtype=np.int32), 4)
    for r in reqs:
        assert r.tokens == expect


@pytest.mark.timeout(60)
def test_stop_drain_fails_inflight_bulk():
    """A background submit() whose prefill has not landed a slot fails with
    error='shutdown' at stop(drain=True) instead of hanging."""
    model, params, kernel, engine = _stub_engine(max_batch=1, max_len=4096)
    kernel.start()
    engine.start()
    blocker = engine.submit(Request(prompt=np.arange(1, 4, dtype=np.int32),
                                    max_new_tokens=100_000))
    assert _wait_for(lambda: len(engine.active) == 1)
    bulk = engine.submit(Request(prompt=np.arange(1, 4, dtype=np.int32),
                                 tier="background", max_new_tokens=4))
    assert _wait_for(lambda: bulk.rid in engine._inflight_bulk)
    engine.stop()
    assert bulk.done_event.wait(timeout=5), "in-flight bulk leaked at drain"
    assert bulk.error == "shutdown" and not bulk.ok
    assert blocker.done_event.wait(timeout=5)
    assert blocker.error == "shutdown"
    assert _wait_for(lambda: sorted(engine.pool.free) == [0])
    kernel.stop()


@pytest.mark.timeout(120)
def test_engine_output_matches_direct_decode_reduced_llama():
    """Engine greedy tokens == direct prefill+decode loop on the reduced
    transformer (cache pooling, padding and the shared decode position are
    transparent for a single request)."""
    cfg = get_arch("llama3.2-1b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    prompt = np.arange(1, 7, dtype=np.int32)
    toks = _direct_greedy(model, params, prompt, 4, max_len=48)
    kernel = LiveKernel(1, make_policy("ufs"))
    engine = InferenceEngine(model, params, kernel, max_batch=2, max_len=48)
    kernel.start()
    engine.start()
    r = engine.submit(Request(prompt=prompt, max_new_tokens=4))
    assert r.done_event.wait(timeout=60)
    engine.stop()
    kernel.stop()
    assert r.ok
    assert r.tokens[:4] == toks


def test_serve_reduced_flag_can_be_turned_off():
    """The reference driver's --reduced cannot be turned off; the port's
    defaults to the reduced config and --no-reduced asks for full width."""
    assert serve.parse_args([]).reduced is True
    assert serve.parse_args(["--no-reduced"]).reduced is False
    assert serve.parse_args([]).device == "cuda"


@pytest.mark.timeout(120)
def test_serve_driver_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--arch", "llama3.2-1b", "--requests", "2",
                "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "completed 2/2 requests" in out


def test_launch_counter_exact_under_threads():
    """The kernel wrappers' launch counters are shared by serving threads:
    concurrent adds must not lose updates."""
    counter = LaunchCounter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [counter.add()
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.count == 16 * 2000
    counter.reset()
    assert counter.count == 0
