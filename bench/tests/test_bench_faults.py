"""A whole run of a cell at a tiny size on the CPU (the harness's look for
a chip skipped), first as it is, then with the timed path broken
underneath: ``correct`` has to come out true, then false for each fault a
serving cell can have.  Also the control at this size: the reference in
fp8 reads wider gaps than the program's float32 plain path."""
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib import cellrun, manifest as M  # noqa: E402
from test_bench_reference import tiny  # noqa: E402

MAN = M.load(BENCH.parent / "BENCHMARK.json")
SEED = 2 ** 31 + 4321


def run(name, control=(), seconds=2.0):
    return cellrun.run_cell(MAN, BENCH.parent, f"{name}.azure-chat-batch",
                            SEED, seconds, False, device="cpu",
                            t_proc_start=time.time(), cfg=tiny(name),
                            rates={"time-sensitive": 2.0}, drain_s=30.0,
                            control=control)


def _state_unchanged(model_cls):
    real = model_cls.decode_step

    def step(self, params, caches, token, pos):
        logits, _ = real(self, params, caches, token, pos)
        return logits, caches
    return step


def _token_altered(model_cls):
    real = model_cls.decode_step

    def step(self, params, caches, token, pos):
        logits, new = real(self, params, caches, token, pos)
        top = logits.argmax(-1, keepdim=True)
        wrong = (top + 1) % logits.shape[-1]
        return logits.scatter(-1, wrong, logits.amax(-1, keepdim=True) + 1.0), new
    return step


def _first_token_altered(model_cls):
    real = model_cls.prefill_batch

    def prefill_batch(self, params, batch, smax):
        logits, caches = real(self, params, batch, smax)
        wrong = (logits.argmax(-1, keepdim=True) + 3) % logits.shape[-1]
        return logits.scatter(-1, wrong, logits.amax(-1, keepdim=True) + 1.0), caches
    return prefill_batch


@pytest.mark.parametrize("name", ["llama-3-8b-1slot"])
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["readings"]["max_logit_gap"] < 1e-3
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {x["name"] for x in M.metrics_for(MAN, "end_to_end",
                                             f"{name}.azure-chat-batch")}
    assert set(out["metrics"]) == want


@pytest.mark.parametrize("fault,method", [
    (_state_unchanged, "decode_step"),
    (_token_altered, "decode_step"),
    (_first_token_altered, "prefill_batch")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, method):
    from repro_torch.models.transformer import Model
    monkeypatch.setattr(Model, method, fault(Model))
    out = run("llama-3-8b-1slot")
    assert not out["correct"], out["checks"]


def test_rows_decoded_at_another_rows_position_are_not_correct():
    """The fault that keeps the port's engine to one row: two rows of
    different lengths decoded at the longer one's position."""
    cfg = tiny("llama-3-8b-1slot")
    cfg["engine"]["max_batch"] = 8
    out = cellrun.run_cell(MAN, BENCH.parent, "llama-3-8b-1slot.azure-chat-batch",
                           SEED, 2.0, False, device="cpu",
                           t_proc_start=time.time(), cfg=cfg,
                           rates={"time-sensitive": 2.0}, drain_s=30.0)
    assert not out["correct"]
    assert out["readings"]["max_logit_gap"] > 1.0


def test_the_control_reads_wider_than_the_program():
    out = run("llama-3-8b-1slot", control=("fp8",))
    prog, ctrl = out["readings"], out["control_readings"]["fp8"]
    assert ctrl["max_logit_gap"] > 10 * max(prog["max_logit_gap"], 1e-3)
    assert ctrl["mean_logit_gap"] > prog["mean_logit_gap"]
