"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level module names compared whole, so ``repro_torch`` is not it),
the plain references load nothing of the program, and ``run.py`` prints
no result without a CUDA device."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

PRELUDE = f"""
import sys, json
sys.path.insert(0, {str(BENCH)!r}); sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(BENCH / 'tests')!r})
"""


def _run(code, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", PRELUDE + code], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout,
                       env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax_nor_the_jax_package():
    tops = _run("""
import time
import run
from benchlib import cellrun, manifest as M, discover
from test_bench_reference import tiny
man = M.load(run.ROOT / "BENCHMARK.json")
for w in man["workloads"]:
    for x in man["end_to_end"] + man["per_layer"]:
        if x["name"] != "setup_s":
            discover.metric_reader(x["name"])
out = cellrun.run_cell(man, run.ROOT, "llama-3-8b-1slot.azure-chat-batch", 3,
                       1.0, False, device="cpu", t_proc_start=time.time(),
                       cfg=tiny("llama-3-8b-1slot"),
                       rates={"time-sensitive": 2.0})
assert out["correct"]
print(json.dumps({"bad": run.forbidden_loaded(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
""")
    assert tops["bad"] == []
    assert "repro_torch" in tops["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops["tops"])


def test_the_references_load_nothing_of_the_program():
    got = _run("""
import importlib.util
for name in ("llama",):
    spec = importlib.util.spec_from_file_location(
        name, f"bench/reference/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & set(got)


def test_the_guard_compares_whole_names():
    got = _run("""
import types, run
sys.modules["repro_torch_extra"] = types.ModuleType("repro_torch_extra")
first = run.forbidden_loaded()
sys.modules["repro.sub"] = types.ModuleType("repro.sub")
print(json.dumps([first, run.forbidden_loaded()]))
""")
    assert got == [[], ["repro"]]


def test_no_result_without_a_cuda_device(tmp_path):
    """Here (no card) the run exits non-zero and prints nothing on standard
    output; so it does from a copy holding only the manifest and the
    benchmark's own files."""
    import torch
    if torch.cuda.is_available():
        return
    args = [sys.executable, "bench/run.py", "--workload",
            "llama-3-8b-1slot.azure-chat-batch", "--seed", "7", "--seconds",
            "1", "--trace", "0"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""
