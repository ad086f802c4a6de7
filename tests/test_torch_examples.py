"""The port's two examples, ``examples/mixed_serving_torch.py`` and
``examples/train_100m_torch.py``, run to their end with ``--reduced
--device cpu`` (each process within its own time limit): every request
served and the training lane stepping; training that crashes with
``--fail-at`` and resumes from its checkpoint gives the losses of an
uninterrupted run.  Their references (``examples/mixed_serving.py``,
``examples/train_100m.py``) stay as they are."""
import os
import re
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def run_example(name: str, *args, timeout: float = 240.0):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "2"}
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)


def losses(stdout: str) -> dict:
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^step\s+(\d+) loss\s+([-\d.]+)", stdout, re.MULTILINE)}


def test_mixed_serving_example_serves_every_request_on_cpu():
    out = run_example("mixed_serving_torch.py", "--reduced", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "completed 8/8 requests" in out.stdout
    steps = int(re.search(r"background train steps: (\d+)",
                          out.stdout).group(1))
    assert steps >= 1


def test_train_100m_example_resumes_to_the_uninterrupted_losses(tmp_path):
    common = ("--reduced", "--device", "cpu", "--steps", "10",
              "--ckpt-every", "4", "--log-every", "1")
    whole = run_example("train_100m_torch.py", *common, "--ckpt-dir",
                        str(tmp_path / "whole"))
    assert whole.returncode == 0, whole.stderr[-3000:]
    assert whole.stdout.rstrip().endswith("done")
    crash = run_example("train_100m_torch.py", *common, "--ckpt-dir",
                        str(tmp_path / "drill"), "--fail-at", "6")
    assert crash.returncode != 0
    assert "simulated failure at step 6" in crash.stderr
    resume = run_example("train_100m_torch.py", *common, "--ckpt-dir",
                         str(tmp_path / "drill"))
    assert resume.returncode == 0, resume.stderr[-3000:]
    assert "resumed from checkpoint step 4" in resume.stdout
    want, before, after = (losses(o.stdout) for o in (whole, crash, resume))
    assert sorted(want) == list(range(1, 11))
    assert before == {s: want[s] for s in range(1, 7)}
    assert after == {s: want[s] for s in range(5, 11)}
