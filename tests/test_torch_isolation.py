"""The port stands alone: ``repro_torch`` (with ``chip_smoke.py`` and the
port's two examples) imports no
JAX and nothing of the reference package, and the scheduler and configs it
copied stay equal to the reference's, docstrings aside."""
import ast
import json
import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(m.name for m in pkgutil.walk_packages([str(PORT)],
                                                        prefix="repro_torch.")
                 if not m.name.endswith("__main__"))
PORT_FILES = sorted(p for p in PORT.rglob("*") if p.is_file()
                    and p.suffix in (".py", ".cu", ".cuh"))
COPIED = sorted(str(p.relative_to(SRC / "repro"))
                for sub in ("core", "configs", "data")
                for p in (SRC / "repro" / sub).rglob("*.py"))

_IMPORT_ALL = r"""
import importlib, json, sys
sys.modules["jax"] = None          # any import of these now raises
sys.modules["repro"] = None
out = {}
for name in json.loads(sys.argv[1]):
    try:
        importlib.import_module(name)
        out[name] = "ok"
    except Exception as e:
        out[name] = f"{type(e).__name__}: {e}"
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    """Import every port module in one subprocess where ``jax`` and
    ``repro`` cannot be imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL, json.dumps(MODULES)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_modules_found():
    for m in ("repro_torch.kernels.ops", "repro_torch.models.transformer",
              "repro_torch.serving.engine", "repro_torch.launch.serve",
              "repro_torch.core.live", "repro_torch.configs.base",
              "repro_torch.data.pipeline", "repro_torch.training.trainer",
              "repro_torch.training.optimizer",
              "repro_torch.training.checkpoint",
              "repro_torch.training.grad_compress",
              "repro_torch.launch.train", "repro_torch.launch.mesh",
              "repro_torch.kernels.work", "repro_torch.roofline.analysis",
              "repro_torch.roofline.report",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.shardmap_attention",
              "repro_torch.distributed.pipeline_parallel"):
        assert m in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_reference(blocked_imports, module):
    assert blocked_imports[module] == "ok", blocked_imports[module]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


# The trace file format's schema id: both packages write the same one, so
# their Chrome traces stay interchangeable.  It is data, not an import.
_SCHEMA_ID = '"repro.core.trace/v1"'


EXAMPLES = [ROOT / "examples" / "mixed_serving_torch.py",
            ROOT / "examples" / "train_100m_torch.py"]


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"]
                         + EXAMPLES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_file_names_neither_jax_nor_reference(path):
    text = path.read_text()
    if path.suffix == ".py":
        roots = set(_imported_roots(ast.parse(text)))
        assert not roots & {"jax", "jaxlib", "repro", "flax"}, roots
    text = text.replace(_SCHEMA_ID, "")
    assert not re.search(r"\bjax\b", text, re.IGNORECASE)
    assert not re.search(r"\brepro\.[a-z]", text)


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference(rel):
    ref = ast.parse((SRC / "repro" / rel).read_text())
    port = ast.parse((PORT / rel).read_text())
    assert _strip_docstrings(port) == _strip_docstrings(ref)


def test_no_copied_module_missing():
    # The reference's data/ has no __init__.py; the port's package has one.
    extra = {pathlib.Path("data/__init__.py")}
    for sub in ("core", "configs", "data"):
        ref = {p.relative_to(SRC / "repro") for p in (SRC / "repro" / sub).rglob("*.py")}
        port = {p.relative_to(PORT) for p in (PORT / sub).rglob("*.py")}
        assert ref == port - extra
