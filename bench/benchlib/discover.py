"""Find a configuration, traffic mix, cell, per-layer metric or plain
reference by the name the manifest gives it.  No list of names lives in
code: a later cell or metric is a file and a manifest entry.

* configuration  -- the manifest's ``file`` (``configs/<name>.json``)
* traffic mix    -- ``traffic/<name>.json``
* cell           -- ``cells/<cell name>.json``: the cell's fixed load
* metric reader  -- ``metrics/<name>.py``, a function ``read(run)``
* reference      -- ``reference/<module>.py``, the module the
  configuration's ``reference`` key names
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(root: Path, entry: dict) -> dict:
    return _json(root / entry["file"])


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def cell_params(name: str) -> dict:
    return _json(BENCH / "cells" / f"{name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(run) -> float | None`` of the per-layer metric ``name``."""
    return _module(BENCH / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_").replace("-", "_")
                   ).read


def reference(cfg: dict):
    mod = cfg["reference"]
    return _module(BENCH / "reference" / f"{mod}.py", "bench_reference_" + mod)
