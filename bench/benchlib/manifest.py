"""``BENCHMARK.json``: loading, validation and lookup of a cell.

The manifest names every configuration, traffic mix, cell and metric; the
files behind them are found by those names (``discover``).  ``validate``
checks the rules a manifest must keep: the keys of each entry, the
characters of names and units, and that every per-layer metric's
``moves`` is an end-to-end metric reported in each cell it lists.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class ManifestError(ValueError):
    """The manifest breaks one of its rules."""


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _line(text, what: str) -> None:
    if not (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text):
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(text, what: str) -> None:
    if not (isinstance(text, str) and NAME.match(text)):
        raise ManifestError(f"{what}: {text!r} is not a valid name")


def _keys(entry: dict, allowed: set, what: str, optional=()) -> None:
    keys = set(entry)
    if not (allowed <= keys <= allowed | set(optional)):
        raise ManifestError(f"{what}: keys {sorted(keys)}, expected "
                            f"{sorted(allowed)} (+{sorted(optional)})")


def metric_cells(metric: dict, manifest: dict) -> list:
    """The cells a metric is reported in: its ``workloads``, or every cell
    when it has none."""
    return metric.get("workloads",
                      [w["name"] for w in manifest["workloads"]])


def validate(m: dict) -> None:
    """Raise ``ManifestError`` where ``m`` breaks a rule."""
    if set(m) != TOP_KEYS:
        raise ManifestError(f"top-level keys {sorted(m)}")
    if not (isinstance(m["command"], list) and 1 <= len(m["command"]) <= 32):
        raise ManifestError("command: 1 to 32 strings")
    for word in m["command"]:
        _line(word, "command word")
    if not 1 <= len(m["paths"]) <= 16:
        raise ManifestError("paths: 1 to 16 directories")
    for p in m["paths"]:
        if not re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) or p.startswith("/") \
                or ".." in p.split("/"):
            raise ManifestError(f"path {p!r}")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        raise ManifestError("run_seconds: a whole number from 1 to 51")

    names = set()

    def unique(n):
        if n in names:
            raise ManifestError(f"name {n!r} used twice")
        names.add(n)

    configs = {}
    for c in m["configs"]:
        _keys(c, CONFIG_KEYS, f"config {c.get('name')}")
        _name(c["name"], "config name")
        unique(c["name"])
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        if len(c["reduced"]) > 16:
            raise ManifestError("reduced: at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in m["paths"]):
            raise ManifestError(f"config file {c['file']} outside paths")
        configs[c["name"]] = c
    if not 1 <= len(configs) <= 24:
        raise ManifestError("configs: 1 to 24")

    cells = {}
    pairs = set()
    for w in m["workloads"]:
        _keys(w, WORKLOAD_KEYS, f"workload {w.get('name')}")
        for key in ("name", "config", "traffic"):
            _name(w[key], f"workload {key}")
        unique(w["name"])
        _line(w["why"], "workload why")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: no config "
                                f"{w['config']}")
        if w["chips"] not in (1, 4):
            raise ManifestError("chips: 1 or 4")
        pair = (w["config"], w["traffic"])
        if pair in pairs:
            raise ManifestError(f"config and traffic {pair} twice")
        pairs.add(pair)
        cells[w["name"]] = w
    if not 1 <= len(cells) <= 24:
        raise ManifestError("workloads: 1 to 24")
    used = {w["config"] for w in cells.values()}
    if used != set(configs):
        raise ManifestError(f"configs used by no cell: {set(configs) - used}")

    def metric(x, keys, what):
        _keys(x, keys, f"{what} {x.get('name')}", optional=("workloads",))
        _name(x["name"], f"{what} name")
        unique(x["name"])
        if not (isinstance(x["unit"], str) and UNIT.match(x["unit"])):
            raise ManifestError(f"{what} {x['name']}: unit {x['unit']!r}")
        if x["better"] not in ("lower", "higher"):
            raise ManifestError(f"{what} {x['name']}: better")
        if x["source"] not in SOURCES:
            raise ManifestError(f"{what} {x['name']}: source")
        for c in x.get("workloads", []):
            if c not in cells:
                raise ManifestError(f"{what} {x['name']}: no cell {c}")

    e2e = {}
    for x in m["end_to_end"]:
        metric(x, E2E_KEYS, "end-to-end metric")
        if x["source"] not in ("host_clock", "device_trace"):
            raise ManifestError(f"{x['name']}: an end-to-end metric is "
                                "taken by the benchmark itself")
        b = x["bound"]
        if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
            raise ManifestError(f"{x['name']}: bound {b}")
        e2e[x["name"]] = x
    if "setup_s" not in e2e or not 1 <= len(e2e) <= 16:
        raise ManifestError("end_to_end: 1 to 16, setup_s among them")
    layers = [x for x in m["per_layer"]]
    if not 1 <= len(layers) <= 128:
        raise ManifestError("per_layer: 1 to 128")
    for x in layers:
        metric(x, LAYER_KEYS, "per-layer metric")
        _line(x["layer"], "layer")
        if x["moves"] not in e2e:
            raise ManifestError(f"{x['name']}: moves {x['moves']!r} is no "
                                "end-to-end metric")
        moved = e2e[x["moves"]]
        for c in metric_cells(x, m):
            if c not in metric_cells(moved, m):
                raise ManifestError(f"{x['name']} is read in {c}, which "
                                    f"does not report {x['moves']}")
    for c in cells:
        if not [x for x in e2e.values() if x["name"] != "setup_s"
                and c in metric_cells(x, m)]:
            raise ManifestError(f"cell {c}: no end-to-end metric besides "
                                "setup_s")
        if not [x for x in layers if c in metric_cells(x, m)]:
            raise ManifestError(f"cell {c}: no per-layer metric")


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in the manifest")


def config_entry(m: dict, name: str) -> dict:
    for c in m["configs"]:
        if c["name"] == name:
            return c
    raise ManifestError(f"no config {name!r} in the manifest")


def metrics_for(m: dict, group: str, cell_name: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics reported in a cell."""
    return [x for x in m[group] if cell_name in metric_cells(x, m)]
