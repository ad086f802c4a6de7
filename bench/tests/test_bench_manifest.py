"""BENCHMARK.json against its rules, and discovery of every file it names
by name."""
import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from benchlib import discover, manifest as M  # noqa: E402

MAN = M.load(ROOT / "BENCHMARK.json")


def test_the_manifest_keeps_its_rules():
    M.validate(MAN)


def _broken(edit):
    m = copy.deepcopy(MAN)
    edit(m)
    with pytest.raises(M.ManifestError):
        M.validate(m)


@pytest.mark.parametrize("bad", ["has space", "a/b", "a,b", "-lead", "é",
                                 "x" * 65])
def test_names_in_the_allowed_characters(bad):
    def edit(m):
        m["end_to_end"][0]["name"] = bad
    _broken(edit)


@pytest.mark.parametrize("bad", ["tokens per second", "µs", "", "x" * 17])
def test_units_in_the_allowed_characters(bad):
    def edit(m):
        m["per_layer"][0]["unit"] = bad
    _broken(edit)


def test_a_metric_read_where_its_moved_metric_is_not_reported():
    def edit(m):
        first = m["workloads"][0]
        m["workloads"].append(dict(first, name=first["name"] + "-2",
                                   traffic=first["traffic"] + "-2"))
        e2e = next(x for x in m["end_to_end"] if x["name"] != "setup_s")
        e2e["workloads"] = [first["name"]]
        lay = next(x for x in m["per_layer"] if x["moves"] == e2e["name"])
        lay["workloads"] = [first["name"] + "-2"]
    _broken(edit)


def test_unknown_keys_and_bounds_are_refused():
    _broken(lambda m: m["end_to_end"][0].update(why="no"))
    _broken(lambda m: m["end_to_end"][0].update(bound=0.5))
    _broken(lambda m: m["per_layer"][0].update(moves="no_such_metric"))
    _broken(lambda m: m["workloads"][0].update(chips=2))
    _broken(lambda m: m.update(run_seconds=52))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_files_by_name(cell):
    w = M.cell(MAN, cell)
    cfg = discover.config(ROOT, M.config_entry(MAN, w["config"]))
    assert cfg["name"] == w["config"]
    assert sorted(cfg["reduced"]) == sorted(
        M.config_entry(MAN, w["config"])["reduced"])
    mix = discover.traffic(w["traffic"])
    assert mix["name"] == w["traffic"]
    cp = discover.cell_params(cell)
    assert cp["rates"] and all(v > 0 for v in cp["check"]["limits"].values())
    ref = discover.reference(cfg)
    assert callable(ref.logits)
    for group in ("end_to_end", "per_layer"):
        for x in M.metrics_for(MAN, group, cell):
            if x["name"] != "setup_s":
                assert callable(discover.metric_reader(x["name"]))


def test_a_missing_metric_file_is_an_error():
    with pytest.raises(FileNotFoundError):
        discover.metric_reader("no_such_metric")


def test_configuration_files_are_their_own():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["file"].startswith("bench/configs/")
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["source"].startswith(c["source"])
