"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
loads and resolves by name, and the file keeps the contract's limits."""

import json
import re

import pytest

from benchmark import configs, run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((run.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_keep_the_limits(kind):
    names = [entry["name"] for entry in BENCH[kind]]
    assert len(names) == len(set(names))
    for entry in BENCH[kind]:
        extra = set(entry) - KEYS[kind]
        assert extra <= ({"workloads"} if kind in ("end_to_end",
                                                   "per_layer") else set())
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
        if "unit" in entry:
            assert UNIT.match(entry["unit"])
            assert entry["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    resolved = configs.cell(cell)
    assert resolved["config"]["name"] == entry["config"]
    assert resolved["traffic"]["name"] == entry["traffic"]
    assert entry["chips"] in (1, 4)
    __import__(f"benchmark.drivers.{resolved['traffic']['driver']}")
    for traced in (False, True):
        reported = run.cell_metrics(BENCH, cell, traced)
        assert reported, (cell, traced)
    e2e = {m["name"] for m in run.cell_metrics(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for metric in run.cell_metrics(BENCH, cell, True):
        assert metric["moves"] in e2e


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_resolves(config):
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    assert entry["file"] == f"benchmark/configs/{config}.json"
    data = configs.load("configs", config)
    assert data["reduced"] == entry["reduced"]
    assert data["source"] and data["assumed"]
    assert data["defaults"] in ("adapt", "train")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_resolves(metric):
    read = run.reader(metric)
    assert read({}) is None or metric == "setup_s"
