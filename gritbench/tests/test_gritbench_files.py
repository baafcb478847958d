"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic mix and driver; every metric's cells report what it
moves; names and units keep to the contract's characters."""

from __future__ import annotations

import json
import re

import pytest

from gritbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "gritbench.run"]
    assert BENCH["paths"] == ["gritbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    work = harness.read_json(harness.ROOT / "workloads" / f"{cell}.json")
    for key in ("config", "traffic", "chips", "why"):
        assert work[key] == entry[key], key
    assert entry["chips"] in (1, 4)
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"]
    loaded = harness.load_cell(cell, BENCH)
    assert (harness.ROOT / "traffic" / f"{loaded.traffic['driver']}.py").exists()
    assert set(work["limits"]) and all(v > 0 for v in work["limits"].values())
    assert any(m["name"] == "setup_s" for m in loaded.end_to_end)
    assert len(loaded.end_to_end) >= 2 and loaded.per_layer
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cfg["file"] == f"gritbench/configs/{entry['config']}.json"


def test_configs():
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] not in files
        files.add(c["file"])
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
        data = harness.read_json(harness.REPO / c["file"])
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", CELLS):
            reported = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reported, (m["name"], cell)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(0 < len(x) <= 200 and "\n" not in x for x in layers)
