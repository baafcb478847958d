"""The result line: the contract's keys, the checks last, the per-layer
metrics only in a traced run; and no result at all without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from gritbench import harness, run as run_mod
from gritbench.tests.tiny import caption_cell


@pytest.fixture(scope="module")
def outputs():
    cells = {}
    for trace in (False, True):
        cell = caption_cell(seed=12, trace=trace)
        bench = harness.benchmark()
        cell.end_to_end = [m for m in bench["end_to_end"]
                           if harness.reports(m, "cap_beam5_b128", set())]
        cell.per_layer = [m for m in bench["per_layer"]
                          if "cap_beam5_b128" in m.get("workloads", [])]
        cells[trace] = (cell, cell.driver.run(cell))
    return cells


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(outputs, monkeypatch, capsys, trace):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stand-in")
    cell, out = outputs[trace]
    result = run_mod.result_line(cell, out)
    harness.emit(result)
    printed = capsys.readouterr()
    line = json.loads(printed.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert printed.err.strip().splitlines()[-1].startswith("check ")
    if trace:
        # a CPU trace has no device events: no device metric, no busy time
        assert "setup_s" not in line["metrics"]
    else:
        assert {"setup_s", "caption_images_per_s", "caption_batch_p90_ms"} == set(
            line["metrics"])


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "-m", "gritbench.run", "--workload",
                          "cap_beam5_b128", "--seed", "1", "--seconds", "1"],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
