"""What every cell's run shares: finding a cell's files by name, the checks
before and after a run, and the one result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) is found by name:
``gritbench/workloads/<cell>.json`` names its configuration
(``gritbench/configs/<config>.json``), its traffic mix
(``gritbench/traffic/<traffic>.json``, whose ``driver`` names the code in
``gritbench/traffic/<driver>.py``) and the limits of its comparison with the
reference.  A per-layer metric is read by ``gritbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: top-level module names that no run may hold once its window has closed:
#: the measured program is the PyTorch port, never the JAX package
BANNED = ("jax", "jaxlib", "flax", "grit_tpu")
#: the clock reading at the command's start (``run.py`` sets it first thing)
START = {"t": time.perf_counter()}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell's files and one run's arguments."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    #: per_layer entries of BENCHMARK.json that this cell reports
    per_layer: list = field(default_factory=list)
    #: end_to_end entries of BENCHMARK.json that this cell reports
    end_to_end: list = field(default_factory=list)

    @property
    def driver(self):
        name = self.traffic["driver"]
        return load_module(ROOT / "traffic" / f"{name}.py", f"gritbench_driver_{name}")


def benchmark() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def reports(entry: dict, cell: str, e2e_names: set) -> bool:
    """Whether a metric entry of BENCHMARK.json belongs to ``cell``."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None, **run) -> Cell:
    work = read_json(ROOT / "workloads" / f"{name}.json")
    config = read_json(ROOT / "configs" / f"{work['config']}.json")
    traffic = read_json(ROOT / "traffic" / f"{work['traffic']}.json")
    cell = Cell(name, work, config, traffic, **run)
    if bench is not None:
        e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
        names = {m["name"] for m in e2e}
        cell.end_to_end = e2e
        cell.per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return cell


def require_cards(n: int) -> None:
    """Exit with code 2, and print no result, unless ``n`` cards are here."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("gritbench: no CUDA device is available; the benchmark runs only on a card")
    if torch.cuda.device_count() < n:
        sys.exit(f"gritbench: the cell needs {n} cards, {torch.cuda.device_count()} are here")


def banned_loaded() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name is banned, compared
    whole (``grit_tpu_torch`` is not ``grit_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def check_clean() -> None:
    found = banned_loaded()
    if found:
        sys.exit(f"gritbench: the run loaded {', '.join(found)}: the benchmark measures the "
                 "PyTorch port alone")


def read_metrics(cell: Cell, rec: dict) -> dict:
    """Each per-layer metric of ``cell`` from its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(ROOT / "metrics" / f"{m['name']}.py",
                             "gritbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            print(f"gritbench: {m['name']}: nothing to read in this run", file=sys.stderr)
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit (a number passes at or under
    its limit; a number that is not finite fails) -> (correct, checks)."""
    checks, ok = {}, True
    for name, value in values.items():
        limit = limits[name]
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    missing = set(limits) - set(values)
    if missing:
        ok = False
        for name in sorted(missing):
            checks[name] = {"value": None, "limit": limits[name]}
    return ok, checks


def emit(result: dict) -> None:
    """Print the checks as the last lines of standard error, then the result
    as the last line of standard output (its ``checks`` key last)."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
