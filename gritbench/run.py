"""One run of one cell of the benchmark of ``grit_tpu_torch``.

  python3 -m gritbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files (``gritbench/harness.py``), sets up the program,
warms it up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer metrics, read from a profiled stretch
after the window), ``device``, with ``--trace 1`` a ``breakdown``, and last
the numbers compared beside their limits (``checks``).  Without a card, or
with fewer than the cell asks for, it exits with an error and prints no
result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

from gritbench import harness  # noqa: E402

harness.START["t"] = _T0


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m gritbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(cell: harness.Cell, out: dict) -> dict:
    import torch

    correct, checks = harness.judge(out["values"], cell.workload["limits"])
    if cell.trace:
        metrics = harness.read_metrics(cell, out["record"])
    else:
        metrics = {"setup_s": {"value": out["setup_s"], "unit": "s"}}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name, value in out["e2e"].items():
            if name in units:
                metrics[name] = {"value": value, "unit": units[name]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.workload["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    stretch = out["record"].get("stretch")
    if cell.trace and stretch is not None:
        tr = stretch["trace"]
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.span_s
        result["breakdown"] = tr.breakdown()
        if stretch["lost"]:
            print("gritbench: the trace lost launches, its metrics are not read: "
                  + "; ".join(stretch["lost"]), file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> None:
    args = parse(argv)
    # every generator takes a seed in [0, 2**64): fold any whole number into it
    cell = harness.load_cell(args.workload, harness.benchmark(), seed=args.seed % 2 ** 63,
                             seconds=args.seconds, trace=bool(args.trace))
    harness.require_cards(cell.workload["chips"])
    out = cell.driver.run(cell)
    harness.check_clean()
    harness.emit(result_line(cell, out))


if __name__ == "__main__":
    main()
