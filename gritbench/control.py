"""The readings that the limits of a cell's comparison are set from.

  python3 -m gritbench.control --workload <cell> --program-seeds 1,2,... \\
      --control-seeds 101,102,103 [--seconds 4]

In one process: for each program seed, a whole run of the cell (set-up, a
window of ``--seconds``, the comparison with the reference), printing the
numbers compared; for each control seed, the control (the reference in the
program's place, one precision below the configuration's), or with
``--fault`` the planted fault of a training cell, judged the same way.  The
lower reading of a number is the largest of the program's, the upper the
smallest of the control's or a fault's.  One JSON line per seed goes to
standard output.
"""

from __future__ import annotations

import argparse
import json
import time

from gritbench import harness


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m gritbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", action="store_true",
                    help="read the planted fault (half of the batch left out) instead of "
                         "the control (training cells)")
    args = ap.parse_args(argv)
    bench = harness.benchmark()
    seeds = {"program": [int(s) for s in args.program_seeds.split(",") if s],
             "control": [int(s) for s in args.control_seeds.split(",") if s]}
    cell = harness.load_cell(args.workload, bench, seconds=args.seconds)
    harness.require_cards(cell.workload["chips"])
    driver = cell.driver
    for arm, arm_seeds in seeds.items():
        for seed in arm_seeds:
            cell.seed = seed
            t = time.perf_counter()
            if arm == "program":
                values = driver.run(cell)["values"]
            elif args.fault:
                values = driver.fault(cell)
            else:
                values = driver.control(cell)
            print(json.dumps({"arm": "fault" if args.fault and arm == "control" else arm,
                              "seed": seed, "values": values,
                              "seconds": time.perf_counter() - t}), flush=True)
    harness.check_clean()


if __name__ == "__main__":
    main()
