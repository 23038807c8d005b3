"""
The readings that a cell's limits are set from: for each seed, one run
of the cell (set-up and a short window), the program's numbers
(``core.compare``) and those of the lower-precision control -- the
reference computed in TF32 in the program's place, on the same sampled
points of the same served clouds.  With ``--fault``, the program's
numbers with each of those faults of ``perfbench.faults`` planted in
turn, and no control.  One process, so set-up's first build is paid once.

    python3 perfbench/readings.py --workload <cell> --seconds 3 \
        --seeds 1 2 3 ... [--fault band_region answer_block]

Prints one JSON line a seed, then a summary line: the program's largest
reading and the control's (or the fault's) smallest, per number.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="perfbench/readings.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", nargs="*", default=[])
    args = parser.parse_args(argv)
    sys.path[0] = str(ROOT)
    from perfbench.core import bench
    from perfbench.core.cell import Cell

    cell = Cell(args.workload)
    for fault in args.fault or [None]:
        rows = []
        for seed in args.seeds:
            start = time.perf_counter()
            line, _, records = bench.run(cell, seed, args.seconds, False,
                                         "cuda", control=fault is None,
                                         fault=fault)
            row = {"seed": seed, "fault": fault, "failed": line["failed"],
                   "attempted": line["attempted"],
                   "program": records["numbers"],
                   "control": records.get("control", records["numbers"]),
                   "metrics": {k: v["value"]
                               for k, v in line["metrics"].items()},
                   "wall_s": time.perf_counter() - start}
            rows.append(row)
            print(json.dumps(row), flush=True)
        summary = {"workload": args.workload, "seeds": len(rows),
                   "fault": fault}
        for key in ("gap_median", "miss_share", "gap_max"):
            summary[key] = {
                "program_max": max(r["program"][key] for r in rows),
                "control_min": min(r["control"][key] for r in rows)}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
