"""
Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (a run of its
own).  Needs CUDA and as many cards as the cell asks for; without them,
or if JAX or the JAX package is loaded once the window has closed, it
exits non-zero and prints no result.  The last stdout line is one JSON
object; the numbers compared to decide ``correct`` are the last stderr
lines and the last key of that object.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "nimrud_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    sys.path[0] = str(ROOT)      # import perfbench.* as a package
    import torch

    from perfbench.core import bench
    from perfbench.core.cell import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); CUDA available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    import nimrud_tpu_torch  # noqa: F401  (the program under test)
    line, checks, _ = bench.run(cell, args.seed, args.seconds,
                                bool(args.trace), "cuda", T0)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, check in checks.items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})",
              file=sys.stderr)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
