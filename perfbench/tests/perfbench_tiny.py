"""Tiny CPU versions of the benchmark's cells for the tests: the site
shrunk to 20 x 20.4 m, a few thousand points, short windows."""

import time

import torch

from perfbench.core import bench
from perfbench.core import cell as cellmod

SCALE = 0.2


def _cell(name):
    """The cell ``name`` of BENCHMARK.json, or, for a cell kept out of it
    (``<config>.<traffic>``, PERF.md's open questions), its parts by
    name."""
    benchmark = cellmod.load_benchmark()
    if name not in {w["name"] for w in benchmark["workloads"]}:
        config, traffic = name.split(".")
        benchmark = dict(benchmark, workloads=[
            {"name": name, "config": config, "traffic": traffic,
             "chips": 1}])
    return cellmod.Cell(name, benchmark)


def tiny_cell(name, points=12000, warmup=1, check_rows=256):
    cell = _cell(name)
    lo, hi = cell.config["site_bounds"]
    cell.config = dict(
        cell.config,
        site_bounds=[lo, [hi[0] * SCALE, hi[1] * SCALE, hi[2]]],
        classifier_fit=dict(cell.config["classifier_fit"], sample=3000))
    cell.traffic = dict(cell.traffic, points=points, pool=2,
                        site_scale=SCALE, check_rows=check_rows, warmup=warmup,
                        trace_clouds=1)
    return cell


def tiny_run(name, seed=2 ** 31 + 7, seconds=0.5, trace=False,
             points=12000, warmup=1, check_rows=256, **kw):
    torch.set_num_threads(2)
    return bench.run(tiny_cell(name, points, warmup, check_rows), seed,
                     seconds, trace, "cpu", time.perf_counter(), **kw)
