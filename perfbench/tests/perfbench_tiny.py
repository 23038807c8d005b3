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


def attributed_cell(points=12000, warmup=1, check_rows=256, attributes=4):
    """A cell kept out of BENCHMARK.json, built from dicts: the tiny
    ``site_linear.rescan_1m`` served with the ``vector`` layout on
    ``rescan_attributed``'s scans (``attributes`` columns a point)."""
    cell = tiny_cell("site_linear.rescan_1m", points, warmup, check_rows)
    cell.name = "site_linear_vector.rescan_attributed"
    cell.config = dict(cell.config, name="site_linear_vector", kind="vector")
    cell.traffic = dict(cell.traffic, generator="rescan_attributed",
                        attributes=attributes)
    return cell


def tiny_run(name, seed=2 ** 31 + 7, seconds=0.5, trace=False,
             points=12000, warmup=1, check_rows=256, **kw):
    """``bench.run`` of the tiny ``name`` on the CPU; ``name`` None runs
    :func:`attributed_cell`."""
    torch.set_num_threads(2)
    cell = attributed_cell(points, warmup, check_rows) if name is None \
        else tiny_cell(name, points, warmup, check_rows)
    return bench.run(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                     **kw)
