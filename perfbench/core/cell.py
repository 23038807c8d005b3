"""
Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration is ``perfbench/configs/<config>.json``, the traffic
``perfbench/traffic/<traffic>.json``, and a per-layer metric
``perfbench/metrics/<metric>.py`` (a module with ``read(records)``).
A traffic file names its generator, ``perfbench/generators/<name>.py``
(``make(spec, seed, lo, hi)``), and its loop,
``perfbench/loops/<name>.py`` (``serve(step, pool, spec, seconds,
done)``).
An end-to-end or per-layer metric belongs to a cell where its
``workloads`` list names the cell, or where it has no such list.
"""

import importlib
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def load_benchmark(path=None):
    with open(path or ROOT / "BENCHMARK.json") as handle:
        return json.load(handle)


def _json(folder, name):
    with open(BENCH / folder / f"{name}.json") as handle:
        return json.load(handle)


def config(name):
    return _json("configs", name)


def traffic(name):
    return _json("traffic", name)


def metric_reader(name):
    """The ``read`` function of per-layer metric ``name``."""
    return importlib.import_module(f"perfbench.metrics.{name}").read


def generator(name):
    """The ``make`` function of traffic generator ``name``."""
    return importlib.import_module(f"perfbench.generators.{name}").make


def loop(name):
    """The ``serve`` function of loop ``name``."""
    return importlib.import_module(f"perfbench.loops.{name}").serve


def _belongs(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    metrics.  ``benchmark``: the parsed ``BENCHMARK.json`` (default the
    checkout's), or a dict holding just the entry for a cell it lacks."""

    def __init__(self, name, benchmark=None):
        bench = benchmark or load_benchmark()
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {', '.join(sorted(entries))}")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = config(self.entry["config"])
        self.traffic = traffic(self.entry["traffic"])
        self.end_to_end = [m for m in bench.get("end_to_end", ())
                           if _belongs(m, name)]
        self.per_layer = [m for m in bench.get("per_layer", ())
                          if _belongs(m, name)]
