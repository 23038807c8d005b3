"""
Throughput sweep harness (port of ``nimrud_tpu/workflows/sweep.py``).

The reference tuned its partition-size knob by sweeping imax and printing
points/sec (reference: nimrud/prototypes/tests.py:10-86, which no longer
even runs -- it imports a module absent from the repo).  This is the
equivalent for the extraction's knobs: query_tile_factor,
query_capacity, entry_batch, matmul precision, and method.  Each timed
run is host wall time, host planning included, to
``torch.cuda.synchronize`` on a card.

Run via ``nimrud sweep`` or programmatically; returns/prints one result
row per configuration so the best tuning can be fed back through the
``tuning`` argument of extract_scaleset.  A configuration the
extraction refuses (its ``ValueError``) gives an error row; every other
failure -- a kernel that does not build or launch -- propagates.
"""

import itertools
import json
import time

import numpy as np


def synthetic_scan(n_points, extent=100.0, seed=0):
    """Ground + walls + canopy, the benchmark workload."""
    rng = np.random.default_rng(seed)
    ground = rng.random((n_points // 2, 3)) * [extent, extent, 0.15]
    walls = [rng.random((n_points // 16, 3)) * [0.2, 12, 9]
             + [rng.random() * extent * 0.9, rng.random() * extent * 0.9, 0]
             for _ in range(8)]
    canopy = rng.normal(
        [extent * 0.6, extent * 0.6, 7], [extent * 0.15, extent * 0.15, 2],
        (n_points // 4, 3))
    return np.vstack([ground, *walls, canopy]).astype(
        np.float32)[:n_points]


def sweep_extraction(cloud=None, scaleset=None, kind="minimal", *,
                     n_points=200_000, repeats=2,
                     tile_factors=(2, 3, 4), capacities=(None, 64, 128),
                     entry_batches=(128, 256),
                     precisions=("highest",), methods=("tiled",),
                     verbose=True, trace_dir=None, device="cuda"):
    """
    Sweep tuning knobs over one extraction workload on ``device`` (the
    card unless the caller asks for the CPU).  Returns a list of dicts
    sorted by throughput (best first), then the error rows of the
    configurations the extraction refused.

    ``trace_dir``: capture a ``torch.profiler`` chrome trace of the best
    configuration's run into this directory (``utils.profiling.trace``).
    """
    import torch
    from nimrud_tpu_torch.features.multiscale import (
        extract_scaleset_device, plan_report)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    if cloud is None:
        cloud = synthetic_scan(n_points)
    if scaleset is None:
        scaleset = [(0.25, (0.5,)), (0.5, (1.0,)), (1.0, (2.0,))]

    fill_cache = {}

    def fills(method, tuning):
        """Per-band entry fill for this plan (cached; fill is
        independent of matmul precision)."""
        if method == "dense":
            return None             # no tables, nothing to fill
        key = (method, tuning["query_tile_factor"],
               tuning["query_capacity"], tuning["entry_batch"])
        if key not in fill_cache:
            try:
                report = plan_report(
                    cloud, cloud, scaleset,
                    method="fused" if method == "fused" else "tiled",
                    tuning=tuning, device=device)
                fill_cache[key] = [band["entry_fill"] for band in report]
            except ValueError:              # no such plan
                fill_cache[key] = None
        return fill_cache[key]

    results = []
    for method, m, q_cap, batch, precision in itertools.product(
            methods, tile_factors, capacities, entry_batches, precisions):
        tuning = {
            "query_tile_factor": m,
            "query_capacity": q_cap,
            "entry_batch": batch,
            "precision": precision,
        }
        try:
            feats = extract_scaleset_device(
                cloud, cloud, scaleset, kind, method=method, tuning=tuning,
                device=device)
            sync()
            best = float("inf")
            for _ in range(repeats):
                start = time.perf_counter()
                feats = extract_scaleset_device(
                    cloud, cloud, scaleset, kind, method=method,
                    tuning=tuning, device=device)
                sync()
                best = min(best, time.perf_counter() - start)
            rate = len(cloud) * sum(len(r) for _, r in scaleset) / best
            row = {"method": method, **tuning,
                   "seconds": round(best, 4),
                   "point_scales_per_sec": round(rate, 1),
                   "entry_fill": fills(method, tuning)}
        except ValueError as error:            # config not applicable
            row = {"method": method, **tuning, "error": str(error)[:100]}
        results.append(row)
        if verbose:
            print(json.dumps(row), flush=True)

    ranked = sorted(
        (r for r in results if "error" not in r),
        key=lambda r: -r["point_scales_per_sec"])

    if trace_dir and ranked:
        from nimrud_tpu_torch.utils import profiling
        best = ranked[0]
        tuning = {key: best[key] for key in (
            "query_tile_factor", "query_capacity", "entry_batch",
            "precision")}
        with profiling.trace(trace_dir):
            feats = extract_scaleset_device(
                cloud, cloud, scaleset, kind, method=best["method"],
                tuning=tuning, device=device)
            sync()
        if verbose:
            print(json.dumps({"trace": trace_dir, **tuning}), flush=True)

    return ranked + [r for r in results if "error" in r]
