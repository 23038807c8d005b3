"""
The backends stage (port of the reference's ``scripts/bench_backends.py``):
one band's feature extraction on device-resident inputs, the XLA
candidate-table path (``device_grid.fused_extract``, no moment kernel)
against the span kernel (``device_grid.fused_extract_spans``, the
``span_moments`` kernel).  The cloud (``make_cloud``, 1,048,576 points,
``default_rng(0)``) and each band's voxel centers are uploaded once; each
variant then extracts the three bands (edge, radius) (0.25, 0.5),
(0.5, 1.0), (1.0, 2.0), ``minimal`` layout, ``RUNS`` times after a
warm-up, on the host clock to ``torch.cuda.synchronize()`` (the host's
dispatch included: the port runs no compiled program).

Variants:

* ``xla_highest`` and ``xla_mixed`` -- the XLA path at the reference's
  two precision names.  In the port every name on that path sums in f32
  with TF32 off, so the two are the same sums: ``xla_highest`` is timed
  and ``xla_mixed``'s entries are copies of its numbers, kept so that the
  line has the reference's keys.
* ``pallas_spans`` -- the span kernel.  The reference times it at
  ``span_batch`` 1, 8 and 16, its TPU DMA batching; the CUDA kernel
  streams spans through shared memory and has no such knob, so it is
  one variant.

The line: ``device_compute_sec_per_extract`` (seconds an extraction of
the three bands), ``point_scales_per_sec_M``, ``launches_per_extract``
and ``checks`` (each variant's feature sum, in float64, and its
relative difference from ``xla_highest``'s).  A variant that fails ends
the stage.  Writes no file; prints one JSON line.

    python -m nimrud_tpu_torch.bench.backends [--points N] [--device D]
"""

import numpy as np

from nimrud_tpu_torch.bench import _stage

N_POINTS = 1_048_576          # power of two
EDGES = (0.25, 0.5, 1.0)
RADII = (0.5, 1.0, 2.0)
RUNS = 10
VARIANTS = ("xla_highest", "xla_mixed", "pallas_spans")
TIMED = ("xla_highest", "pallas_spans")   # xla_mixed copies xla_highest


def make_cloud(n, rng):
    """Ground, eight walls, a canopy (a copy of the reference script's
    ``make_cloud``; not ``workload.make_bench_cloud``): float32 (n, 3)."""
    ground = rng.random((n // 2, 3)) * [100, 100, 0.15]
    walls = []
    for _ in range(8):
        offset = rng.random(2) * 90
        walls.append(rng.random((n // 16, 3)) * [0.2, 12, 9]
                     + [offset[0], offset[1], 0])
    canopy = rng.normal([60, 60, 7], [15, 15, 2], (n // 4, 3))
    return np.vstack([ground, *walls, canopy]).astype(np.float32)[:n]


def make_bands(cloud, query):
    """Each band's device-resident search side and plan, as the reference
    builds them: ``(centers, mask, spec, radii)`` -- the voxel centers of
    ``query`` (the uploaded cloud) on the band's voxel grid and the band's
    grid spec, its entries estimated on ``cloud``."""
    from nimrud_tpu_torch.ops import device_grid, packing, unique

    lo = cloud.min(0).astype(np.float64)
    hi = cloud.max(0).astype(np.float64)
    bands = []
    for edge, radius in zip(EDGES, RADII):
        vox_spec = packing.GridSpec.fit_bounds(lo, hi, edge)
        centers, _, mask = unique.unique_voxels(query, vox_spec)
        spec = device_grid.make_spec(lo, hi, radius, n_query=len(cloud),
                                     voxel_edge=edge)
        spec = device_grid.with_entry_estimate(spec, cloud)
        bands.append((centers, mask, spec, (radius,)))
    return bands


def extract(variant, query, q_valid, bands):
    """One extraction of every band by ``variant``: a list of
    (n, width) feature blocks."""
    from nimrud_tpu_torch.ops import device_grid

    n = query.shape[0]
    if variant == "pallas_spans":
        return [device_grid.fused_extract_spans(
            query, q_valid, centers, mask, spec, radii, "minimal", n)
            for centers, mask, spec, radii in bands]
    return [device_grid.fused_extract(
        query, q_valid, centers, mask, spec, radii, "minimal", None,
        "highest", n) for centers, mask, spec, radii in bands]


def main(argv=None):
    import torch

    stage = _stage.Stage("backends", argv, N_POINTS)
    n = stage.n_points
    cloud = make_cloud(n, np.random.default_rng(0))
    query = torch.from_numpy(cloud).to(stage.device)
    q_valid = torch.ones(n, dtype=torch.bool, device=stage.device)
    bands, prep_s = stage.seconds(lambda: make_bands(cloud, query))
    stage.note(f"bands uploaded and planned in {prep_s:.2f} s")

    times, sums, launched = {}, {}, {}
    for variant in TIMED:
        stage.seconds(lambda: extract(variant, query, q_valid, bands))

        def timed():
            for _ in range(RUNS):
                outs = extract(variant, query, q_valid, bands)
            return outs
        before = _stage.launches()
        outs, seconds = stage.seconds(timed)
        launched[variant] = _stage.launched_since(before, RUNS)
        times[variant] = seconds / RUNS
        sums[variant] = sum(float(o.sum(dtype=torch.float64)) for o in outs)
        stage.note(f"{variant}: {1e3 * times[variant]:.3f} ms an extraction")
        del outs
    times, sums, launched = (
        {v: record["xla_highest" if v == "xla_mixed" else v]
         for v in VARIANTS} for record in (times, sums, launched))

    base = sums["xla_highest"]
    return stage.emit({
        "mode": "backends",
        "edges": list(EDGES),
        "radii": list(RADII),
        "runs": RUNS,
        "timing_semantics": "host clock to torch.cuda.synchronize() over "
                            f"{RUNS} extractions on device-resident inputs",
        "prep_s": prep_s,
        "device_compute_sec_per_extract": times,
        "point_scales_per_sec_M": {
            k: n * len(RADII) / t / 1e6 for k, t in times.items()},
        "launches_per_extract": launched,
        "checks": {k: {"feature_sum": v,
                       "rel_vs_xla_highest": None if base == 0
                       else abs(v - base) / abs(base)}
                   for k, v in sums.items()},
    })


if __name__ == "__main__":
    main()
