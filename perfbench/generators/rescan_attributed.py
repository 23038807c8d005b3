"""``rescan``'s scans with per-point attribute columns: each point
carries ``attributes`` (1-6) float32 columns, each its class's mean
plus Gaussian noise of ``SIGMA``, drawn from the run seed's
``scene.ATTRIBUTES`` purpose (the fit scan's first, then the pool's in
order), so the points and every other stream are ``rescan``'s.

The columns, in this order, scaled to [0, 1]: intensity, red, green and
blue (the per-point fields of Semantic3D's terrestrial scans, ``x y z
intensity r g b``), then a near-infrared and a return-ratio column.
The class means (ground, wall, canopy) and the noise are assumed, in
the spirit of the port's ``make_bench_attributes`` (the label plus 0.05
noise).

Parameters: ``rescan``'s, and ``attributes``."""

import numpy as np

from perfbench.core import scene
from perfbench.generators import rescan

# (column, class): ground, wall, canopy
MEANS = np.array([[0.45, 0.60, 0.30],        # intensity
                  [0.50, 0.70, 0.25],        # red
                  [0.45, 0.68, 0.45],        # green
                  [0.40, 0.66, 0.20],        # blue
                  [0.35, 0.40, 0.75],        # near-infrared
                  [0.95, 0.90, 0.55]],       # return ratio
                 np.float32)
SIGMA = 0.05


def columns(labels, count, rng):
    """(n, count) float32 columns of points with class ``labels``."""
    noise = rng.standard_normal((len(labels), count), dtype=np.float32)
    return MEANS[:count, labels].T + np.float32(SIGMA) * noise


def make(spec, seed, lo, hi):
    count = int(spec["attributes"])
    if not 1 <= count <= len(MEANS):
        raise ValueError(f"attributes must be 1-{len(MEANS)}, got {count}")
    traffic = rescan.make(spec, seed, lo, hi)
    # a scan's labels depend on its size alone (scene.bench_cloud), so
    # every pooled cloud's rows carry the fit scan's labels
    labels = traffic.fit[1]
    rng = scene.rng(seed, scene.ATTRIBUTES)
    fit = columns(labels, count, rng)
    pool = [columns(labels, count, rng) for _ in traffic.pool]
    traffic.attributes = (fit, pool)
    return traffic
