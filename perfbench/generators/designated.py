"""Repeat surveys against a designated map: one scan of the site (walls
placed by ``site_seed``) is the labelled scan and the search map, staged
once in set-up; the ``pool`` served clouds are that scan jittered by
``jitter_m`` (Gaussian, each its own seed), kept inside the site bounds.

Parameters: ``points``, ``pool``, ``site_seed``, ``jitter_m``, and
``site_scale`` (default 1)."""

import numpy as np

from perfbench.core import scene


def make(spec, seed, lo, hi):
    n, pool = int(spec["points"]), int(spec["pool"])
    scale = float(spec.get("site_scale", 1.0))
    walls = scene.site_walls(int(spec["site_seed"]))
    drawn = scene.seeds(seed, pool + 1)
    scan = scene.bench_cloud(n, drawn[0], scale, walls)
    sigma = float(spec["jitter_m"])
    lo32, hi32 = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    clouds = []
    for s in drawn[1:]:
        noise = np.random.default_rng(s).normal(0.0, sigma, (n, 3))
        clouds.append(np.clip(scan[0] + noise.astype(np.float32),
                              lo32, hi32))
    return scene.Traffic(scan, scan[0], clouds, False)
