"""Re-scans of one site: the walls placed by the traffic's ``site_seed``
(the same for every run seed), every scan -- the labelled one the model
is fitted on, and the ``pool`` served -- drawing its points anew on
them from the run seed.  Each served cloud is its own search cloud.

Parameters: ``points`` a scan, ``pool``, ``site_seed``, and
``site_scale`` (the CPU tests' shrunken sites; default 1)."""

from perfbench.core import scene


def make(spec, seed, lo, hi):
    n, pool = int(spec["points"]), int(spec["pool"])
    scale = float(spec.get("site_scale", 1.0))
    walls = scene.site_walls(int(spec["site_seed"]))
    drawn = scene.seeds(seed, pool + 1)
    fit = scene.bench_cloud(n, drawn[0], scale, walls)
    clouds = [scene.bench_cloud(n, s, scale, walls)[0] for s in drawn[1:]]
    return scene.Traffic(fit, None, clouds, True)
