"""
The benchmark's scenes and what the traffic generators share.

``bench_cloud`` is a frozen copy of ``nimrud_tpu_torch.utils.workload
.make_bench_cloud`` (itself the reference's headline scene): a ground
slab of 100 x 100 x 0.15 m and eight building walls of 0.2 x 12 x 9 m at
random offsets, labels 0 (ground) and 1 (wall).  Its canopy rows fall
past the first ``n`` rows and are cut, as in the original.

A traffic file (``perfbench/traffic/<mix>.json``) names its generator
(``"generator"``: a module ``perfbench/generators/<name>.py`` whose
``make(spec, seed, lo, hi)`` returns a :class:`Traffic`) and its loop
(``"loop"``: a module ``perfbench/loops/<name>.py``); the rest of the
file is the generator's and the loop's parameters.  :func:`make_traffic`
finds the generator by that name.  The helpers here are the
generators' common parts.
"""

import numpy as np

N_WALLS = 8
FIT_ROWS, CHECK_ROWS, FOREST, ATTRIBUTES = 1, 2, 3, 4   # purposes of ``rng``


def bench_cloud(n, seed, scale=1.0, walls=None):
    """Ground plane, eight building walls, vegetation canopy (cut by the
    ``[:n]``); float32 (n, 3) points and int32 labels.  ``scale`` shrinks
    the site's x and y (the CPU tests' small sites); ``walls`` (8, 2)
    fixes the walls' offsets (a re-scan of one site) instead of drawing
    them with the points."""
    rng = np.random.default_rng(seed)
    ground = rng.random((n // 2, 3)) * [100, 100, 0.15]
    parts = []
    for w in range(N_WALLS):
        points = rng.random((n // 16, 3)) * [0.2, 12, 9]
        offset = [rng.random() * 90, rng.random() * 90] if walls is None \
            else walls[w]
        parts.append(points + [offset[0], offset[1], 0])
    canopy = rng.normal([60, 60, 7], [15, 15, 2], (n // 4, 3))
    cloud = np.vstack([ground, *parts, canopy])[:n] * [scale, scale, 1.0]
    cloud = cloud.astype(np.float32)
    labels = np.concatenate([
        np.zeros(n // 2, np.int32),
        np.ones(N_WALLS * (n // 16), np.int32),
        np.full(n // 4, 2, np.int32)])[:n]
    return cloud, labels


def site_walls(seed):
    """The (8, 2) wall offsets of one site."""
    return np.random.default_rng(seed).random((N_WALLS, 2)) * 90


def seeds(seed, count):
    """``count`` independent 63-bit seeds drawn from ``seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [int(s) & (2 ** 63 - 1) for s in state]


def rng(seed, purpose):
    """A generator for one ``purpose`` of run seed ``seed``."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         purpose]))


class Traffic:
    """The clouds one run serves, and the scan the model is fitted on.

    ``fit``: (points, labels) of the labelled scan; ``search``: the
    designated map (the labelled scan's points) or None; ``pool``: the
    served clouds; ``self_search``: whether each cloud is its own search
    cloud (the uint16 upload); ``attributes``: None, or the per-point
    columns as ``(fit scan's (n, A), [one (n, A) a pooled cloud])``,
    float32, rows aligned with the points."""

    def __init__(self, fit, search, pool, self_search, attributes=None):
        self.fit = fit
        self.search = search
        self.pool = pool
        self.self_search = self_search
        self.attributes = attributes


def make_traffic(spec, seed, lo, hi):
    """The clouds of traffic ``spec`` (a traffic file's dict) for run seed
    ``seed``, inside the site bounds ``lo``, ``hi``: its generator's."""
    from perfbench.core import cell

    return cell.generator(spec["generator"])(spec, seed, lo, hi)
