"""
The port's runnable examples, each a user flow end to end on the card
(or on the CPU with ``--device cpu``):

    python -m nimrud_tpu_torch.examples.serving [--points N] [--device D]
    python -m nimrud_tpu_torch.examples.training [--points N] [--device D]

``serving`` fits once, persists the pipeline and serves a stream of
scans from the loaded copy; ``training`` drives the archive workflow
from ingest to a classified LAS export.  Both build the synthetic site
of :func:`synthetic_site`.
"""

import argparse
import tempfile

import numpy as np


def synthetic_site(n, rng):
    """Ground plane + walls + canopy on a 60 m site, like an outdoor
    LiDAR scan: (n, 3) float32 points and their (n,) int32 labels (0
    ground, 1 wall, 2 canopy)."""
    ground = rng.random((n // 2, 3)) * [60, 60, 0.15]
    walls = rng.random((n // 4, 3)) * [0.25, 10, 8] + [20, 20, 0]
    canopy = rng.normal([40, 40, 6], [8, 8, 1.5], (n // 4, 3))
    cloud = np.vstack([ground, walls, canopy]).astype(np.float32)[:n]
    labels = np.concatenate([
        np.zeros(n // 2, np.int32),
        np.ones(n // 4, np.int32),
        np.full(n // 4, 2, np.int32)])[:n]
    return cloud, labels


def parse_args(description, points, argv=None):
    """``--points`` (default ``points``), ``--device`` (default cuda) and
    ``--workdir`` (default a new temporary directory)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--points", type=int, default=points,
                        help="points of the synthetic site")
    parser.add_argument("--device", default="cuda",
                        help="where the port runs (cuda or cpu)")
    parser.add_argument("--workdir", default=None,
                        help="directory for the outputs (default: a new "
                             "temporary directory)")
    args = parser.parse_args(argv)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="nimrud_example_")
    return args
