"""
Feature rows for the random-projection-tree tests (``test_torch_rpt.py``,
``test_torch_persistence.py``): three overlapping Gaussian classes in 12
dimensions (the bench model's width: 3 bands x 4 minimal features),
drawn from a seed.  The class centers are fixed, so fits on one draw
classify another.
"""

import numpy as np

DIM = 12
N_CLASSES = 3
_CENTERS = np.random.RandomState(99).normal(0.0, 1.2, (N_CLASSES, DIM))
_SCALES = np.random.RandomState(98).uniform(0.5, 2.0, DIM)


def forest_data(n, seed, spread=1.0):
    """(n, 12) float32 features and (n,) int32 labels; ``spread`` scales
    the classes' noise (below 1 they overlap less)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, n)
    feats = _CENTERS[labels] + rng.normal(0.0, spread, (n, DIM)) * _SCALES
    return feats.astype(np.float32), labels.astype(np.int32)


def numpy_tables(tables):
    """A forest's table dict as NumPy arrays, without the reference's
    derived blocked-walk tables."""
    return {k: np.array(v) for k, v in tables.items()
            if not k.startswith("dense_blk")}
