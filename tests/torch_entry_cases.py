"""
Inputs of the ``entry_moments`` tests, in NumPy only (the card tests
import this where jax is not installed).

The tiled path's candidate blocks are 125 neighbour tiles x ``s_cap``
slots, each tile's valid slots first (``ops/grid._fill_table``); at the
1M-point bench scene about 14% of the slots are valid.  ``layout``
picks the validity:

* ``"tiled"``  -- 8-slot groups, each a prefix of 0..8 valid slots
  (Poisson, mean 1.1: about 14% of the slots);
* ``"random"`` -- every slot valid with probability 0.7;
* ``"sparse"`` -- every slot valid with probability 0.02 (a compaction
  chunk of 4096 slots holds fewer valid rows than one tile).

``exact`` puts the coordinates on a 1/8 grid, where every f32 operation
of the expanded distance is exact, with candidates exactly at distance r
from a query along an axis.

Entry 0 has no valid candidate and entry 1 only valid ones.
"""

import numpy as np

SHARES = {"random": 0.7, "sparse": 0.02}


def entry_problem(n_entries, q_cap, flat, radii, seed, layout="random",
                  exact=False):
    """(q_local (E, Q, 3) f32, s_local (E, F, 3) f32, s_valid (E, F)
    bool)."""
    rng = np.random.default_rng(seed)
    if exact:
        q = rng.integers(-16, 17, (n_entries, q_cap, 3)) / 8.0
        s = rng.integers(-24, 25, (n_entries, flat, 3)) / 8.0
        for i in range(min(q_cap, flat // 2)):
            s[:, i] = q[:, i]
            s[:, i, i % 3] += radii[i % len(radii)] * (1 if i % 2 else -1)
    else:
        q = rng.uniform(-1.5, 1.5, (n_entries, q_cap, 3))
        s = rng.uniform(-2.5, 2.5, (n_entries, flat, 3))
    if layout == "tiled":
        fill = np.minimum(rng.poisson(1.1, (n_entries, -(-flat // 8))), 8)
        valid = (np.arange(8) < fill[..., None]).reshape(n_entries, -1)
        valid = valid[:, :flat]
    else:
        valid = rng.random((n_entries, flat)) < SHARES[layout]
    valid[0] = False
    valid[1] = True
    return q.astype(np.float32), s.astype(np.float32), valid


def with_nan(q, s, valid):
    """The same inputs with query 1 of every entry and a valid candidate
    of every entry at NaN (one coordinate each)."""
    q, s, valid = q.copy(), s.copy(), valid.copy()
    q[:, 1, 0] = np.nan
    s[:, 2, 1] = np.nan
    valid[:, 2] = True
    return q, s, valid
