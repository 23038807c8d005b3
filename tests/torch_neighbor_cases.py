"""
Neighbor-search cases shared by the CPU tests (against the JAX package)
and the card tests (against the CPU): no jax here.

* :func:`tie_case`: queries at the cell centers of an exactly
  representable 1/8 m grid, whose 8 corner points are equidistant.
* :func:`boundary_radius`: a radius whose ``f32(r*r)`` is one pair's
  computed ``d2`` exactly (or one ulp below it).
"""

import numpy as np
import torch

from nimrud_tpu_torch.ops import grid
from nimrud_tpu_torch.ops import neighbors


def grid_points(n=8, step=0.125):
    """The n^3 points of a cubic grid of ``step``, float32 (n^3, 3)."""
    axis = np.arange(n, dtype=np.float32) * np.float32(step)
    return np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                    -1).reshape(-1, 3)


def tie_case():
    """(query, search): 60 cell centers of the 8^3 grid of 1/8 m."""
    search = grid_points()
    return search[::7][:60] + np.float32(1 / 16), search


def entry_d2(query, search, radius):
    """Every (query row, search row) pair's ``d2`` as the port forms it
    on the tiled problem of ``radius``, as a dict of floats."""
    problem = grid.build_tiled_problem(query, search, radius,
                                       entry_batch=neighbors.ENTRY_BATCH)
    q_idx = torch.as_tensor(problem.query_index, dtype=torch.int64)
    c_idx = torch.as_tensor(problem.candidates, dtype=torch.int64)[
        torch.as_tensor(problem.neighbor_rows, dtype=torch.int64)].reshape(
        q_idx.shape[0], -1)
    centers = torch.as_tensor(problem.entry_centers)
    q_pad = torch.cat([torch.as_tensor(query), torch.zeros(1, 3)])
    s_pad = torch.cat([torch.as_tensor(search), torch.zeros(1, 3)])
    q_local = q_pad[torch.where(q_idx < 0, len(query), q_idx)] \
        - centers[:, None]
    s_local = s_pad[torch.where(c_idx < 0, len(search), c_idx)] \
        - centers[:, None]
    d2 = neighbors._expanded_d2(q_local, s_local)
    live = (q_idx[:, :, None] >= 0) & (c_idx[:, None, :] >= 0)
    return {(int(q_idx[e, q]), int(c_idx[e, s])): float(d2[e, q, s])
            for e, q, s in zip(*torch.nonzero(live, as_tuple=True))}


def boundary_radius(below=False):
    """(query, search, target search row, radius, d2 map): one query of
    a 1/4 m grid, the radius at which its fourth-nearest candidate's
    computed ``d2`` is exactly ``f32(r*r)`` (``below``: one ulp under
    it, so the candidate is out)."""
    search = grid_points(4, 0.25)
    query = np.array([[0.3, 0.35, 0.4]], np.float32)
    d2 = entry_d2(query, search, 0.5)
    (_, target), value = sorted(d2.items(), key=lambda kv: kv[1])[3]
    value = np.float32(value)
    if below:
        value = np.nextafter(value, np.float32(0))
    radius = float(np.sqrt(np.float64(value)))
    assert np.float32(radius * radius) == value
    return query, search, target, radius, d2
