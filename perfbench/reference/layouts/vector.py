"""
The ``vector`` layout (V_MSO): a band's block is, at each radius, the
mean of the search cloud's per-point attribute columns over the query's
neighbourhood, taken in two stages, as the program's
``ops/interp.py`` states them.

* The interp: a voxel centre's attribute vector is the mean of the
  columns of the raw search points ``p`` with ``max |p - c| <= f32(e)``
  (the chebyshev ball of one voxel edge ``e``), in float64 from the
  float32 points; the centres are the band's cell centres
  (``features.VoxelGrid``).  A point lies in the balls of its own cell
  and the 26 around it at most.
* The block: at radius ``r``, the mean of those vectors over the
  centres of the query's neighbourhood (``features.neighbourhood``,
  whose radius ties ``Scene.features`` enumerates): A columns, zeros
  for an empty neighbourhood.

An interp pair whose chebyshev distance lies within ``INTERP_BAND`` of
the edge is a tie: a float32 program may decide it either way.  It is
decided by the float64 test and counted (``work``'s
``interp_ambiguous``); ``tied_rows`` counts the query rows whose
neighbourhood holds a centre with a tie.

The lower-precision control (``"tf32"``) takes the same decisions and
sums each stage's terms -- the points' columns, then the centres'
means -- rounded to TF32 in float32, as the ``minimal`` control does
its moment terms.
"""

import itertools

import numpy as np
import torch

from perfbench.reference.features import neighbourhood, tf32

# How far a float32 program's chebyshev distance may stray from the
# float64 one: an axis difference taken in a float32 frame less than
# 64 m from the pair rounds each of its two local coordinates by half
# an ulp at most (1.9e-6 m) and the difference once more (under 6e-8 m
# at an edge up to 1 m): under 4e-6 m.  Sites span some 100 m, so
# 1e-5 m covers any frame inside one.  On the 102 m site's uint16 grid
# (1.57 mm steps) a point lies either on a ball's face or 3e-5 m or more
# from it, so the band holds the exact ties alone there.
INTERP_BAND = 1e-5
OFFSETS = list(itertools.product((-1, 0, 1), repeat=3))


class Interp:
    """One band's interp: ``index`` (the grid's dims) of each occupied
    cell's row in ``means`` (voxels, A) (-1 elsewhere), ``tied``
    (voxels,) the centres with a tie, ``pairs`` the in-ball pairs (ties
    counted in) and ``ambiguous`` the ties."""

    def __init__(self, grid, search, attributes, precision):
        device = search.device
        occupied = grid.occupied
        voxels = int(occupied.sum())
        self.index = torch.full(grid.dims, -1, dtype=torch.int32,
                                device=device)
        self.index[occupied] = torch.arange(voxels, dtype=torch.int32,
                                            device=device)
        if precision == "float64":
            dtype, terms = torch.float64, attributes.to(torch.float64)
        else:
            dtype, terms = torch.float32, tf32(attributes.to(torch.float32))
        sums = torch.zeros((voxels, terms.shape[1]), dtype=dtype,
                           device=device)
        count = torch.zeros(voxels, dtype=dtype, device=device)
        ones = torch.ones(search.shape[0], dtype=dtype, device=device)
        self.tied = torch.zeros(voxels, dtype=torch.bool, device=device)
        self.pairs = self.ambiguous = 0
        points = search.to(torch.float64)
        base = grid.cells(search)
        top = torch.tensor(grid.dims, device=device)
        edge = float(np.float32(grid.edge))
        for offset in OFFSETS:
            cells = base + torch.tensor(offset, device=device)
            valid = ((cells >= 0) & (cells < top)).all(1)
            cells = torch.where(valid[:, None], cells, 0)
            ids = self.index[cells[:, 0], cells[:, 1], cells[:, 2]].long()
            present = valid & (ids >= 0)
            dist = (grid.centers(cells).to(torch.float64)
                    - points).abs().amax(1)
            inside = present & (dist <= edge)
            tie = present & ((dist - edge).abs() <= INTERP_BAND)
            sums.index_add_(0, ids[inside], terms[inside])
            count.index_add_(0, ids[inside], ones[inside])
            self.tied[ids[tie]] = True
            self.pairs += int((inside | tie).sum())
            self.ambiguous += int(tie.sum())
        self.means = sums / count.clamp(min=1.0)[:, None]

    def rows(self, cells):
        """Rows of ``means`` of voxel indices ``cells`` (..., 3); 0 for
        an empty cell (masked out by the caller)."""
        ids = self.index[cells[..., 0], cells[..., 1], cells[..., 2]]
        return ids.long().clamp(min=0)


def interps(scene, precision):
    """The scene's interp a band at ``precision``, made once."""
    key = ("vector", precision)
    if key not in scene.cache:
        if scene.attributes is None:
            raise ValueError("the vector layout needs the search cloud's "
                             "attribute columns")
        scene.cache[key] = [Interp(g, scene.search, scene.attributes,
                                   precision) for g in scene.grids]
    return scene.cache[key]


def block(scene, band, centers, cells, queries, mask, precision, frame):
    """The band's block (s, A): the masked mean of the centres'
    interpolated columns."""
    interp = interps(scene, precision)[band]
    values = interp.means[interp.rows(cells)]             # (s, w, A)
    if precision == "float64":
        w = mask.to(torch.float64)
        sums = (w[..., None] * values).sum(1)
    else:
        w = mask.to(torch.float32)
        sums = torch.einsum("sw,swk->sk", w, tf32(values))
    return sums / w.sum(1).clamp(min=1.0)[:, None]


def work(scene):
    """A band's interp pairs and ties (the whole search cloud) and its
    attribute columns a radius."""
    bands = interps(scene, "float64")
    return {"interp_pairs": [b.pairs for b in bands],
            "interp_ambiguous": [b.ambiguous for b in bands],
            "attr_cols": [int(b.means.shape[1]) for b in bands]}


def tied_rows(scene, rows):
    """How many query ``rows`` have, in some band, a centre with an
    interp tie in their neighbourhood (radius ties counted in)."""
    q = scene.query[rows]
    touched = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for interp, grid, (_, r) in zip(interps(scene, "float64"), scene.grids,
                                    scene.bands):
        _, _, inside, amb, cells = neighbourhood(grid, q, r)
        touched |= ((inside | amb) & interp.tied[interp.rows(cells)]).any(1)
    return int(touched.sum())
