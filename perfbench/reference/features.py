"""
The plain reference of what a served cloud's labels rest on: the uint16
upload against the site bounds, each band's voxel dedup of the search
cloud, the radius neighbourhoods of the query points, and the
configuration's layout over them (``reference/layouts/<kind>.py``).
Plain PyTorch, on any device, in float64 (or, for the lower-precision
control, float32 with its sums in TF32).

Semantics, stated here once:

* The upload: ``g = floor((p - lo) / step + 0.5)`` in float64, clipped
  to [0, 65535], with ``step = max(widest span of the bounds, 1e-6) /
  65000``; the served point is ``f32(g) * f32(step) + f32(lo)``, a
  float32 product and then a float32 sum.
* A band of edge ``e``: voxel keys ``floor((p - origin) / e)`` in
  float32 with ``origin = f32(lo - e / 2)``, clamped to the grid's
  power-of-two extent per axis; a voxel's point is its cell centre,
  ``(k * e + origin) + e / 2`` in float32.
* A query's neighbourhood at radius ``r``: every voxel centre with
  ``|c - q|^2 <= f32(r * r)``.  A pair within ``d2_tolerance`` of the
  radius cannot be decided by a float32 program: it is reported as
  ambiguous, and the comparison accepts either side of it.
* A band's features: the block of the configuration's layout, stated
  in its module under ``reference/layouts/``.

Nothing here imports the program under test.
"""

import math

import numpy as np
import torch

from perfbench.reference import layouts

QUANT_STEPS = 65000.0
MAX_KEY_BITS = 30
TF32_DROP_BITS = 13          # float32 keeps 23 mantissa bits, TF32 10
MAX_AMBIGUOUS = 4            # undecidable pairs a point enumerated


def d2_tolerance(radius):
    """Half-width of the band around ``r^2`` inside which a float32
    program's squared distance may fall on either side: its coordinates
    are rounded in a frame up to tens of metres from the pair."""
    return 3e-5 * max(float(radius), 1.0) ** 2


def tf32(x):
    """float32 values rounded to TF32 (10 mantissa bits), to nearest,
    ties to even."""
    bits = x.contiguous().view(torch.int32)
    low = (1 << TF32_DROP_BITS) - 1
    half = 1 << (TF32_DROP_BITS - 1)
    odd = (bits >> TF32_DROP_BITS) & 1
    bits = (bits + (half - 1) + odd) & ~low
    return bits.view(torch.float32)


class Upload:
    """The site's uint16 upload contract for fixed bounds ``lo``, ``hi``
    (float32 triples)."""

    def __init__(self, lo, hi):
        self.lo32 = np.asarray(lo, np.float32)
        self.hi32 = np.asarray(hi, np.float32)
        lo64 = self.lo32.astype(np.float64)
        span = float((self.hi32.astype(np.float64) - lo64).max())
        self.step = max(span, 1e-6) / QUANT_STEPS

    def served(self, points):
        """(n, 3) float32 tensor -> the float32 points the upload serves."""
        lo64 = torch.tensor(self.lo32.astype(np.float64), device=points.device)
        grid = torch.floor((points.to(torch.float64) - lo64) / self.step
                           + 0.5).clamp(0, 65535)
        step32 = torch.tensor(np.float32(self.step), device=points.device)
        lo32 = torch.tensor(self.lo32, device=points.device)
        return grid.to(torch.float32) * step32 + lo32


class VoxelGrid:
    """One band's voxel set of a search cloud, as a dense occupancy grid
    over the site bounds."""

    def __init__(self, search, lo, hi, edge):
        lo64 = np.asarray(lo, np.float32).astype(np.float64)
        hi64 = np.asarray(hi, np.float32).astype(np.float64)
        origin = lo64 - edge / 2
        span = (hi64 + edge / 2) - origin
        widths = np.maximum(np.ceil(np.log2(np.maximum(span / edge, 1.0))),
                            1).astype(int)
        if widths.sum() > MAX_KEY_BITS:
            raise ValueError("the site needs more than 30 key bits")
        self.edge = float(edge)
        self.dims = tuple(int(1 << w) for w in widths)
        device = search.device
        self.origin32 = torch.tensor(origin.astype(np.float32), device=device)
        self.edge32 = torch.tensor(np.float32(edge), device=device)
        self.half32 = torch.tensor(np.float32(edge * 0.5), device=device)
        cells = self.cells(search)
        self.occupied = torch.zeros(self.dims, dtype=torch.bool, device=device)
        self.occupied[cells[:, 0], cells[:, 1], cells[:, 2]] = True

    @property
    def count(self):
        return int(self.occupied.sum())

    def cells(self, points):
        """Voxel indices (n, 3) int64 of float32 points."""
        grid = torch.floor((points - self.origin32) / self.edge32)
        top = torch.tensor([d - 1 for d in self.dims], dtype=grid.dtype,
                           device=grid.device)
        return torch.minimum(grid.clamp(min=0), top).to(torch.int64)

    def centers(self, cells):
        """float32 centres of voxel indices."""
        return (cells.to(torch.float32) * self.edge32 + self.origin32) \
            + self.half32


def _window(radius, edge):
    reach = int(math.ceil(radius / edge)) + 1
    axis = torch.arange(-reach, reach + 1)
    return torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"),
                       dim=-1).reshape(-1, 3)


def neighbourhood(grid, queries, radius):
    """The voxel centres near each query (float32 queries (s, 3)): the
    centres (s, w, 3) float32, their squared distances (s, w) float64,
    masks (s, w) of the pairs inside the radius for certain (``inside``)
    and of the undecidable ones (``ambiguous``), and the centres' voxel
    indices (s, w, 3) (0 past the grid)."""
    offsets = _window(radius, grid.edge).to(queries.device)
    cells = grid.cells(queries)[:, None, :] + offsets[None]
    dims = torch.tensor(grid.dims, device=queries.device)
    valid = ((cells >= 0) & (cells < dims)).all(-1)
    cells = torch.where(valid[..., None], cells, 0)
    occupied = grid.occupied[cells[..., 0], cells[..., 1], cells[..., 2]]
    present = valid & occupied
    centers = grid.centers(cells)
    delta = centers.to(torch.float64) \
        - queries.to(torch.float64)[:, None, :]
    d2 = (delta * delta).sum(-1)
    r2 = float(np.float32(float(radius) * float(radius)))
    tol = d2_tolerance(radius)
    inside = present & (d2 < r2 - tol)
    ambiguous = present & ((d2 - r2).abs() <= tol)
    return centers, d2, inside, ambiguous, cells


class Scene:
    """A served cloud as the reference sees it: the query points and, per
    band, the search cloud's voxel grid.  ``quantized``: the query is
    its own search and travels as the uint16 upload; otherwise the
    query and the search map (the query itself where ``search`` is
    None) are served as float32.  ``frame_m``: the
    pitch of the lattice whose cells frame the control's float32 sums
    (the program's entries are at least that large).  ``kind``: the
    layout (``reference/layouts/<kind>.py``; one the folder lacks
    raises, naming those it has); ``attributes``: the search cloud's
    per-point columns (n, A), rows aligned with it, or None."""

    def __init__(self, query, search, bands, lo, hi, quantized, frame_m=1.5,
                 kind="minimal", attributes=None):
        self.layout = layouts.find(kind)
        self.bands = [(float(e), float(r)) for e, r in bands]
        if quantized:
            query = Upload(lo, hi).served(query)
        if quantized or search is None:
            search = query
        self.query = query
        self.search = search
        self.attributes = attributes
        self.cache = {}              # the layout's own, by its keys
        self.lo32 = torch.tensor(np.asarray(lo, np.float32),
                                 device=query.device)
        self.frame32 = torch.tensor(np.float32(frame_m), device=query.device)
        self.grids = [VoxelGrid(search, lo, hi, e) for e, _ in self.bands]

    @property
    def voxel_counts(self):
        return [g.count for g in self.grids]

    def pair_counts(self, rows):
        """In-radius pairs of the query ``rows`` a band (ambiguous pairs
        counted in)."""
        q = self.query[rows]
        return [int((inside | amb).sum())
                for grid, (_, r) in zip(self.grids, self.bands)
                for _, _, inside, amb, _ in [neighbourhood(grid, q, r)]]

    def layout_work(self):
        """The layout's own work a band (its ``work``), or {}."""
        work = getattr(self.layout, "work", None)
        return {} if work is None else work(self)

    def tied_rows(self, rows):
        """The layout's count of the query ``rows`` that rest on a
        decision a float32 program may take either way (its
        ``tied_rows``), or None."""
        tied = getattr(self.layout, "tied_rows", None)
        return None if tied is None else tied(self, rows)

    def _frames(self, q):
        cell = torch.floor((q - self.lo32) / self.frame32)
        return (cell + 0.5) * self.frame32 + self.lo32

    def features(self, rows, precision="float64"):
        """Feature rows of the query ``rows``: (m, width) with ``m >=
        len(rows)``, and ``owner`` (m,), the row each belongs to; the
        first ``len(rows)`` rows are the rows themselves.  A row with
        ambiguous pairs gets one feature row for every way of deciding
        up to ``MAX_AMBIGUOUS`` of them (past that, the rest are decided
        by the float64 distance)."""
        q = self.query[rows]
        device = q.device
        parts = [neighbourhood(g, q, r)
                 for g, (_, r) in zip(self.grids, self.bands)]
        widths = [p[0].shape[1] for p in parts]
        centers = torch.cat([p[0] for p in parts], 1)
        d2 = torch.cat([p[1] for p in parts], 1)
        inside = torch.cat([p[2] for p in parts], 1)
        amb = torch.cat([p[3] for p in parts], 1)
        cells = torch.cat([p[4] for p in parts], 1)
        r2 = torch.cat([torch.full((w,), float(np.float32(r * r)),
                                   dtype=torch.float64, device=device)
                        for w, (_, r) in zip(widths, self.bands)])
        owner = [torch.arange(q.shape[0], device=device)]
        masks = [inside.clone()]
        for row in torch.nonzero(amb.any(1)).flatten().tolist():
            lanes = torch.nonzero(amb[row]).flatten()
            chosen, rest = lanes[:MAX_AMBIGUOUS], lanes[MAX_AMBIGUOUS:]
            base = inside[row].clone()
            base[rest] = d2[row, rest] <= r2[rest]
            variants = []
            for bits in range(1 << len(chosen)):
                m = base.clone()
                for j, lane in enumerate(chosen.tolist()):
                    m[lane] = bool((bits >> j) & 1)
                variants.append(m)
            masks[0][row] = variants[0]
            if len(variants) > 1:
                masks.append(torch.stack(variants[1:]))
                owner.append(torch.full((len(variants) - 1,), row,
                                        device=device))
        mask = torch.cat(masks, 0)
        owner = torch.cat(owner, 0)
        centers, cells, q = centers[owner], cells[owner], q[owner]
        frame = self._frames(q) if precision != "float64" else None
        blocks, start = [], 0
        for band, w in enumerate(widths):
            sl = slice(start, start + w)
            blocks.append(self.layout.block(self, band, centers[:, sl],
                                            cells[:, sl], q, mask[:, sl],
                                            precision, frame))
            start += w
        return torch.cat(blocks, 1), owner
