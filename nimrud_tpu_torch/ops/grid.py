"""
Tiled neighbor search (port of the span-free tile-grid path of
``nimrud_tpu/ops/grid.py``).

The search cloud is binned into cubic tiles of edge >= the largest
radius and the query cloud into tiles ``m`` times coarser; every query's
neighborhood lies in the (m+2)^3 search tiles around its query tile.
:func:`build_tiled_problem` builds the static tables on the host, its
tile sorts and tables through the C++ host runtime (``ops.native``), as
the reference's native branches do.  :func:`tiled_features` runs
the moments on the device in entry batches through the
``entry_moments`` kernel (the reference's ``backend="pallas"`` branch),
then the feature layout, and scatters the rows back to caller order.

Not ported (ROADMAP.md Queue A #6, the XLA fallback and
reference-parity paths): the XLA moment path (``_entry_stats``,
``backend="xla"``), ``tiled_moments``, attributes and the ``vector``
layout, the chebyshev metric, reduced precisions in the sums and the
sazo layout (the entry kernel has neither a sazo fold nor attribute
rows; the reference takes the XLA path for them).
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from nimrud_tpu_torch.ops import native
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk


def _pow2(n, minimum=8):
    out = minimum
    while out < n:
        out *= 2
    return out


@dataclass
class TiledProblem:
    """Host-built static-shape description of one tiled query/search pair."""
    query_index: np.ndarray     # (E, Q_CAP) int32 into query array, -1 pad
    neighbor_rows: np.ndarray   # (E, (m+2)^3) int32 row into candidates
    candidates: np.ndarray      # (K+1, S_CAP) int32 into search array, -1 pad
    entry_centers: np.ndarray   # (E, 3) float32 query-tile centers
    tile_edge: float            # search tile edge (>= max radius)
    n_query: int
    stats: dict = field(default_factory=dict)

    @property
    def n_entries(self):
        return self.query_index.shape[0]


def _linear(coords, d):
    return coords[:, 0] + coords[:, 1] * d[0] + coords[:, 2] * d[0] * d[1]


def build_tiled_problem(query, search, tile_edge, *, query_tile_factor=2,
                        query_capacity=None, entry_batch=32, impl="native"):
    """
    Bin both clouds on the host: the tile sorts, the neighbor tables and
    the index tables through the C++ host runtime (``ops.native``), the
    rest vectorized NumPy.

    Args:
      tile_edge: search tile edge; must be >= the largest radius later
                 passed to :func:`tiled_features`.
      query_tile_factor: query tiles are this many search tiles across
                 (m).
      query_capacity: queries per entry; default a power of two around
                 2x the mean occupied-query-tile population (16..512).
      entry_batch: the entry count is padded to a multiple of this.
      impl:      ``"native"``, or ``"numpy"`` for the host runtime's
                 NumPy twins (the same tables, bit for bit).
    """
    query = np.asarray(query, dtype=np.float32)
    search = np.asarray(search, dtype=np.float32)
    tile_edge = float(tile_edge)
    m = int(query_tile_factor)

    # all cell-assignment math in float64
    (q_lo, q_hi), (s_lo, s_hi) = (native.minmax3(c[:, :3], impl=impl)
                                  for c in (query, search))
    lo = np.minimum(q_lo, s_lo).astype(np.float64) - 1e-3
    hi = np.maximum(q_hi, s_hi).astype(np.float64) + 1e-3
    dims = np.maximum(np.ceil((hi - lo) / tile_edge).astype(np.int64), 1)
    qdims = -(-dims // m)
    n_grid = int(dims.prod())
    dense_ok = n_grid <= (1 << 26)

    if dense_ok:
        s_ids, s_order, per_tile_counts = native.tile_sort(
            search, lo, tile_edge, dims, 1, impl=impl)
        _, q_order, q_tile_counts = native.tile_sort(
            query, lo, tile_edge, dims, m, impl=impl)
        tile_ids = np.nonzero(q_tile_counts)[0]
        tile_counts = q_tile_counts[tile_ids]
        tile_starts = (np.cumsum(q_tile_counts) - q_tile_counts)[tile_ids]
    else:
        # huge sparse grids: NumPy sorts (as the reference)
        s_coords = np.clip(
            np.floor((search.astype(np.float64) - lo) / tile_edge
                     ).astype(np.int64), 0, dims - 1)
        s_ids = _linear(s_coords, dims)
        s_order = np.argsort(s_ids, kind="stable").astype(np.int64)
        s_sorted_ids = s_ids[s_order]
        q_coords = np.clip(
            np.floor((query.astype(np.float64) - lo) / tile_edge
                     ).astype(np.int64), 0, dims - 1) // m
        q_ids = _linear(q_coords, qdims)
        q_order = np.argsort(q_ids, kind="stable").astype(np.int64)
        tile_ids, tile_starts = np.unique(q_ids[q_order], return_index=True)
        tile_counts = np.diff(np.append(tile_starts, len(query)))

    if query_capacity is None:
        query_capacity = int(
            np.clip(_pow2(2 * len(query) // max(len(tile_ids), 1),
                          minimum=16), 16, 512))
    q_cap = int(query_capacity)

    # split each query tile into entries of at most q_cap, padded to the
    # batch multiple
    entries_per_tile = -(-tile_counts // q_cap)
    n_entries = int(entries_per_tile.sum())
    e_pad = ((n_entries + entry_batch - 1) // entry_batch) * entry_batch
    entry_tile = np.full(e_pad, len(tile_ids), dtype=np.int64)
    entry_tile[:n_entries] = np.repeat(
        np.arange(len(tile_ids)), entries_per_tile)
    entry_rank = np.zeros(e_pad, dtype=np.int64)
    entry_rank[:n_entries] = (
        np.arange(n_entries)
        - np.repeat(np.cumsum(entries_per_tile)
                    - entries_per_tile, entries_per_tile))
    tile_starts_ext = np.append(tile_starts, 0)
    tile_counts_ext = np.append(tile_counts, 0)
    entry_start = tile_starts_ext[entry_tile] + entry_rank * q_cap
    entry_count = np.maximum(np.minimum(
        tile_counts_ext[entry_tile] - entry_rank * q_cap, q_cap), 0)
    query_index = native.fill_table(
        q_order, entry_start, entry_count, np.arange(e_pad), q_cap,
        impl=impl)[:-1]

    # candidate search tiles per occupied query tile: offsets -1..m
    n_off = (m + 2) ** 3
    tile_q_coords = np.stack(
        [tile_ids % qdims[0],
         (tile_ids // qdims[0]) % qdims[1],
         tile_ids // (qdims[0] * qdims[1])], axis=1)

    if dense_ok:
        # dense O(grid) maps: only tiles both occupied and next to a
        # query tile get candidate rows; empty neighbors share the
        # all-pad row
        tile_first = np.cumsum(per_tile_counts) - per_tile_counts
        neighbor_mask = native.mark_neighbors(tile_ids, dims, qdims, m,
                                              n_grid, impl=impl)
        needed = np.nonzero(neighbor_mask & (per_tile_counts > 0))[0]
        empty_row = len(needed)
        grid_row = np.full(n_grid, empty_row, dtype=np.int32)
        grid_row[needed] = np.arange(len(needed), dtype=np.int32)
        counts = per_tile_counts[needed]
        starts = tile_first[needed]
        tile_rows = native.neighbor_rows(tile_ids, dims, qdims, m, grid_row,
                                         empty_row, impl=impl)
    else:
        # huge sparse grids: binary searches over the sorted tile ids
        nid, ok = native.neighbor_ids(tile_ids, dims, qdims, m)
        nid = np.where(ok, nid, -1)
        needed = np.unique(nid[ok])
        empty_row = len(needed)
        starts = np.searchsorted(s_sorted_ids, needed, side="left")
        counts = (np.searchsorted(s_sorted_ids, needed, side="right")
                  - starts)
        if len(needed):
            rowpos = np.clip(
                np.searchsorted(needed, np.where(nid < 0, 0, nid)),
                0, len(needed) - 1)
            hit = (nid >= 0) & (needed[rowpos] == nid)
            tile_rows = np.where(hit, rowpos, empty_row).astype(np.int32)
        else:
            tile_rows = np.full((len(tile_ids), n_off), empty_row, np.int32)

    # candidate table: one row per needed tile (+ trailing all-pad row)
    s_cap = _pow2(int(counts.max()) if len(counts) else 1)
    candidates = native.fill_table(s_order, starts, counts,
                                   np.arange(len(needed)), s_cap, impl=impl)

    # entry_tile's padding rows point at the sentinel row appended here
    tile_rows_ext = np.vstack(
        [tile_rows, np.full((1, n_off), empty_row, np.int32)])
    neighbor_rows = tile_rows_ext[entry_tile]
    centers_by_tile = np.vstack(
        [(tile_q_coords + 0.5) * (m * tile_edge) + lo, np.zeros((1, 3))])
    centers = centers_by_tile[entry_tile]

    fill = entry_count.sum() / max(e_pad * q_cap, 1)
    return TiledProblem(
        query_index=query_index,
        neighbor_rows=neighbor_rows,
        candidates=candidates,
        entry_centers=centers.astype(np.float32),
        tile_edge=tile_edge,
        n_query=len(query),
        stats={"q_cap": q_cap, "s_cap": s_cap, "n_off": n_off,
               "entries": n_entries, "fill": float(fill)})


def _gather_batch(query_pad, search_pad, candidates, batch):
    """One entry batch's queries and flat candidate blocks, global and
    entry-local.  ``query_pad`` / ``search_pad`` end in a zero row that
    the -1 pads index."""
    q_idx, rows, centers = batch
    n_query_pad = query_pad.shape[0] - 1
    n_search_pad = search_pad.shape[0] - 1
    q_pts = query_pad[torch.where(q_idx < 0, n_query_pad, q_idx)]
    q_local = q_pts - centers[:, None, :]
    c_idx = candidates[rows]                       # (B, n_off, S_CAP)
    c_idx = c_idx.reshape(c_idx.shape[0], -1)      # (B, flat)
    s_valid = c_idx >= 0
    s_pts = search_pad[torch.where(s_valid, c_idx, n_search_pad)]
    s_local = s_pts - centers[:, None, :]
    return q_pts, q_local, s_local, s_valid


PRECISIONS = ("highest", "high", "default", "mixed")   # the reference's


def tiled_features(problem, query, search, radii, kind, *,
                   exclude_radius=None, entry_batch=32, precision="highest",
                   backend="pallas", device="cuda"):
    """
    Feature extraction through the tile grid on ``device`` (the card
    unless the caller asks for the CPU): per entry batch the gather,
    the ``entry_moments`` kernel and the feature layout, then one
    scatter back to the caller's query order (queries without an entry
    slot get zeros).  Returns an (n_query, width) float32 tensor.
    ``kind`` is any geometry layout but ``sazo``, which raises (and
    ``vector``, which needs attributes: it raises too).  ``precision``
    takes the reference's names (``PRECISIONS``); as in its
    ``backend="pallas"`` branch, the entry kernel's sums do not depend
    on it (only the XLA path, not ported, reads it).  ``exclude_radius``
    leaves out the pairs whose clamped expanded ``d2`` is below
    ``f32(e*e)`` (the entry kernel's exclusion instance).
    """
    from nimrud_tpu_torch.features import layouts

    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if layouts.needs_sazo(kind) or kind == "vector":
        raise NotImplementedError(
            f"kind={kind!r} on the tiled path (the reference's XLA "
            "_entry_stats) is not ported (ROADMAP.md Queue A #6, the XLA "
            "fallback and reference-parity paths)")
    radii = tuple(float(r) for r in radii)
    if max(radii) > problem.tile_edge + 1e-9:
        raise ValueError(
            f"radius {max(radii)} exceeds tile edge {problem.tile_edge}")
    if backend == "xla":
        raise NotImplementedError(
            "tiled_features(backend='xla') (_entry_stats) is not ported "
            "(ROADMAP.md Queue A #6, the XLA fallback and reference-parity "
            "paths)")
    if backend != "pallas":
        raise ValueError(f"unknown backend {backend!r}")

    def put(array, dtype):
        return torch.as_tensor(np.asarray(array), device=device).to(dtype)

    zero = torch.zeros((1, 3), dtype=torch.float32, device=device)
    query_pad = torch.cat([put(query, torch.float32)[:, :3], zero])
    search_pad = torch.cat([put(search, torch.float32)[:, :3], zero])
    q_index = put(problem.query_index, torch.int64)
    rows = put(problem.neighbor_rows, torch.int64)
    candidates = put(problem.candidates, torch.int64)
    centers = put(problem.entry_centers, torch.float32)

    feats = []
    for s in range(0, problem.n_entries, entry_batch):
        sl = slice(s, s + entry_batch)
        q_pts, q_local, s_local, s_valid = _gather_batch(
            query_pad, search_pad, candidates,
            (q_index[sl], rows[sl], centers[sl]))
        slabs = mk.entry_moments(q_local.contiguous(), s_local.contiguous(),
                                 s_valid.contiguous(), radii,
                                 exclude_radius=exclude_radius)
        feats.append(torch.cat(
            [layouts.build_block(kind, p["count"], p["mean"], p["cov"],
                                 q_pts, radius)
             for p, radius in zip(
                 mk.moments_from_slabs(slabs, centers[sl], radii), radii)],
            dim=-1))
    width = layouts.LAYOUT_WIDTHS[kind] * len(radii)
    feats = torch.cat(feats).reshape(-1, width)
    n_query = int(problem.n_query)
    flat_idx = q_index.reshape(-1)
    out = torch.zeros((n_query + 1, width), dtype=torch.float32,
                      device=device)
    out[torch.where(flat_idx < 0, n_query, flat_idx)] = feats
    return out[:n_query]
