"""
Tiled neighbor search (port of ``nimrud_tpu/ops/grid.py``).

The search cloud is binned into cubic tiles of edge >= the largest
radius and the query cloud into tiles ``m`` times coarser; every query's
neighborhood lies in the (m+2)^3 search tiles around its query tile.
:func:`build_tiled_problem` builds the static tables on the host, its
tile sorts and tables through the C++ host runtime (``ops.native``), as
the reference's native branches do.  :func:`tiled_features` runs the
moments on the device in entry batches -- the XLA path
(:func:`_entry_stats`: difference-form ``d2``, masked float32 matrix
products, both metrics, attributes and the sazo layout; the default) or
the ``entry_moments`` kernel (``backend="pallas"``, where the reference
runs its Pallas kernel) -- then the feature layout, and scatters the
rows back to caller order.  :func:`tiled_moments` returns the raw
moments of the XLA path in query order (the attribute interp of
``features.multiscale.voxel_downsample``).
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from nimrud_tpu_torch.ops import moments, native
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


def _gather_batch(query_pad, search_pad, candidates, batch, attr_pad=None,
                  build_aug=False):
    """One entry batch's queries and flat candidate blocks, global and
    entry-local (``query_pad`` / ``search_pad`` end in a zero row that
    the -1 pads index).  Returns ``(q_pts, q_local, s_local, s_valid,
    aug)``: with ``build_aug`` the XLA path's augmented candidate rows
    ``[1, s, s (x) s]`` of the entry-local coordinates, then the
    candidates' rows of ``attr_pad``; else ``aug`` is None."""
    q_idx, rows, centers = batch
    n_query_pad = query_pad.shape[0] - 1
    n_search_pad = search_pad.shape[0] - 1
    q_pts = query_pad[torch.where(q_idx < 0, n_query_pad, q_idx)]
    q_local = q_pts - centers[:, None, :]
    c_idx = candidates[rows]                       # (B, n_off, S_CAP)
    c_idx = c_idx.reshape(c_idx.shape[0], -1)      # (B, flat)
    s_valid = c_idx >= 0
    safe = torch.where(s_valid, c_idx, n_search_pad)
    s_local = search_pad[safe] - centers[:, None, :]
    aug = None
    if build_aug:
        aug = moments._augment(
            s_local, None if attr_pad is None else attr_pad[safe])
    return q_pts, q_local, s_local, s_valid, aug


# the reference's precision names; on the card every one sums in f32
# with TF32 off, as JAX does on the CPU (a bf16 emulation of the TPU's
# HIGH / DEFAULT passes is not ported)
PRECISIONS = ("highest", "high", "default", "mixed")


def _check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


def _entry_stats(q_local, s_local, s_valid, aug, radii, exclude_radius,
                 metric="euclidean", with_sazo=False):
    """Masked moments of one batch of entries, the XLA path: the
    difference-form ``d2`` of the entry-local coordinates (``(q - c) -
    (s - c)``, one operation at a time; chebyshev squares ``max |d|``),
    the ball masks against ``f32(r*r)`` and the exclusion, and one
    batched float32 matrix product ``mask @ aug`` a radius.  Returns a
    list, per radius, of ``moments.ball_stats`` (``count``,
    ``mean_local``, ``cov``, ``attr_mean``, with ``with_sazo`` also
    ``sazo`` from the entry-local z offsets)."""
    d2 = moments.distance2(q_local, s_local, metric)
    base = s_valid[:, None, :]
    if exclude_radius is not None:
        base = base & (d2 >= mk.exclusion_threshold(exclude_radius))
    dz = (s_local[:, None, :, 2] - q_local[:, :, None, 2]) \
        if with_sazo else None
    per_radius = []
    for r2 in mk.squared_radii(radii):
        in_ball = base & (d2 <= float(r2))
        mom = torch.bmm(in_ball.to(torch.float32), aug)
        per_radius.append(moments.ball_stats(mom, in_ball, dz))
    return per_radius


def _check_radii(problem, radii):
    radii = tuple(float(r) for r in radii)
    if max(radii) > problem.tile_edge + 1e-9:
        raise ValueError(
            f"radius {max(radii)} exceeds tile edge {problem.tile_edge}")
    return radii


def _problem_tensors(problem, query, search, attributes, device):
    """The tiled tables and the clouds on ``device``: padded query and
    search rows (a trailing zero row), attribute rows or None, and the
    (query_index, neighbor_rows, entry_centers) table triple."""
    def put(array, dtype):
        return torch.as_tensor(np.asarray(array), device=device).to(dtype)

    zero = torch.zeros((1, 3), dtype=torch.float32, device=device)
    query_pad = torch.cat([put(query, torch.float32)[:, :3], zero])
    search_pad = torch.cat([put(search, torch.float32)[:, :3], zero])
    attr_pad = None
    if attributes is not None:
        attr = put(attributes, torch.float32)
        attr_pad = torch.cat([attr, attr.new_zeros((1, attr.shape[1]))])
    tables = (put(problem.query_index, torch.int64),
              put(problem.neighbor_rows, torch.int64),
              put(problem.entry_centers, torch.float32))
    return (query_pad, search_pad, attr_pad, tables,
            put(problem.candidates, torch.int64))


def _entry_batches(tables, entry_batch):
    """The (query_index, neighbor_rows, centers) slices of each entry
    batch in turn (the reference's ``lax.map``; every entry is
    independent, so the batch size moves no result)."""
    n_entries = tables[0].shape[0]
    for lo in range(0, n_entries, entry_batch):
        yield tuple(t[lo:lo + entry_batch] for t in tables)


def tiled_batch_features(query_pad, search_pad, attr_pad, tables,
                         candidates, radii, kind, exclude_radius,
                         entry_batch, n_query, metric="euclidean",
                         use_kernel=False):
    """Feature rows of every entry batch scattered to caller order,
    (n_query, width): per batch the gather, the moments (the
    ``entry_moments`` kernel with ``use_kernel``, else
    :func:`_entry_stats`) and the layout (``vector``: the attribute
    means, A columns a radius).  Query slots without a query (and query
    indices past ``n_query``) land in a discarded sentinel row."""
    from nimrud_tpu_torch.features import layouts

    sazo = layouts.needs_sazo(kind)
    feats = []
    for batch in _entry_batches(tables, entry_batch):
        centers = batch[2]
        q_pts, q_local, s_local, s_valid, aug = _gather_batch(
            query_pad, search_pad, candidates, batch, attr_pad,
            build_aug=not use_kernel)
        if use_kernel:
            slabs = mk.entry_moments(
                q_local.contiguous(), s_local.contiguous(),
                s_valid.contiguous(), radii, exclude_radius=exclude_radius)
            per_radius = mk.moments_from_slabs(slabs, centers, radii)
        else:
            per_radius = _entry_stats(q_local, s_local, s_valid, aug, radii,
                                      exclude_radius, metric, sazo)
        blocks = []
        for p, radius in zip(per_radius, radii):
            if kind == "vector":
                blocks.append(p["attr_mean"])
            else:
                blocks.append(layouts.build_block(
                    kind, p["count"], p["mean_local"] + centers[:, None, :],
                    p["cov"], q_pts, radius, sazo=p.get("sazo")))
        feats.append(torch.cat(blocks, dim=-1))
        del q_local, s_local, s_valid, aug, per_radius
    feats = torch.cat(feats)
    width = feats.shape[-1]
    flat_idx = tables[0].reshape(-1)
    out = feats.new_zeros((n_query + 1, width))
    out[torch.where((flat_idx < 0) | (flat_idx >= n_query), n_query,
                    flat_idx)] = feats.reshape(-1, width)
    return out[:n_query]


def tiled_moments(problem, query, search, radii, *, attributes=None,
                  exclude_radius=None, entry_batch=32,
                  precision="highest", metric="euclidean",
                  with_sazo=False, device="cuda"):
    """
    Neighborhood moments through the tile grid on ``device`` (the card
    unless the caller asks for the CPU), the XLA path
    (:func:`_entry_stats`) one entry batch at a time, aligned to the
    query order.  Returns the dict of ``ops.moments.multiscale_moments``
    as NumPy arrays (queries without an entry slot get zeros):
    ``count``, ``mean``, ``cov``, with ``attributes`` (rows aligned with
    ``search``) ``attr_mean``, with ``with_sazo`` ``sazo``.
    ``precision``: the reference's names (``PRECISIONS``), all f32 sums
    here.
    """
    _check_precision(precision)
    radii = _check_radii(problem, radii)
    query_pad, search_pad, attr_pad, tables, candidates = _problem_tensors(
        problem, query, search, attributes, device)
    parts = []
    for batch in _entry_batches(tables, entry_batch):
        _, q_local, s_local, s_valid, aug = _gather_batch(
            query_pad, search_pad, candidates, batch, attr_pad,
            build_aug=True)
        per_radius = _entry_stats(q_local, s_local, s_valid, aug, radii,
                                  exclude_radius, metric, with_sazo)
        out = {"count": torch.stack([p["count"] for p in per_radius], 2),
               "mean": torch.stack([p["mean_local"] + batch[2][:, None, :]
                                    for p in per_radius], 2),
               "cov": torch.stack([p["cov"] for p in per_radius], 2)}
        if attributes is not None:
            out["attr_mean"] = torch.stack(
                [p["attr_mean"] for p in per_radius], 2)
        if with_sazo:
            out["sazo"] = torch.stack([p["sazo"] for p in per_radius], 2)
        parts.append(out)
    valid = tables[0] >= 0
    rows = tables[0][valid]
    result = {}
    for key in parts[0]:
        value = torch.cat([p[key] for p in parts])
        shaped = value.new_zeros((int(problem.n_query),) + value.shape[2:])
        shaped[rows] = value[valid]
        result[key] = shaped.cpu().numpy()
    return result


def tiled_features(problem, query, search, radii, kind, *, attributes=None,
                   exclude_radius=None, entry_batch=32, precision="highest",
                   backend="xla", metric="euclidean", device="cuda"):
    """
    Feature extraction through the tile grid on ``device`` (the card
    unless the caller asks for the CPU): per entry batch the gather, the
    moments and the feature layout, then one scatter back to the
    caller's query order (queries without an entry slot get zeros).
    Returns an (n_query, width) float32 tensor.

    ``backend="xla"`` (the default, as the reference's) sums with
    :func:`_entry_stats`; ``"pallas"`` runs the ``entry_moments``
    kernel (its expanded-form ``d2``, a contract of its own) where the
    reference's ``backend="pallas"`` branch does -- euclidean, no
    attributes, no sazo -- and the XLA sums elsewhere, as the reference
    routes it.  ``kind``: a geometry layout, or ``"vector"`` with
    ``attributes`` (rows aligned with ``search``): their masked means, A
    columns a radius.  ``metric="chebyshev"``: the max-norm ball.
    ``precision``: the reference's names (``PRECISIONS``); every one
    sums in f32 here, and the entry kernel's sums do not read it.
    ``exclude_radius`` leaves out the pairs whose ``d2`` (the entry
    kernel's clamped expanded form on its branch) is below ``f32(e*e)``.
    """
    from nimrud_tpu_torch.features import layouts

    _check_precision(precision)
    if backend not in ("xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if kind == "vector" and attributes is None:
        raise ValueError("kind='vector' requires attributes")
    radii = _check_radii(problem, radii)
    use_kernel = (backend == "pallas" and attributes is None
                  and not layouts.needs_sazo(kind) and metric == "euclidean")
    query_pad, search_pad, attr_pad, tables, candidates = _problem_tensors(
        problem, query, search, attributes, device)
    return tiled_batch_features(
        query_pad, search_pad, attr_pad, tables, candidates, radii, kind,
        exclude_radius, entry_batch, int(problem.n_query), metric=metric,
        use_kernel=use_kernel)
