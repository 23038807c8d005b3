"""
Device-resident packed and span extraction (port of the packed and span
paths of ``nimrud_tpu/ops/device_grid.py``).

One query plan packs queries into entries of ``q_cap`` consecutive
tile-sorted ranks within coarse-row segments; each band derives every
entry's candidate x-row spans from its own fine grid, packs them into
one ``c_cap``-lane candidate block per entry (split into capacity
buckets), and runs the ``packed_moments`` kernel.  Search-side
attributes (the ``vector`` layout and the packed attribute interp) ride
the same plan: they travel as sort payloads beside the coordinates and
come back as candidate rows 3..3+A.  The XLA candidate-table path
(:func:`build_tables`, :func:`fused_extract`) plans one coarse tile an
entry over a candidate table of the whole fine grid and sums with the
masked float32 matrix products of ``grid._entry_stats``: no kernel.  The span path
(:func:`fused_extract_spans`) hands the same spans to the
``span_moments`` kernel, which reads them in place.  The TPU-only layout
detours (lanes-major search tables, VMEM entry batching, gather
chunking) are not ported: the port keeps one layout per table.

Every gather clamps its indices where the reference relied on XLA's
implicit clamping (CUDA index kernels assert instead).

Host sizing (``DeviceGridSpec``, ``make_spec``, ``estimate_entries``,
``with_entry_estimate``) is the reference's, copied: the entry estimate
counts populations with the C++ host runtime's tile sort
(``ops.native``).
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from nimrud_tpu_torch.ops import native
from nimrud_tpu_torch.ops.grid import _pow2
from nimrud_tpu_torch.ops.packing import scalar
from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
from nimrud_tpu_torch.ops.kernels import packed_moments as pm
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import moments_from_slabs
from nimrud_tpu_torch.utils import profiling

_BIG = 2**31 - 1


@dataclass(frozen=True)
class DeviceGridSpec:
    """Static description of one fused extraction problem."""
    lo: tuple                 # fine-grid origin (float)
    dims: tuple               # fine-grid dimensions (int, bucketed)
    tile_edge: float
    m: int                    # query tiles are m fine tiles across
    q_cap: int                # queries per entry
    s_cap: int                # max search points per fine tile
    e_cap: int                # entry capacity (multiple of entry_batch)
    entry_batch: int
    x_seg: int = 1            # coarse tiles per entry-packing segment

    @property
    def qdims(self):
        return tuple(-(-d // self.m) for d in self.dims)

    @property
    def seg_shape(self):
        """(segments per coarse row, total segments)."""
        qd = self.qdims
        x_seg = max(min(self.x_seg, qd[0]), 1)
        nseg_x = -(-qd[0] // x_seg)
        return nseg_x, nseg_x * qd[1] * qd[2]

    @property
    def n_grid(self):
        d = self.dims
        return d[0] * d[1] * d[2]

    @property
    def n_qgrid(self):
        d = self.qdims
        return d[0] * d[1] * d[2]


def make_spec(bounds_lo, bounds_hi, tile_edge, *, n_query, m=3, q_cap=128,
              s_cap=None, voxel_edge=None, entry_batch=256,
              dims_round=16, x_seg=1):
    """Static spec from dataset bounds (copy of the reference's host
    code).  ``s_cap`` derives exactly from ``voxel_edge`` for
    voxel-downsampled search sets."""
    lo = np.asarray(bounds_lo, np.float64) - 1e-3
    hi = np.asarray(bounds_hi, np.float64) + 1e-3
    dims = np.maximum(np.ceil((hi - lo) / tile_edge).astype(np.int64), 1)
    dims = ((dims + dims_round - 1) // dims_round) * dims_round

    if s_cap is None:
        if voxel_edge is None:
            raise ValueError("need s_cap or voxel_edge")
        per_axis = int(np.ceil(tile_edge / voxel_edge)) + 1
        s_cap = _pow2(per_axis ** 3)
    qdims = -(-dims // m)
    x_seg = max(min(int(x_seg), int(qdims[0])), 1)
    nseg_x = int(-(-qdims[0] // x_seg))
    n_seg = nseg_x * int(qdims[1]) * int(qdims[2])
    raw_entries = n_seg + n_query // q_cap + 1
    e_cap = ((raw_entries + entry_batch - 1) // entry_batch) * entry_batch
    return DeviceGridSpec(
        lo=tuple(float(v) for v in lo),
        dims=tuple(int(d) for d in dims),
        tile_edge=float(tile_edge),
        m=int(m), q_cap=int(q_cap), s_cap=int(_pow2(s_cap)),
        e_cap=int(e_cap), entry_batch=int(entry_batch), x_seg=x_seg)


def estimate_entries(query, spec):
    """Host-exact entry demand: the sum of ceil(population / q_cap) over
    occupied coarse-row segments, the populations from the host
    runtime's tile sort."""
    query = np.asarray(query, np.float32)
    lo = np.asarray(spec.lo, np.float64)
    dims = np.asarray(spec.dims, np.int64)
    qd = spec.qdims
    got = native.tile_sort(query, lo, spec.tile_edge, dims, spec.m)
    if got is not None:
        counts = got[2]
    else:                        # a coarse grid past int32 ids
        cell = np.clip(
            np.floor((query.astype(np.float64) - lo) / spec.tile_edge
                     ).astype(np.int64), 0, dims - 1) // spec.m
        ids = cell[:, 0] + cell[:, 1] * qd[0] + cell[:, 2] * qd[0] * qd[1]
        counts = np.bincount(ids, minlength=int(np.prod(qd)))
    x_seg = max(min(spec.x_seg, qd[0]), 1)
    if x_seg > 1:
        nseg_x, _ = spec.seg_shape
        counts = np.asarray(counts).reshape(qd[2] * qd[1], qd[0])
        pad = nseg_x * x_seg - qd[0]
        if pad:
            counts = np.pad(counts, ((0, 0), (0, pad)))
        counts = counts.reshape(-1, nseg_x, x_seg).sum(axis=2)
    return int(np.sum(-(-counts // spec.q_cap)))


def with_entry_estimate(spec, query):
    """Spec with ``e_cap`` sized from measured occupancy plus headroom
    (an eighth extra and at least two entry batches)."""
    need = estimate_entries(query, spec)
    need += max(need // 8, 2 * spec.entry_batch)
    e_cap = ((need + spec.entry_batch - 1)
             // spec.entry_batch) * spec.entry_batch
    if e_cap >= spec.e_cap:
        return spec
    return dataclasses.replace(spec, e_cap=e_cap)


# -- plan ---------------------------------------------------------------------

def _encode(points, spec, coarse):
    """Linear tile ids (int64), clipped into the grid."""
    lo = torch.tensor(spec.lo, dtype=points.dtype, device=points.device)
    cell = torch.floor((points - lo) / scalar(spec.tile_edge, points))
    cell = cell.to(torch.int64)
    dims = torch.tensor(spec.dims, dtype=torch.int64, device=points.device)
    cell = torch.minimum(torch.clamp(cell, min=0), dims - 1)
    if coarse:
        cell = cell // spec.m
        d = spec.qdims
    else:
        d = spec.dims
    return cell[:, 0] + cell[:, 1] * d[0] + cell[:, 2] * (d[0] * d[1])


def _sort_and_count(ids, valid, n_grid):
    """Stable sort by id (invalid rows last, as ``n_grid``); per-tile
    counts and exclusive starts."""
    ids = torch.where(valid, ids, n_grid)
    order = torch.sort(ids, stable=True).indices
    counts = torch.bincount(ids, minlength=n_grid + 1)[:n_grid]
    starts = torch.cumsum(counts, 0) - counts
    return order, counts, starts


def _tile_of_entry(offsets, e_cap, n_qgrid):
    """entry -> coarse tile: the largest t with ``offsets[t] <= e`` (a
    scatter-max of each tile at its first entry, the empty tiles sharing
    a slot resolved to the largest, then a forward fill).  First-entry
    slots at or past ``e_cap`` are dropped, as the reference's
    ``mode="drop"``."""
    first_entry = offsets[:-1]
    slot = torch.where(first_entry < e_cap, first_entry, e_cap)
    first = torch.zeros(e_cap + 1, dtype=torch.int64,
                        device=offsets.device)
    first.scatter_reduce_(
        0, slot, torch.arange(first_entry.shape[0], device=offsets.device),
        reduce="amax")
    return torch.clamp(torch.cummax(first[:e_cap], 0).values, 0,
                       n_qgrid - 1)


def build_tables(query, q_valid, search, s_valid, spec, with_stats=False):
    """
    The XLA candidate-table plan on the device: ``(query_index,
    neighbor_rows, candidates, entry_centers)`` with the semantics of
    the host ``grid.TiledProblem``, except that candidate rows are
    indexed by fine tile id (row ``n_grid`` is the all-pad row).
    Entries are one coarse tile's queries, ``q_cap`` at a time.

    With ``with_stats`` a fifth element holds the overflow counters:
    ``dropped_search`` (search points past ``s_cap`` in their fine tile,
    left out of every neighborhood) and ``dropped_query`` (valid queries
    without an entry slot, which get zero features).
    """
    dev = query.device
    n_grid, n_qgrid = spec.n_grid, spec.n_qgrid
    n_search = search.shape[0]
    n_query = query.shape[0]

    # candidates over the full fine grid
    s_order, s_counts, s_starts = _sort_and_count(
        _encode(search, spec, coarse=False), s_valid, n_grid)
    col = torch.arange(spec.s_cap, dtype=torch.int64, device=dev)
    gather_at = torch.clamp(s_starts[:, None] + col[None, :], 0,
                            n_search - 1)
    in_tile = col[None, :] < torch.clamp(s_counts, max=spec.s_cap)[:, None]
    candidates = torch.where(in_tile, s_order[gather_at], -1)
    candidates = torch.cat([candidates, candidates.new_full(
        (1, spec.s_cap), -1)])

    # entries over the coarse grid
    q_order, q_counts, q_starts = _sort_and_count(
        _encode(query, spec, coarse=True), q_valid, n_qgrid)
    per_tile = -(-q_counts // spec.q_cap)
    offsets = torch.cat([per_tile.new_zeros(1), torch.cumsum(per_tile, 0)])
    entry = torch.arange(spec.e_cap, dtype=torch.int64, device=dev)
    tile = _tile_of_entry(offsets, spec.e_cap, n_qgrid)
    rank = entry - offsets[tile]
    live = entry < offsets[n_qgrid]
    count = torch.clamp(q_counts[tile] - rank * spec.q_cap, 0, spec.q_cap)
    count = torch.where(live, count, 0)
    start = q_starts[tile] + rank * spec.q_cap
    qcol = torch.arange(spec.q_cap, dtype=torch.int64, device=dev)
    q_gather = torch.clamp(start[:, None] + qcol[None, :], 0, n_query - 1)
    query_index = torch.where(qcol[None, :] < count[:, None],
                              q_order[q_gather], -1)

    # neighbor rows and centers per entry
    qd, dims, m = spec.qdims, spec.dims, spec.m
    tx = tile % qd[0]
    ty = (tile // qd[0]) % qd[1]
    tz = tile // (qd[0] * qd[1])
    rows = []
    for dx in range(-1, m + 1):
        for dy in range(-1, m + 1):
            for dz in range(-1, m + 1):
                x, y, z = tx * m + dx, ty * m + dy, tz * m + dz
                ok = ((x >= 0) & (x < dims[0]) & (y >= 0) & (y < dims[1])
                      & (z >= 0) & (z < dims[2]))
                fine = x + y * dims[0] + z * (dims[0] * dims[1])
                rows.append(torch.where(ok, fine, n_grid))
    neighbor_rows = torch.stack(rows, dim=1)
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=dev)
    coords = torch.stack([tx, ty, tz], dim=1).to(torch.float32)
    centers = (coords + 0.5) * scalar(m * spec.tile_edge, lo) + lo
    tables = (query_index, neighbor_rows, candidates, centers)
    if not with_stats:
        return tables
    stats = {"dropped_search": torch.clamp(s_counts - spec.s_cap,
                                           min=0).sum(),
             "dropped_query": q_valid.sum() - count.sum()}
    return tables + (stats,)


def _gather_q_t(q_sorted, q_gather):
    """Tile-sorted (n, 3) queries -> (E, 3, q_cap) kernel query blocks."""
    return q_sorted[q_gather].permute(0, 2, 1).contiguous()


def _pack_plan(query, q_valid, spec):
    """Query-side entry packing on ``spec``'s coarse segment grid: one
    stable tile-id sort of the queries, rank-block entries within
    coarse-row segments, per-entry coarse-x ranges and entry centers.
    The multi-band path runs it once and shares it across bands."""
    dev = query.device
    n_qgrid = spec.n_qgrid
    n_query = query.shape[0]
    qd = spec.qdims
    x_seg = max(min(spec.x_seg, qd[0]), 1)
    nseg_x, n_seg = spec.seg_shape
    q_cap = spec.q_cap

    # tile ids linearize x fastest: one sort groups queries by segment
    # and leaves each segment x-sorted
    q_iota = torch.arange(n_query, dtype=torch.int64, device=dev)
    q_ids = torch.where(q_valid, _encode(query, spec, coarse=True), n_qgrid)
    sorted_qids, q_order = torch.sort(q_ids, stable=True)
    q_sorted = query[q_order]

    valid_r = sorted_qids < n_qgrid
    sid_r = torch.where(valid_r,
                        (sorted_qids // qd[0]) * nseg_x
                        + (sorted_qids % qd[0]) // x_seg,
                        n_seg)
    change = sid_r[1:] != sid_r[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    head = valid_r & torch.cat([one, change])
    endf = valid_r & torch.cat([change, one])
    hrank = torch.cummax(torch.where(head, q_iota, -1), 0).values
    blocks = torch.where(endf, (q_iota - hrank) // q_cap + 1, 0)
    b_incl = torch.cumsum(blocks, 0)
    # entry id per rank: blocks of earlier segments plus the rank's
    # block within its own segment
    e_r = (b_incl - blocks) + (q_iota - hrank) // q_cap
    ehead = valid_r & (head | ((q_iota - hrank) % q_cap == 0))
    erank = torch.flip(torch.cummin(torch.flip(
        torch.where(endf, q_iota, _BIG), [0]), 0).values, [0])
    start = torch.sort(torch.where(ehead, e_r, _BIG), stable=True).indices
    sid_e = sid_r[start]
    seg_end = erank[start]
    if n_query < spec.e_cap:        # fewer ranks than entry slots
        pad = spec.e_cap - n_query
        start = torch.cat([start, start.new_zeros(pad)])
        sid_e = torch.cat([sid_e, sid_e.new_zeros(pad)])
        seg_end = torch.cat([seg_end, seg_end.new_full((pad,), -1)])
    else:
        start, sid_e, seg_end = (start[:spec.e_cap], sid_e[:spec.e_cap],
                                 seg_end[:spec.e_cap])
    n_live = b_incl[-1]
    entry = torch.arange(spec.e_cap, dtype=torch.int64, device=dev)
    live = entry < n_live
    seg = torch.clamp(sid_e, 0, n_seg - 1)
    count = torch.where(live, torch.clamp(seg_end - start + 1, 0, q_cap), 0)
    start = torch.where(live, start, 0)

    qcol = torch.arange(q_cap, dtype=torch.int64, device=dev)
    q_gather = torch.clamp(start[:, None] + qcol[None, :], 0, n_query - 1)
    q_t = _gather_q_t(q_sorted, q_gather)             # (E, 3, q_cap)

    # the entry's coarse-x range: tile ids of its first and last query
    first_tid = torch.clamp(
        sorted_qids[torch.clamp(start, 0, n_query - 1)], 0, n_qgrid - 1)
    last_tid = torch.clamp(
        sorted_qids[torch.clamp(start + count - 1, 0, n_query - 1)],
        0, n_qgrid - 1)
    tx_lo = first_tid % qd[0]
    tx_hi = last_tid % qd[0]
    rid = seg // nseg_x
    ty = rid % qd[1]
    tz = rid // qd[1]
    lo = torch.tensor(spec.lo, dtype=torch.float32, device=dev)
    coarse = spec.m * spec.tile_edge

    # entry center: midpoint of the coarse-x range; one center shared by
    # every band keeps cross-band arithmetic aligned
    half = scalar(0.5 * coarse, lo)
    centers = torch.stack([
        lo[0] + (tx_lo + tx_hi + 1).to(torch.float32) * half,
        lo[1] + (ty.to(torch.float32) + 0.5) * scalar(coarse, lo),
        lo[2] + (tz.to(torch.float32) + 0.5) * scalar(coarse, lo),
    ], dim=1)

    return {
        "q_t": q_t, "centers": centers, "count": count,
        "start": start, "entry": entry,
        "tx_lo": tx_lo, "tx_hi": tx_hi, "ty": ty, "tz": tz,
        "coarse_edge": float(spec.m) * float(spec.tile_edge),
        "x_seg_pack": x_seg,
        "sorted_qids": sorted_qids, "q_order": q_order, "q_iota": q_iota,
    }


def _search_tables(search, s_valid, spec, attrs=None, presorted=False):
    """Query-independent search tables of one band: tile-sorted rows
    plus a per-tile (start, count) table with one trailing empty row.
    ``attrs`` (n, A) ride the sort as payloads and come back as columns
    3..3+A of ``sorted_pts``.

    ``presorted``: the rows already arrive sorted by this spec's fine
    tile id with invalid rows last (``unique.unique_voxels`` with
    ``tile_spec``), so the sort is skipped; it takes no ``attrs``."""
    n_grid = spec.n_grid
    s_ids = torch.where(s_valid, _encode(search, spec, coarse=False),
                        n_grid)
    if presorted:
        if attrs is not None:
            raise ValueError("presorted search cannot carry attrs")
        sorted_pts = search
    else:
        rows = search if attrs is None else torch.cat([search, attrs], 1)
        sorted_pts = rows[torch.sort(s_ids, stable=True).indices]
    s_counts = torch.bincount(s_ids, minlength=n_grid + 1)
    s_starts = torch.cumsum(s_counts, 0) - s_counts
    s_starts[n_grid] = 0
    s_counts[n_grid] = 0
    return {"sorted_pts": sorted_pts,
            "sc_ext": torch.stack([s_starts, s_counts], dim=-1)}


def _shared_span_rows(plan, spec):
    """Per-span live-point cap of a band under a shared pack plan: the
    entry's coarse-x extent in band fine tiles plus the slop tiles,
    times the band's per-tile cap (5 slop tiles on the eps-widened
    float branch of :func:`_band_spans`, 2 on the integer one)."""
    ratio = plan["coarse_edge"] / float(spec.tile_edge)
    x_seg = plan["x_seg_pack"]
    slop = 2 if abs(ratio - round(ratio)) < 1e-9 else 5
    return int(np.ceil(x_seg * ratio) + slop) * spec.s_cap


def _band_spans(plan, search, s_valid, spec, attrs=None, presorted=False,
                tables=None):
    """Candidate x-row spans of one band's fine grid against a (possibly
    coarser-grained) shared entry packing: per entry, one contiguous
    span of the tile-sorted search rows for every (dy, dz) row of its
    candidate box.  Returns ``span_starts`` / ``span_lens``
    (E, n_rows^2), ``sorted_pts`` (with ``attrs`` as columns 3..3+A)
    and ``clipped``, the live rows past ``span_rows`` that the lengths
    drop (the reference clips them silently; the port counts them with
    the candidates past the capacity).

    ``tables``: this band's precomputed :func:`_search_tables` (a
    designated search map); ``search``, ``s_valid`` and ``attrs`` are
    then unused.  Like ``presorted`` a trust contract: the tables come
    from this band's spec."""
    n_grid = spec.n_grid
    dims = spec.dims
    count = plan["count"]
    tx_lo, tx_hi = plan["tx_lo"], plan["tx_hi"]
    ty, tz = plan["ty"], plan["tz"]
    if tables is None:
        tables = _search_tables(search, s_valid, spec, attrs=attrs,
                                presorted=presorted)

    ratio = plan["coarse_edge"] / float(spec.tile_edge)
    span_rows = _shared_span_rows(plan, spec)
    if abs(ratio - round(ratio)) < 1e-9:
        m = int(round(ratio))
        x0 = tx_lo * m - 1
        x1 = tx_hi * m + m
        row_lo_y, row_hi_y = ty * m - 1, ty * m + m
        row_lo_z, row_hi_z = tz * m - 1, tz * m + m
        n_rows = m + 2
    else:
        # eps-widened float branch (the reference's derivation: eps
        # covers the f32 product's rounding on every admissible grid)
        dev = count.device
        r32 = torch.tensor(np.float32(ratio), device=dev)
        slack = torch.tensor(np.float32(1 + 0.05), device=dev)

        def lo_of(t):
            return torch.floor(t.to(torch.float32) * r32
                               - slack).to(torch.int64)

        def hi_of(t):
            return (torch.ceil((t + 1).to(torch.float32) * r32 + slack)
                    - 1).to(torch.int64)

        x0, x1 = lo_of(tx_lo), hi_of(tx_hi)
        row_lo_y, row_hi_y = lo_of(ty), hi_of(ty)
        row_lo_z, row_hi_z = lo_of(tz), hi_of(tz)
        n_rows = int(np.ceil(ratio)) + 3

    x0 = torch.clamp(x0, min=0)
    x1 = torch.clamp(x1, max=dims[0] - 1)

    dyz = torch.arange(n_rows, dtype=torch.int64, device=count.device)
    y = row_lo_y[:, None, None] + dyz[None, :, None]      # (E, dy, dz)
    z = row_lo_z[:, None, None] + dyz[None, None, :]
    ok = ((y >= 0) & (y < dims[1]) & (y <= row_hi_y[:, None, None])
          & (z >= 0) & (z < dims[2]) & (z <= row_hi_z[:, None, None])
          & (count > 0)[:, None, None])
    row = y * dims[0] + z * (dims[0] * dims[1])
    e_rows = row.shape[0]
    first = torch.where(ok, x0[:, None, None] + row, n_grid)
    last = torch.where(ok, x1[:, None, None] + row, n_grid)
    sc_ext = tables["sc_ext"]
    g_first = sc_ext[torch.clamp(first.reshape(e_rows, -1), 0, n_grid)]
    g_last = sc_ext[torch.clamp(last.reshape(e_rows, -1), 0, n_grid)]
    begin = g_first[..., 0]
    end = g_last[..., 0] + g_last[..., 1]
    ok2 = ok.reshape(e_rows, -1)
    return {
        "span_starts": torch.where(ok2, begin, 0),
        "span_lens": torch.clamp(end - begin, 0, span_rows),
        "clipped": torch.clamp(end - begin - span_rows, min=0).sum(),
        "sorted_pts": tables["sorted_pts"],
        "span_rows": span_rows,
    }


def _span_problem(query, q_valid, search, s_valid, spec, attrs=None):
    """Single-band plan: the entry packing on the band's own grid plus
    its candidate spans (the search rows carrying ``attrs``), and the
    entry-local queries."""
    plan = _pack_plan(query, q_valid, spec)
    band = _band_spans(plan, search, s_valid, spec, attrs=attrs)
    q_pts = plan["q_t"].transpose(1, 2)               # (E, q_cap, 3)
    q_local = q_pts - plan["centers"][:, None, :]
    return {**plan, **band, "q_pts": q_pts, "q_local": q_local}


# -- back to caller order -----------------------------------------------------

def _rank_positions(prob, spec, n_query, sentinel):
    """Sorted rank -> flat (entry, slot) position.  Entries are
    consecutive rank blocks, so each rank's position is rank +
    (entry*q_cap - entry_start), propagated down the ranks by a scatter
    of the entry heads and a cummax.  Ranks without a live entry slot
    map to ``sentinel``."""
    count = prob["count"]
    start = prob["start"]
    base = prob["entry"] * spec.q_cap - start
    lowest = -(2**31) + 1
    live = count > 0
    arr = torch.full((n_query,), lowest, dtype=torch.int64,
                     device=count.device)
    arr.scatter_reduce_(
        0, torch.where(live, torch.clamp(start, 0, n_query - 1),
                       n_query - 1),
        torch.where(live, base, lowest), reduce="amax")
    pos_r = prob["q_iota"] + torch.cummax(arr, 0).values
    covered = count.sum()
    return torch.where(prob["q_iota"] < covered, pos_r, sentinel)


def _unsort_positions(prob, spec, n_query, sentinel):
    """Caller order -> flat (entry, slot) position."""
    pos_r = _rank_positions(prob, spec, n_query, sentinel)
    out = torch.full((n_query,), sentinel, dtype=torch.int64,
                     device=pos_r.device)
    out[prob["q_order"]] = pos_r
    return out


def _unsort_features(feats, prob, spec, n_query, n_out):
    """Feature rows back to caller order by one row gather; queries
    without an entry slot read the trailing zero row."""
    width = feats.shape[-1]
    flat = torch.cat([feats.reshape(-1, width),
                      feats.new_zeros((1, width))])
    pos = _unsort_positions(prob, spec, n_query, flat.shape[0] - 1)
    return flat[pos][:n_out]


def _rank_compact(red, plan, spec, zero_row, n_query):
    """Reduce outputs from (entry, slot) order to sorted-rank order with
    one stable key sort: slot (e, s) owns rank start_e + s when
    s < count_e, dead slots sort last.  Ranks past the covered prefix
    (queries without an entry slot) get the reduce's zero-feature row.

    ``red`` / ``zero_row``: tuples of (n_rows, ...) / (1, ...) tensors."""
    start, count = plan["start"], plan["count"]
    q_slots = spec.q_cap
    scol = torch.arange(q_slots, dtype=torch.int64, device=start.device)
    keys = torch.where(scol[None, :] < count[:, None],
                       start[:, None] + scol[None, :], _BIG).reshape(-1)
    order = torch.sort(keys, stable=True).indices[:n_query]
    live = (torch.arange(order.shape[0], device=start.device)
            < count.sum())
    out = []
    for leaf, z in zip(red, zero_row):
        ranked = leaf[order]
        mask = live.reshape((-1,) + (1,) * (leaf.dim() - 1))
        ranked = torch.where(mask, ranked, z[0])
        if ranked.shape[0] < n_query:       # trimmed e_cap below the
            fill = z[0].expand((n_query - ranked.shape[0],) + z.shape[1:])
            ranked = torch.cat([ranked, fill])   # query bucket
        out.append(ranked)
    return tuple(out)


# -- candidates and moments ---------------------------------------------------

def _pack_src(starts, lens, c_cap, n_search):
    """Packed-candidate source map for a slice of entries: (E', c_cap)
    gather indices into the FAR-extended sorted cloud, plus the
    truncation counter.

    Spans pack contiguously (offsets are the exclusive cumsum of the
    lengths), so live slot j belongs to the LAST span with
    offset <= j -- found by a batched binary search -- and maps to
    j + (start - offset) of that span.  Dead slots index the FAR row
    (``n_search``)."""
    off = torch.cumsum(lens, 1) - lens
    total = off[:, -1] + lens[:, -1]
    delta = starts - off
    j = torch.arange(c_cap, dtype=torch.int64, device=lens.device)
    j = j.expand(lens.shape[0], c_cap).contiguous()
    span = torch.searchsorted(off.contiguous(), j, right=True) - 1
    src = j + torch.gather(delta, 1, torch.clamp(span, min=0))
    src = torch.where(j < total[:, None], src, n_search)
    dropped = torch.clamp(total - c_cap, min=0).sum()
    return src, dropped


def _far_extended(sorted_pts):
    """Sorted cloud (3 + A columns) plus the FAR sentinel row dead slots
    gather."""
    return torch.cat([sorted_pts,
                      sorted_pts.new_full((1, sorted_pts.shape[1]), pm.FAR)])


def _bucket_problems(q_t, centers, starts, lens, sorted3, c_cap):
    """Kernel inputs per capacity bucket of one band (the candidate
    gather of the reference's ``_packed_slabs``).

    ``c_cap`` is one int, or a split ``(caps, bounds)`` from
    ``span_host.candidate_caps_split``: entries are stably sorted by
    descending candidate total and each rank bucket runs at its own
    capacity.  Returns ``(buckets, inv)``: a list of ``(q_t, cand_t,
    centers, dropped)`` and the permutation restoring entry order (None
    for one bucket)."""
    n_search = sorted3.shape[0] - 1
    cand_src = sorted3.T.contiguous()                 # (3 + A, n + 1)

    def one(q, c, st, ln, cap):
        src, dropped = _pack_src(st, ln, cap, n_search)
        cand = cand_src[:, src.reshape(-1)]
        if profiling.recording():
            profiling.count("lanes_live", pm.live_lanes(cand))
            profiling.count("lanes", cand.shape[1])
        return q.contiguous(), cand, c.contiguous(), dropped

    if not isinstance(c_cap, tuple):
        return [one(q_t, centers, starts, lens, int(c_cap))], None
    caps, bounds = c_cap
    order = torch.sort(-lens.sum(1), stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    n_e = order.shape[0]
    edges = (0,) + tuple(min(b, n_e) for b in bounds) + (n_e,)
    buckets = []
    for cap, a, b in zip(caps, edges[:-1], edges[1:]):
        if a >= b:
            continue
        idx = order[a:b]
        buckets.append(one(q_t[idx], centers[idx], starts[idx], lens[idx],
                           int(cap)))
    return buckets, inv


def _bucketed_slabs(q_t, centers, starts, lens, sorted3, c_cap, radii,
                    precision="highest", with_sazo=False, metric="euclidean",
                    exclude_radius=None):
    """Moment slabs for a slice of entries at one capacity or at split
    bucket capacities, in entry order (with the sazo rows for
    ``with_sazo``; ``sorted3`` columns past the coordinates are the
    attribute rows; pairs closer than ``exclude_radius`` left out).
    Returns ``(slabs, dropped)``."""
    buckets, inv = _bucket_problems(q_t, centers, starts, lens, sorted3,
                                    c_cap)
    n_attr = sorted3.shape[1] - 3
    slabs = [pm.packed_moments(q, cand_t, c, radii,
                               exclude_radius=exclude_radius,
                               precision=precision, with_sazo=with_sazo,
                               n_attr=n_attr, metric=metric)
             for q, cand_t, c, _ in buckets]
    dropped = sum(b[3] for b in buckets)
    if inv is None:
        return slabs[0], dropped
    return torch.cat(slabs)[inv], dropped


def _band_blocks(kind, q_t, centers, starts, lens, sorted3, c_cap, radii,
                 precision="highest", metric="euclidean",
                 exclude_radius=None):
    """Feature blocks of one band for a slice of entries; the sazo layout
    takes the kernel's sazo instance, the vector layout its attribute
    means (the columns of ``sorted3`` past the coordinates), one block
    of A columns a radius; ``exclude_radius`` the exclusion instances."""
    from nimrud_tpu_torch.features import layouts

    sazo = layouts.needs_sazo(kind)
    n_attr = sorted3.shape[1] - 3
    slabs, dropped = _bucketed_slabs(q_t, centers, starts, lens, sorted3,
                                     c_cap, radii, precision=precision,
                                     with_sazo=sazo, metric=metric,
                                     exclude_radius=exclude_radius)
    stats = moments_from_slabs(slabs, centers, radii, with_sazo=sazo,
                               n_attr=n_attr)
    if kind == "vector":
        return [p["attr_mean"] for p in stats], dropped
    q_pts = q_t.transpose(1, 2)
    blocks = [layouts.build_block(kind, p["count"], p["mean"], p["cov"],
                                  q_pts, radius, sazo=p.get("sazo"))
              for p, radius in zip(stats, radii)]
    return blocks, dropped


def fused_extract_spans(query, q_valid, search, s_valid, spec, radii,
                        kind, n_out, with_stats=False, precision="highest",
                        exclude_radius=None):
    """
    Padded clouds -> (n_out, width) features of one band through the
    span kernel ``span_moments``, in caller order: the kernel reads each
    entry's candidate x-row spans straight out of the tile-sorted search
    rows (no candidate block is packed).  Every live row of a span
    counts, so no candidate is dropped; ``with_stats`` gives
    ``dropped_query`` (queries without an entry slot).  The span kernel
    has neither a sazo fold nor attribute rows: ``kind="sazo"`` and
    ``"vector"`` raise (the extraction and the serving loop route those
    bands to :func:`fused_extract`, as the reference's do).
    ``precision``: "highest" or "bf16x2".  ``exclude_radius``
    leaves out the pairs with ``d2 < f32(e*e)`` (the kernel's exclusion
    instance).
    """
    from nimrud_tpu_torch.features import layouts

    if layouts.needs_sazo(kind) or kind == "vector":
        raise ValueError(
            f"kind={kind!r}: the span kernel has no sazo fold and no "
            "attribute rows; such bands take the XLA path (fused_extract)")
    prob = _span_problem(query, q_valid, search, s_valid, spec)
    slabs = gk.span_moments(*span_args(prob), radii, prob["span_rows"],
                            exclude_radius=exclude_radius,
                            precision=precision)
    out = span_features(slabs, prob, spec, radii, kind, query.shape[0],
                        n_out)
    if not with_stats:
        return out
    return out, {"dropped_query": q_valid.sum() - prob["count"].sum()}


def span_args(prob):
    """The ``span_moments`` tensor arguments of a span problem
    (:func:`_span_problem`): q_local, centers, span_starts, span_lens,
    sorted_pts, contiguous, the span tables int32."""
    return (prob["q_local"].contiguous(), prob["centers"].contiguous(),
            prob["span_starts"].to(torch.int32).contiguous(),
            prob["span_lens"].to(torch.int32).contiguous(),
            prob["sorted_pts"].contiguous())


def span_features(slabs, prob, spec, radii, kind, n_query, n_out):
    """A span problem's moment slabs -> (n_out, width) ``kind`` features
    in caller order."""
    from nimrud_tpu_torch.features import layouts

    blocks = [layouts.build_block(kind, p["count"], p["mean"], p["cov"],
                                  prob["q_pts"], radius)
              for p, radius in zip(
                  moments_from_slabs(slabs, prob["centers"], radii), radii)]
    return _unsort_features(torch.cat(blocks, dim=-1), prob, spec, n_query,
                            n_out)


def _max_candidates(query, q_valid, search, s_valid, spec):
    """The largest per-entry candidate count of the band's plan (the sum
    of an entry's span lengths), a device scalar."""
    prob = _span_problem(query, q_valid, search, s_valid, spec)
    return prob["span_lens"].sum(1).max()


def packed_cap(query, q_valid, search, s_valid, spec, margin=1.25):
    """Measured per-entry candidate maximum for this (cloud, spec),
    with headroom, rounded up to a 128-lane multiple -- the ``c_cap``
    at which :func:`fused_extract_packed` is exact on this cloud and
    robust to moderate densification at serving time."""
    m = int(_max_candidates(query, q_valid, search, s_valid, spec))
    need = max(int(m * margin), 1)
    return max(-(-need // 128) * 128, 128)


def fused_extract_packed(query, q_valid, search, s_valid, spec, radii,
                         kind, n_out, c_cap, with_stats=False,
                         precision="highest", attributes=None,
                         metric="euclidean", exclude_radius=None):
    """
    Padded clouds -> (n_out, width) features of one band through the
    packed-candidate ``packed_moments`` kernel, in caller order.

    ``c_cap`` bounds candidates per entry: one int (multiple of 128) or
    a split ``(caps, bounds)``.  Candidates beyond it are truncated and
    counted in the ``dropped_candidates`` stat, with the live rows a span
    clips at its ``span_rows`` bound.  ``attributes`` (rows
    aligned with ``search``, at most 6 columns) ride the plan into the
    kernel's attribute rows; ``kind="vector"`` then gives their masked
    means, A columns a radius.  ``metric="chebyshev"`` masks on the
    max-norm ball (the packed attribute interp).  ``precision``:
    "highest" or "bf16x2".  ``exclude_radius`` leaves out the pairs with
    ``d2 < f32(e*e)`` (the kernel's exclusion instances; euclidean only).

    Inside an open span of ``utils.profiling`` it counts ``slots_live``
    / ``slots`` (the plan's placed rows over its entry slots) and
    ``lanes_live`` / ``lanes``, as :func:`fused_extract_packed_multi`.
    """
    if kind == "vector" and attributes is None:
        raise ValueError("kind='vector' requires attributes")
    prob = _span_problem(query, q_valid, search, s_valid, spec,
                         attrs=attributes)
    if profiling.recording():
        profiling.count("slots_live", prob["count"].sum())
        profiling.count("slots", spec.e_cap * spec.q_cap)
    blocks, dropped = _band_blocks(
        kind, prob["q_t"], prob["centers"], prob["span_starts"],
        prob["span_lens"], _far_extended(prob["sorted_pts"]), c_cap, radii,
        precision=precision, metric=metric, exclude_radius=exclude_radius)
    feats = torch.cat(blocks, dim=-1)
    out = _unsort_features(feats, prob, spec, query.shape[0], n_out)
    if not with_stats:
        return out
    stats = {"dropped_query": q_valid.sum() - prob["count"].sum(),
             "dropped_candidates": dropped + prob["clipped"]}
    return out, stats


def fused_extract_packed_multi(query, q_valid, searches, s_valids,
                               pack_spec, band_specs, radii_bands, kind,
                               c_caps, reduce_fn=None, with_stats=False,
                               presorted=False, precision="highest",
                               attributes=None, search_tables=None,
                               order="rank", n_out=None, entry_chunk=None):
    """
    All bands of a scaleset over ONE shared query plan: ``_pack_plan``
    runs once on ``pack_spec`` (the finest band's grid), every band
    derives its spans against the shared entries, the kernel runs per
    band and capacity bucket, and ``reduce_fn`` (feature rows -> tuple
    of per-row tensors, e.g. the classifier) runs on the concatenated
    features of all bands.

    ``order`` (the reference's):

    * ``"rank"`` with a ``reduce_fn``: ``(out_rank, q_order)``, the
      reduce outputs in sorted-rank order (ranks without an entry slot
      get the reduce of a zero-feature row) and the plan's sort
      permutation; ``out[q_order] = out_rank`` restores caller order.
      Without a ``reduce_fn``: ``(feats_flat, pos_r, q_order)``, the
      features in (entry, slot) order and each rank's flat position
      (the row count where a rank has no slot).
    * ``"plan"``: ``(out_flat, pos)``, the features in (entry, slot)
      order (or, with a ``reduce_fn``, its outputs with one trailing
      zero-feature row each) and each caller row's flat position, the
      sentinel being the row count; ``n_out`` rows of it.
    * ``"caller"``: the ``(n_out, width)`` features in caller order
      (``reduce_fn`` unused).

    ``entry_chunk`` (with a ``reduce_fn``, order "plan" or "rank"): the
    per-entry pipeline (candidate pack, kernel, layout, reduce) runs on
    entries ``[k * entry_chunk, (k + 1) * entry_chunk)`` in turn, the
    last chunk ragged, so its buffers are bounded by the chunk; each
    chunk splits its capacity buckets within itself (``c_caps`` from
    ``span_host.candidate_caps_split(entry_chunk=)``).  The reduced rows
    concatenate to the un-chunked rows.

    ``presorted=True`` is a trust contract: each band's search rows come
    from ``unique.unique_voxels(..., tile_spec=band_specs[i])``.  It
    applies to the bands without ``attributes`` (one (n, A) tensor or
    None a band, rows aligned with that band's search rows): those are
    sorted with their payloads, as in the reference.  ``kind="vector"``
    gives each band's attribute means, A columns a radius.
    ``precision``: "highest" or "bf16x2".

    ``search_tables`` (one :func:`_search_tables` a band, from a
    designated search map) replace each band's search rows:
    ``searches``, ``s_valids`` and ``attributes`` are then ignored, and
    a table's columns past the coordinates are its attributes.

    ``with_stats`` adds ``dropped_query`` and ``dropped_candidates``
    (the candidates past a capacity, summed over chunks and buckets, and
    each band's clipped span rows, counted once).

    Inside an open span of ``utils.profiling`` it records the child
    spans ``.plan``, ``.spans`` (a band), ``.moments`` (a band and
    chunk), ``.classify`` (a chunk) and ``.scatter``, named under the
    open span (the serving step's: ``nimrud.predict.plan``, ...), and the
    counters ``slots_live`` / ``slots`` (the plan's placed rows over the
    entry slots a chunk) and ``lanes_live`` / ``lanes`` (the packed
    blocks' live lanes over their lanes).
    """
    if order not in ("caller", "plan", "rank"):
        raise ValueError(f"unknown order {order!r}")
    n_query = query.shape[0]
    n_out = n_query if n_out is None else n_out
    with profiling.span(".plan"):
        plan = _pack_plan(query, q_valid, pack_spec)
    n_bands = len(band_specs)
    attributes = attributes or (None,) * n_bands
    search_tables = search_tables or (None,) * n_bands
    if search_tables[0] is not None:
        searches = s_valids = attributes = (None,) * n_bands
        n_attrs = [t["sorted_pts"].shape[1] - 3 for t in search_tables]
    else:
        n_attrs = [0 if a is None else a.shape[1] for a in attributes]
    if kind == "vector" and min(n_attrs) == 0:
        raise ValueError("kind='vector' requires attributes in every band")
    dropped = query.new_zeros((), dtype=torch.int64)
    bands = []
    for search, s_valid, spec, radii, c_cap, attrs, tables in zip(
            searches, s_valids, band_specs, radii_bands, c_caps,
            attributes, search_tables):
        with profiling.span(".spans"):
            band = _band_spans(plan, search, s_valid, spec, attrs=attrs,
                               presorted=presorted and attrs is None,
                               tables=tables)
        dropped = dropped + band["clipped"]
        bands.append((band["span_starts"], band["span_lens"],
                      _far_extended(band["sorted_pts"]), c_cap, radii))

    def features(lo, hi):
        """Feature rows of entries [lo, hi) of every band, (hi - lo,
        q_cap, width), and the candidates they dropped."""
        if profiling.recording():
            profiling.count("slots_live", plan["count"][lo:hi].sum())
            profiling.count("slots", (hi - lo) * pack_spec.q_cap)
        blocks, drop = [], 0
        for starts, lens, sorted3, c_cap, radii in bands:
            with profiling.span(".moments"):
                bl, dr = _band_blocks(kind, plan["q_t"][lo:hi],
                                      plan["centers"][lo:hi], starts[lo:hi],
                                      lens[lo:hi], sorted3, c_cap, radii,
                                      precision=precision)
            blocks.extend(bl)
            drop = drop + dr
        return torch.cat(blocks, dim=-1), drop

    e_cap = pack_spec.e_cap
    reduced = reduce_fn is not None and order != "caller"
    if reduced and entry_chunk is not None and e_cap > entry_chunk:
        parts = []
        for lo in range(0, e_cap, entry_chunk):
            feats, dr = features(lo, min(lo + entry_chunk, e_cap))
            width = feats.shape[-1]
            with profiling.span(".classify"):
                parts.append(reduce_fn(feats.reshape(-1, width)))
            dropped = dropped + dr
            del feats
        red = tuple(torch.cat(leaf) for leaf in zip(*parts))
    else:
        feats, dr = features(0, e_cap)
        dropped = dropped + dr
        width = feats.shape[-1]
        flat = feats.reshape(-1, width)
        red = None
        if reduced:
            with profiling.span(".classify"):
                red = reduce_fn(flat)
    n_rows = e_cap * pack_spec.q_cap
    if red is not None:
        with profiling.span(".scatter"):
            zero_row = reduce_fn(query.new_zeros((1, width)))
            if order == "rank":
                out = (_rank_compact(red, plan, pack_spec, zero_row,
                                     n_query), plan["q_order"])
            else:
                out = (tuple(torch.cat([leaf, z])
                             for leaf, z in zip(red, zero_row)),
                       _unsort_positions(plan, pack_spec, n_query,
                                         n_rows)[:n_out])
    elif order == "rank":
        out = (flat, _rank_positions(plan, pack_spec, n_query, n_rows),
               plan["q_order"])
    elif order == "plan":
        out = (flat, _unsort_positions(plan, pack_spec, n_query,
                                       n_rows)[:n_out])
    else:
        out = _unsort_features(feats, plan, pack_spec, n_query, n_out)
    if not with_stats:
        return out
    stats = {"dropped_query": q_valid.sum() - plan["count"].sum(),
             "dropped_candidates": dropped}
    return out, stats


def fused_extract(query, q_valid, search, s_valid, spec, radii, kind,
                  exclude_radius, precision_name, n_out, with_stats=False,
                  attributes=None, metric="euclidean"):
    """
    Padded clouds -> (n_out, width) features in caller order through the
    XLA candidate-table path: :func:`build_tables` on the device, then
    ``grid.tiled_batch_features`` (the masked moment products of
    ``grid._entry_stats``, ``spec.entry_batch`` entries at a time), the
    layout and the scatter.  No moment kernel runs.  ``with_stats``
    also returns :func:`build_tables`' counters (``dropped_search``,
    ``dropped_query``).  ``attributes`` (rows aligned with ``search``)
    give ``kind="vector"`` its masked attribute means;
    ``metric="chebyshev"`` makes it the voxel interpolation operator
    (``ops.interp.matmul_interp``).  ``precision_name``: the reference's
    names (``grid.PRECISIONS``), all f32 sums here.
    """
    from nimrud_tpu_torch.ops import grid

    grid._check_precision(precision_name)
    if kind == "vector" and attributes is None:
        raise ValueError("kind='vector' requires attributes")
    built = build_tables(query, q_valid, search, s_valid, spec,
                         with_stats=with_stats)
    query_index, neighbor_rows, candidates, centers = built[:4]
    zero = query.new_zeros((1, 3))
    attr_pad = None if attributes is None else torch.cat(
        [attributes, attributes.new_zeros((1, attributes.shape[1]))])
    feats = grid.tiled_batch_features(
        torch.cat([query[:, :3], zero]), torch.cat([search[:, :3], zero]),
        attr_pad, (query_index, neighbor_rows, centers), candidates,
        tuple(float(r) for r in radii), kind, exclude_radius,
        spec.entry_batch, n_out, metric=metric)
    return (feats, built[4]) if with_stats else feats
