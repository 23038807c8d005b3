"""
Host-side (pure NumPy) mirror of the span plan that
``device_grid._span_problem`` builds on device.

Copy of ``nimrud_tpu/ops/span_host.py``, kept here so the port imports
no module of the JAX package (whose ``ops`` package imports jax).  The
arithmetic is unchanged; the parity tests hold the two equal.

Two jobs:

* capacity sizing without device round-trips: the packed-candidate
  serving path needs a static per-entry candidate capacity (``c_cap``)
  at program-build time.  Reading it back from the device would cost a
  device-to-host transfer per sizing, so production sizing runs here,
  on the host copy of the cloud that staging already holds.

* plan diagnostics: the original serves scripts/span_stats.py, which
  reports span-slot statistics from the same code.

The arithmetic mirrors device_grid._span_problem / _encode step for
step in float32 so tile assignment matches the device plan bit for
bit; capacities derived here still carry a margin and are backed by
the always-on ``dropped_candidates`` overflow counter.
"""

import numpy as np


def encode_np(points, spec, coarse):
    """Numpy mirror of device_grid._encode: linear tile ids (clipped)."""
    pts = np.asarray(points, np.float32)
    lo = np.asarray(spec.lo, np.float32)
    cell = np.floor((pts - lo) / np.float32(spec.tile_edge)).astype(np.int64)
    dims = np.asarray(spec.dims)
    cell = np.clip(cell, 0, dims - 1)
    if coarse:
        cell = cell // spec.m
        d = spec.qdims
    else:
        d = spec.dims
    return cell[:, 0] + cell[:, 1] * d[0] + cell[:, 2] * d[0] * d[1]


def pack_plan_np(query, q_valid, spec):
    """Numpy mirror of device_grid._pack_plan: shared query-side entry
    packing on ``spec``'s coarse segment grid."""
    n_qgrid = spec.n_qgrid
    n_query = query.shape[0]
    qd = spec.qdims

    x_seg = max(min(spec.x_seg, qd[0]), 1)
    nseg_x, n_seg = spec.seg_shape
    q_ids = np.where(np.asarray(q_valid),
                     encode_np(query, spec, coarse=True), n_qgrid)
    sid = np.where(np.asarray(q_valid),
                   (q_ids // qd[0]) * nseg_x + (q_ids % qd[0]) // x_seg,
                   n_seg)
    order = np.argsort(q_ids, kind="stable")
    sorted_qids = q_ids[order]
    seg_counts = np.zeros(n_seg + 1, np.int64)
    np.add.at(seg_counts, sid, 1)
    seg_counts = seg_counts[:n_seg]
    seg_starts = np.concatenate([[0], np.cumsum(seg_counts)[:-1]])
    per_seg = -(-seg_counts // spec.q_cap)
    offsets = np.concatenate([[0], np.cumsum(per_seg)])
    entry = np.arange(spec.e_cap)
    seg = np.clip(np.searchsorted(offsets[1:], entry, side="right"),
                  0, n_seg - 1)
    rank = entry - offsets[seg]
    live_e = entry < offsets[n_seg]
    count = np.clip(seg_counts[seg] - rank * spec.q_cap, 0, spec.q_cap)
    count = np.where(live_e, count, 0)
    start = seg_starts[seg] + rank * spec.q_cap

    first_tid = np.clip(sorted_qids[np.clip(start, 0, n_query - 1)],
                        0, n_qgrid - 1)
    last_tid = np.clip(
        sorted_qids[np.clip(start + count - 1, 0, n_query - 1)],
        0, n_qgrid - 1)
    return {
        "tx_lo": first_tid % qd[0], "tx_hi": last_tid % qd[0],
        "ty": (seg // nseg_x) % qd[1], "tz": (seg // nseg_x) // qd[1],
        "count": count, "live_e": live_e,
        "coarse_edge": float(spec.m) * float(spec.tile_edge),
        "x_seg_pack": x_seg,
    }


def band_span_lens(plan, search, s_valid, spec):
    """Numpy mirror of device_grid._band_spans (lengths only): one
    band's candidate x-row span lengths against a shared pack plan."""
    n_grid = spec.n_grid
    dims = spec.dims
    count = plan["count"]
    tx_lo, tx_hi = plan["tx_lo"], plan["tx_hi"]
    ty, tz = plan["ty"], plan["tz"]

    s_ids = np.where(np.asarray(s_valid),
                     encode_np(search, spec, coarse=False), n_grid)
    s_counts = np.zeros(n_grid + 1, np.int64)
    np.add.at(s_counts, s_ids, 1)
    s_counts = s_counts[:n_grid]
    s_starts = np.concatenate([[0], np.cumsum(s_counts)[:-1]])
    starts_ext = np.concatenate([s_starts, [0]])
    counts_ext = np.concatenate([s_counts, [0]])

    ratio = plan["coarse_edge"] / float(spec.tile_edge)
    # MUST mirror device_grid._shared_span_rows (the eps-widened float
    # branch below reaches ceil(x_seg*ratio)+5 fine tiles)
    slop = 2 if abs(ratio - round(ratio)) < 1e-9 else 5
    span_rows = int(np.ceil(plan["x_seg_pack"] * ratio) + slop) \
        * spec.s_cap
    if abs(ratio - round(ratio)) < 1e-9:
        m = int(round(ratio))
        x0 = tx_lo * m - 1
        x1 = tx_hi * m + m
        row_lo_y, row_hi_y = ty * m - 1, ty * m + m
        row_lo_z, row_hi_z = tz * m - 1, tz * m + m
        n_rows = m + 2
    else:
        # MUST mirror device_grid._band_spans: eps=0.05 covers the f32
        # product's rounding error on every grid the 30-bit key budget
        # admits (see the derivation there)
        eps = 0.05
        r32 = np.float32(ratio)

        def lo_of(t):
            return np.floor(t.astype(np.float32) * r32
                            - (1 + eps)).astype(np.int64)

        def hi_of(t):
            return (np.ceil((t + 1).astype(np.float32) * r32
                            + (1 + eps)) - 1).astype(np.int64)

        x0, x1 = lo_of(tx_lo), hi_of(tx_hi)
        row_lo_y, row_hi_y = lo_of(ty), hi_of(ty)
        row_lo_z, row_hi_z = lo_of(tz), hi_of(tz)
        n_rows = int(np.ceil(ratio)) + 3

    x0 = np.maximum(x0, 0)
    x1 = np.minimum(x1, dims[0] - 1)

    lens = []
    for dy in range(n_rows):
        for dz in range(n_rows):
            y = row_lo_y + dy
            z = row_lo_z + dz
            ok = ((y >= 0) & (y < dims[1]) & (y <= row_hi_y)
                  & (z >= 0) & (z < dims[2]) & (z <= row_hi_z)
                  & (count > 0))
            row = y * dims[0] + z * dims[0] * dims[1]
            first = np.where(ok, x0 + row, n_grid)
            last = np.where(ok, x1 + row, n_grid)
            begin = starts_ext[first]
            end = starts_ext[last] + counts_ext[last]
            lens.append(np.where(ok, np.clip(end - begin, 0,
                                             span_rows), 0))
    return np.stack(lens, axis=1)


def span_plan(query, q_valid, search, s_valid, spec):
    """Per-entry candidate x-row span lengths (e_cap, n_span) plus the
    live-entry mask, mirroring device_grid._span_problem."""
    plan = pack_plan_np(query, q_valid, spec)
    lens = band_span_lens(plan, search, s_valid, spec)
    return lens, plan["live_e"], plan["count"]


def candidate_cap(query, search, spec, s_valid=None, margin=1.25,
                  pack_spec=None, segment_wide=False, plan=None):
    """Static per-entry candidate capacity for
    device_grid.fused_extract_packed / _multi: the measured per-entry
    maximum with headroom, rounded up to 128 lanes.  ``search`` is the
    (host) voxel-downsampled search set the band will run against;
    ``pack_spec`` (default: the band's own spec) is the shared query
    packing grid of the multi-band path.

    ``segment_wide`` widens every entry's coarse-x range to its WHOLE
    segment before measuring.  An entry's candidate set is always a
    subset of its segment's full x-range rows, so this bounds ANY
    query packing -- the multichip path uses it because each shard
    packs its own (sub)set of the queries into entries the host mirror
    cannot reproduce exactly.

    ``plan`` short-circuits the query-side mirror: the multi-band path
    shares ONE pack grid, and re-deriving its plan per band costs a
    full argsort of the cloud each time (minutes of host time at 10M
    points on a 1-core box)."""
    search = np.asarray(search, np.float32)
    if s_valid is None:
        s_valid = np.ones(search.shape[0], bool)
    pk = pack_spec if pack_spec is not None else spec
    if plan is None:
        q = np.asarray(query, np.float32)
        plan = pack_plan_np(q, np.ones(q.shape[0], bool), pk)
    if segment_wide:
        qd = pk.qdims
        x_seg = plan["x_seg_pack"]
        nseg_x, _ = pk.seg_shape
        # reconstruct each entry's segment x-extent from its own range
        # (tx // x_seg identifies the segment column)
        seg_x = plan["tx_lo"] // x_seg
        plan = dict(plan)
        plan["tx_lo"] = seg_x * x_seg
        plan["tx_hi"] = np.minimum(seg_x * x_seg + x_seg - 1, qd[0] - 1)
    lens = band_span_lens(plan, search, s_valid, spec)
    peak = int(lens.sum(axis=1).max()) if lens.size else 0
    cap = max(int(peak * margin), 1)
    return max(-(-cap // 128) * 128, 128)


def _round_cap(cap):
    return max(-(-int(cap) // 128) * 128, 128)


def candidate_caps_split(query, search, spec, s_valid=None, margin=1.25,
                         pack_spec=None, entry_chunk=None, plan=None,
                         max_buckets=4):
    """Multi-bucket static candidate capacities for
    device_grid.fused_extract_packed_multi: ``(caps, bounds)`` --
    ``caps`` a descending tuple of per-bucket capacities and ``bounds``
    the interior cut ranks, so bucket ``j`` runs the entries at
    descending-total ranks ``[(0,)+bounds][j] .. [bounds+(e,)][j]`` at
    ``caps[j]`` -- or a single int cap when splitting is not worth it.

    Per-entry candidate totals of real clouds are far from uniform --
    sometimes a thin heavy tail (a dense cluster in a sparse site),
    sometimes a fat two-regime body (the 1M bench's canopy entries sit
    at ~450-550 candidates against a 726 max).  One shared cap sized
    for the max leaves the packing gather and the kernel mostly dead,
    so serving argsorts entries by measured total per band and runs
    each descending-rank bucket at its own capacity.  Cuts are CHOSEN
    PER BAND by sweeping power-of-two rank positions and minimizing
    total gather lanes on the host mirror of the device plan (per
    entry chunk when ``entry_chunk`` is set -- the chunked path
    re-splits within each chunk, so every cap must cover the worst
    chunk's rank); the first split must save >=25% of the single-cap
    lanes to pay for its second gather+kernel launch, and each further
    bucket must save >=10% more (the 1M bench: 2 buckets 3.03M lanes,
    4 buckets 2.25M -- v5e gathers and kernel lanes scale ~1:1 with
    the total).  Denser serving clouds overflow into the counted
    dropped_candidates diagnostic, same contract as the single cap."""
    import itertools

    search = np.asarray(search, np.float32)
    if s_valid is None:
        s_valid = np.ones(search.shape[0], bool)
    if plan is None:
        q = np.asarray(query, np.float32)
        pk = pack_spec if pack_spec is not None else spec
        plan = pack_plan_np(q, np.ones(q.shape[0], bool), pk)
    lens = band_span_lens(plan, search, s_valid, spec)
    totals = lens.sum(axis=1)
    e_cap = totals.shape[0]
    chunk = e_cap if entry_chunk is None else int(entry_chunk)
    c_hi = _round_cap(max(int(totals.max()) * margin, 1))

    # descending totals per chunk; ragged last chunk kept as-is
    parts = [np.sort(totals[s:s + chunk])[::-1]
             for s in range(0, e_cap, chunk)]

    def rank_cap(r):
        """Capacity covering every chunk's total at descending rank r."""
        if r == 0:
            return c_hi
        need = max((int(p[r]) for p in parts if len(p) > r), default=0)
        return _round_cap(max(need * margin, 1))

    def lanes_of(bounds):
        edges = (0,) + bounds + (chunk,)
        caps = tuple(rank_cap(a) for a in edges[:-1])
        total = 0
        for cap, a, b in zip(caps, edges[:-1], edges[1:]):
            n = sum(min(b, len(p)) - min(a, len(p)) for p in parts)
            total += n * cap
        return total, caps

    cand = []
    k = 8
    while k < chunk:
        cand.append(k)
        k *= 2
    single_lanes = e_cap * c_hi
    best = {1: (single_lanes, (), (c_hi,))}
    for n_cuts in range(1, max_buckets):
        opt = None
        for cuts in itertools.combinations(cand, n_cuts):
            lanes, caps = lanes_of(cuts)
            if opt is None or lanes < opt[0]:
                opt = (lanes, cuts, caps)
        if opt is None:
            break
        best[n_cuts + 1] = opt

    # gain gates: 25% for the first split, 10% per further bucket
    pick = 1
    if 2 in best and best[2][0] <= 0.75 * single_lanes:
        pick = 2
        for k_b in range(3, max_buckets + 1):
            if k_b in best and best[k_b][0] <= 0.90 * best[pick][0]:
                pick = k_b
    if pick == 1:
        return c_hi
    _, cuts, caps = best[pick]
    return (tuple(int(c) for c in caps), tuple(int(c) for c in cuts))
