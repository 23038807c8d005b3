"""
Explicit neighbor retrieval: fixed-K radius neighbor lists and k-nearest
neighbors (port of ``nimrud_tpu/ops/neighbors.py``).

Both run on the tiled problem of ``ops.grid.build_tiled_problem`` (tile
edge = the radius or the search horizon, query tiles two search tiles
across, entries padded to batches of 256), one entry batch at a time on
the device:

* ``d2`` is the expanded form ``max((qq + ss) - 2 qs, 0)`` of the
  entry-local coordinates, formed elementwise (no matmul) in the entry
  kernel's fixed order, but with the products accumulated as fused
  multiply-adds: ``qq = fma(q2, q2, fma(q1, q1, q0*q0))``, ``ss`` and
  ``qs = fma(q2, s2, fma(q1, s1, q0*s0))`` alike.  That is what the
  reference's ``jnp.sum(q*q)`` and ``einsum`` compute under XLA on a CPU
  with FMA (its parity tests' platform), and one rounding an FMA is
  exact and portable: :func:`fma` forms it in float64 bit for bit on
  the CPU and the card.  The clamp propagates a NaN, as
  ``jnp.maximum`` does;
* a radius query keeps the candidates with ``d2 <= f32(r*r)`` (the
  product in float64, ``multiscale_kernel.squared_radii``); a kNN query
  keeps every valid candidate of the entry's tiles, so the horizon
  comes from the tiling, not from a mask, as in the reference;
* selection follows ``lax.top_k``'s order exactly: ascending ``d2``,
  then ascending candidate position along the entry's flattened
  candidate axis.  ``torch.topk`` promises no order among ties, so it
  runs on a unique int64 key, the f32 bits of the masked ``d2`` (monotone
  as integers for ``d2 >= 0``) above the position;
* distances are the correctly rounded float32 root of ``d2`` (taken in
  float64), the same on the CPU and the card;
* the rows go back to caller order through a sentinel row ``n_query``
  that the padded query slots (-1) write.

Memory: the reference's (256, Q, S) transients hold every candidate
lane of an entry's (m + 2)^3 tiles, mostly empty (1.6% valid on the 1M
bench at 0.5 m).  Here each entry's valid candidates are first moved to
the front in their order (a stable sort of the validity), which keeps
their relative positions and so the tie order, and an entry batch runs
in sub-batches of at most ``PAIR_BUDGET`` (query slot, candidate)
pairs.  Entry batches are not a contract.
"""

import numpy as np
import torch

from nimrud_tpu_torch.ops import grid
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk

ENTRY_BATCH = 256
PAIR_BUDGET = 1 << 26       # (query slot, candidate) pairs a sub-batch forms
_POSITION_BITS = 32


def _compact(c_idx, width):
    """Each row's valid candidates (>= 0) first, in their order, then -1
    pads, ``width`` columns."""
    if c_idx.shape[1] < width:
        c_idx = torch.cat([c_idx, c_idx.new_full(
            (c_idx.shape[0], width - c_idx.shape[1]), -1)], dim=1)
    order = torch.sort((c_idx < 0).to(torch.int8), dim=1,
                       stable=True).indices[:, :width]
    return torch.gather(c_idx, 1, order)


def fma(a, b, c):
    """``a * b + c`` of float32 tensors rounded once to float32, as a
    fused multiply-add: the product is exact in float64, TwoSum recovers
    the error of its sum with ``c``, and folding that error into the last
    bit (round to odd) makes the float32 rounding of the float64 sum the
    single rounding of the exact value."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)


def _dot3(a, b):
    """``fma(a2, b2, fma(a1, b1, a0*b0))`` over the last axis."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1],
                                         a[..., 0] * b[..., 0]))


def _expanded_d2(q_local, s_local):
    """``max((qq + ss) - 2 qs, 0)`` of (B, Q, 3) queries and (B, W, 3)
    candidates, (B, Q, W), the products fused as the reference's."""
    qs = _dot3(q_local[:, :, None, :], s_local[:, None, :, :])
    qq, ss = _dot3(q_local, q_local), _dot3(s_local, s_local)
    return torch.clamp((qq[:, :, None] + ss[:, None, :]) - 2.0 * qs,
                       min=0.0)


def _select(masked, k):
    """The ``k`` smallest of ``masked`` (B, Q, W) in ``lax.top_k(-x)``'s
    order: ascending value, ties by ascending position.  Returns (values,
    positions)."""
    width = masked.shape[-1]
    bits = masked.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << _POSITION_BITS) | torch.arange(
        width, dtype=torch.int64, device=masked.device)
    sel = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    values = (sel >> _POSITION_BITS).to(torch.int32).view(torch.float32)
    return values, sel & ((1 << _POSITION_BITS) - 1)


def _sub_batch(query_pad, search_pad, q_idx, c_idx, centers, k, r2):
    """One sub-batch: (idx, dist, found, count) of its query slots."""
    n_query = query_pad.shape[0] - 1
    n_search = search_pad.shape[0] - 1
    q_local = query_pad[torch.where(q_idx < 0, n_query, q_idx)] \
        - centers[:, None, :]
    s_valid = c_idx >= 0
    safe = torch.where(s_valid, c_idx, n_search)
    s_local = search_pad[safe] - centers[:, None, :]
    d2 = _expanded_d2(q_local, s_local)
    in_range = s_valid[:, None, :]
    if r2 is not None:
        in_range = in_range & (d2 <= r2)
    in_range = in_range.expand(d2.shape)
    # a NaN d2 (a NaN coordinate) is never found: it keys as inf, as
    # lax.top_k ranks it below every invalid lane
    masked = torch.where(in_range & ~torch.isnan(d2), d2,
                         torch.full_like(d2, float("inf")))
    del d2
    dist2, pos = _select(masked, k)
    found = torch.isfinite(dist2)
    flat_pos = torch.gather(safe[:, None, :].expand(masked.shape), 2, pos)
    idx = torch.where(found, flat_pos, -1)
    # the float64 root rounded to float32 is the correctly rounded f32
    # root on every device (an H100's f32 sqrt differed from the CPU's
    # by an ulp on 0.6% of the kNN distances of a 20k-point cloud)
    dist = torch.sqrt(dist2.to(torch.float64)).to(torch.float32)
    return idx, dist, found, in_range.sum(2)


def neighbor_search(query, search, k, radius, mode, device="cuda"):
    """
    The search of :func:`radius_neighbors` (``mode="radius"``) and
    :func:`knn` (``mode="knn"``, ``radius`` the horizon) on ``device``
    (the card unless the caller asks for the CPU).  Returns a dict of
    device tensors in caller order -- ``indices`` (N, k) int32 (-1 pad),
    ``distances`` (N, k) f32 (inf pad), ``valid`` (N, k) bool, ``count``
    (N,) int32 (the in-range candidates; in ``knn`` mode every valid
    candidate of the entry's tiles) -- and ``stats``: the tiled
    problem's entries, entry batches, sub-batches, the widest compacted
    candidate axis and the pairs formed.
    """
    if mode not in ("radius", "knn"):
        raise ValueError(f"unknown neighbor mode {mode!r}")
    k = int(k)
    device = torch.device(device)
    query = np.asarray(query, dtype=np.float32)[:, :3]
    search = np.asarray(search, dtype=np.float32)[:, :3]
    problem = grid.build_tiled_problem(query, search, float(radius),
                                       entry_batch=ENTRY_BATCH)
    query_pad, search_pad, _, tables, candidates = grid._problem_tensors(
        problem, query, search, None, device)
    r2 = float(mk.squared_radii([radius])[0]) if mode == "radius" else None
    n_query = len(query)

    out_idx = torch.full((n_query + 1, k), -1, dtype=torch.int32,
                         device=device)
    out_dist = torch.full((n_query + 1, k), float("inf"),
                          dtype=torch.float32, device=device)
    out_found = torch.zeros((n_query + 1, k), dtype=torch.bool,
                            device=device)
    out_count = torch.zeros(n_query + 1, dtype=torch.int32, device=device)
    stats = {"entries": int(problem.stats["entries"]),
             "entry_batches": 0, "sub_batches": 0, "max_width": 0,
             "pairs": 0, "q_cap": int(problem.stats["q_cap"]),
             "lanes": int(problem.stats["n_off"] * problem.stats["s_cap"])}
    for batch in grid._entry_batches(tables, ENTRY_BATCH):
        stats["entry_batches"] += 1
        # the padding entries (no query) write only the sentinel row
        live = torch.nonzero((batch[0] >= 0).any(1))[:, 0]
        if live.numel() == 0:
            continue
        q_idx, rows, centers = (t[live] for t in batch)
        c_idx = candidates[rows].reshape(rows.shape[0], -1)
        n_valid = (c_idx >= 0).sum(1)
        q_cap = q_idx.shape[1]
        width = max(int(n_valid.max()), k)
        step = max(1, PAIR_BUDGET // (q_cap * width))
        for lo in range(0, rows.shape[0], step):
            sl = slice(lo, lo + step)
            sub_width = max(int(n_valid[sl].max()), k)
            sub = _compact(c_idx[sl], sub_width)
            idx, dist, found, count = _sub_batch(
                query_pad, search_pad, q_idx[sl], sub, centers[sl], k, r2)
            targets = q_idx[sl].reshape(-1)
            targets = torch.where(targets < 0, n_query, targets)
            out_idx[targets] = idx.reshape(-1, k).to(torch.int32)
            out_dist[targets] = dist.reshape(-1, k)
            out_found[targets] = found.reshape(-1, k)
            out_count[targets] = count.reshape(-1).to(torch.int32)
            stats["sub_batches"] += 1
            stats["max_width"] = max(stats["max_width"], sub_width)
            stats["pairs"] += int(sub.shape[0]) * q_cap * sub_width
    return {"indices": out_idx[:n_query], "distances": out_dist[:n_query],
            "valid": out_found[:n_query], "count": out_count[:n_query],
            "stats": stats}


def radius_neighbors(query, search, radius, k_max=64, device="cuda"):
    """
    All search points within ``radius`` of each query point, up to
    ``k_max`` per query (nearest kept when truncating), on ``device``.

    Returns a dict of NumPy arrays: indices (N, k_max) int32 padded -1,
    distances (N, k_max) float32 (inf-padded), valid mask, count (the
    true neighbor count -- count > k_max flags truncation), overflowed
    (bool array).
    """
    got = neighbor_search(query, search, k_max, radius, "radius", device)
    count = got["count"].cpu().numpy()
    return {"indices": got["indices"].cpu().numpy(),
            "distances": got["distances"].cpu().numpy(),
            "valid": got["valid"].cpu().numpy(),
            "count": count,
            "overflowed": count > k_max}


def knn(query, search, k, max_radius, device="cuda"):
    """
    The ``k`` nearest search points of each query point among the
    candidates of its tiles (edge ``max_radius``: every point within the
    horizon is seen, and some beyond it may be), on ``device``.

    Returns a dict of NumPy arrays: indices (N, k) int32, distances
    (N, k) float32, valid.
    """
    got = neighbor_search(query, search, k, max_radius, "knn", device)
    return {key: got[key].cpu().numpy()
            for key in ("indices", "distances", "valid")}
