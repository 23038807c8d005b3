"""
Attribute interpolation onto voxel centers (port of
``nimrud_tpu/ops/interp.py``).

The V_MSO ``vector`` layout averages per-point attributes over the
Chebyshev ball of radius = voxel edge around every voxel center.  Three
routes, each the reference's:

* :func:`packed_interp` -- the packed-candidate machinery: the queries
  are the band's voxel centers, the search the raw cloud, one pack plan
  on a voxel-edge tile grid, and the mean rides the attribute rows of
  the ``packed_moments`` kernel's chebyshev instance (1..6 columns; the
  packed backend's route).
* :func:`interp_to_voxels` -- the gather interp: the 27 voxel segments
  around each center, ``s_cap`` points each, gathered and averaged in
  batches of centers (the XLA bands' route for up to 8 columns).
* :func:`matmul_interp` / :func:`interp_to_voxels_matmul` -- the mean
  as a moment product of the XLA candidate-table path
  (``device_grid.fused_extract`` with the chebyshev metric; more than 8
  columns).

Each distance is the reference's own: the packed kernel's entry-local
difference, the gather interp's ``pts - ctr`` compared unsquared with
the ball, the tile path's entry-local difference squared.
"""

import torch

from nimrud_tpu_torch.ops import device_grid, unique
from nimrud_tpu_torch.ops.packing import PAD_KEY, scalar

_PAD = int(PAD_KEY)


def packed_interp(search, s_valid, attributes, spec, dev_spec, c_cap, *,
                  radius=None, with_stats=False, precision="highest"):
    """
    Chebyshev-ball attribute means at every voxel center of ``search``
    under ``spec`` (a ``packing.GridSpec``): per center, the mean of the
    attributes of the search points with ``max(|d|) <= radius`` (default
    the voxel edge), the distance formed in the pack plan's entry-local
    frame as the reference's packed kernel forms it.

    Args:
      search:     (N, 3) float32, padded rows allowed.
      s_valid:    (N,) bool.
      attributes: (N, A) float32 rows aligned with ``search``, A <= 6.
      spec:       the voxel grid.
      dev_spec:   a voxel-edge tile grid over the site bounds whose
                  queries are the voxel centers (its ``s_cap`` must
                  bound the raw cloud's points a fine tile: size it on
                  the host, ``multiscale._interp_packed_plan``).
      c_cap:      candidates per entry: an int or a split
                  ``(caps, bounds)``; overflow is counted.

    Returns ``(centers, mask, attr_mean)``: (N, 3) centers in voxel-key
    order (``unique.unique_voxels``), their validity, and (N, A) means
    (zeros on dead rows); with ``with_stats`` also ``{"dropped_search":
    n}``, the centers left without an entry slot plus the candidates
    past ``c_cap``: either means the interp under-read the cloud.
    """
    edge = float(spec.edge_length)
    ball = float(edge if radius is None else radius)
    if ball > edge:
        raise ValueError(
            "packed interp covers a Chebyshev ball up to one voxel "
            f"edge ({edge}), got radius {ball}")
    centers, _, mask = unique.unique_voxels(search, spec, valid=s_valid)
    out = device_grid.fused_extract_packed(
        centers, mask, search, s_valid, dev_spec, (ball,), "vector",
        centers.shape[0], c_cap, with_stats=with_stats, precision=precision,
        attributes=attributes, metric="chebyshev")
    if not with_stats:
        return centers, mask, out
    attr_mean, dev_stats = out
    stats = {"dropped_search": (dev_stats["dropped_query"]
                                + dev_stats["dropped_candidates"])}
    return centers, mask, attr_mean, stats


def _axis_cells(keys, spec):
    """Unpack int32 voxel keys into per-axis cell indices."""
    return [(keys >> shift) & ((1 << width) - 1)
            for width, shift in zip(spec.widths, spec.shifts)]


def _pack_cells(cells, spec):
    key = cells[0]
    for axis, shift in enumerate(spec.shifts[1:], start=1):
        key = key | (cells[axis] << shift)
    return key


def interp_to_voxels(search, s_valid, attributes, spec, s_cap, *,
                     radius=None, metric="chebyshev", batch=512,
                     with_stats=False):
    """
    Voxel-downsample ``search`` under ``spec`` and average the
    ``attributes`` of the points within ``radius`` (default the voxel
    edge) of every voxel center, the distance ``pts - ctr`` compared
    with the ball unsquared (chebyshev ``max |d|``, euclidean
    ``sqrt(dx*dx + dy*dy + dz*dz)``).  The candidates of a center are
    the points of the 27 voxels around it, at most ``s_cap`` a voxel
    (the rest are counted with ``with_stats``), located by binary search
    over the sorted unique keys.

    Args:
      search:     (N, 3) float32, padded rows allowed.
      s_valid:    (N,) bool.
      attributes: (N, A) float32, rows aligned with ``search``.
      spec:       the voxel grid (``packing.GridSpec``).

    Returns ``(centers, mask, attr_mean)``: (N, 3) centers in key order
    (zeros on dead rows), their validity and (N, A) means (zeros on
    dead rows); with ``with_stats`` also ``{"dropped_search": n}``.
    """
    dev = search.device
    n = search.shape[0]
    ball = float(spec.edge_length if radius is None else radius)

    keys = torch.where(s_valid, spec.encode(search), _PAD)
    sorted_keys, sorted_order = torch.sort(keys, stable=True)
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      sorted_keys[1:] != sorted_keys[:-1]])
    live = sorted_keys != _PAD
    seg = torch.cumsum(head.to(torch.int64), 0) - 1   # segment of a point
    target = torch.where(head & live, seg, n)         # n: dropped
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    uniq = torch.full((n + 1,), _PAD, dtype=torch.int32, device=dev)
    uniq[target] = sorted_keys
    uniq = uniq[:n]
    starts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    starts[target] = iota
    lens = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    lens.index_add_(0, torch.where(live, seg, n), torch.ones_like(seg))
    mask = uniq != _PAD
    centers = spec.decode(torch.where(mask, uniq, 0))
    centers = torch.where(mask[:, None], centers, torch.zeros_like(centers))

    # the 27 neighbour voxels' rows by binary search over the unique keys
    cells = _axis_cells(uniq, spec)
    caps = [(1 << w) - 1 for w in spec.widths]
    rows = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                moved = [cells[0] + dx, cells[1] + dy, cells[2] + dz]
                ok = mask
                for axis in range(3):
                    ok = ok & (moved[axis] >= 0) & (moved[axis] <= caps[axis])
                nkey = _pack_cells([torch.clamp(c, 0, cap)
                                    for c, cap in zip(moved, caps)], spec)
                pos = torch.searchsorted(uniq, nkey)
                hit = ok & (pos < n) \
                    & (uniq[torch.clamp(pos, 0, n - 1)] == nkey)
                rows.append(torch.where(hit, pos, n))
    neighbor_rows = torch.stack(rows, dim=1)          # (n, 27)

    starts_ext = starts.clone()
    starts_ext[n] = 0
    lens_ext = lens.clone()
    lens_ext[n] = 0
    lens = lens[:n]
    search_sorted = torch.cat([search[sorted_order],
                               search.new_zeros((1, 3))])
    attr_sorted = torch.cat([attributes[sorted_order],
                             attributes.new_zeros((1, attributes.shape[1]))])
    col = torch.arange(s_cap, dtype=torch.int64, device=dev)
    ball32 = scalar(ball, search)
    means = []
    for lo in range(0, n, batch):
        ctr = centers[lo:lo + batch]                  # (B, 3)
        rws = neighbor_rows[lo:lo + batch]            # (B, 27)
        st = starts_ext[rws]
        ln = torch.clamp(lens_ext[rws], max=s_cap)
        pos = st[:, :, None] + col[None, None, :]     # (B, 27, s_cap)
        within = col[None, None, :] < ln[:, :, None]
        idx = torch.where(within, torch.clamp(pos, 0, n - 1), n)
        flat = idx.reshape(idx.shape[0], -1)          # (B, 27 * s_cap)
        delta = search_sorted[flat] - ctr[:, None, :]
        if metric == "chebyshev":
            dist = torch.maximum(torch.maximum(
                delta[..., 0].abs(), delta[..., 1].abs()), delta[..., 2].abs())
        elif metric == "euclidean":
            dist = torch.sqrt(delta[..., 0] * delta[..., 0]
                              + delta[..., 1] * delta[..., 1]
                              + delta[..., 2] * delta[..., 2])
        else:
            raise ValueError(f"unknown metric {metric!r}")
        w = ((flat < n) & (dist <= ball32)).to(torch.float32)
        total = w.sum(1)
        summed = torch.bmm(w[:, None, :], attr_sorted[flat])[:, 0]
        means.append(summed / torch.clamp(total, min=1.0)[:, None])
    attr_mean = torch.cat(means)
    attr_mean = torch.where(mask[:, None], attr_mean,
                            torch.zeros_like(attr_mean))
    if not with_stats:
        return centers, mask, attr_mean
    dropped = (torch.clamp(lens - s_cap, min=0) * mask).sum()
    return centers, mask, attr_mean, {"dropped_search": dropped}


def matmul_interp(search, s_valid, attributes, spec, dev_spec, *,
                  radius=None, with_stats=False):
    """
    The chebyshev-ball attribute means at the voxel centers of
    ``search`` through the XLA candidate-table path
    (``device_grid.fused_extract``, ``metric="chebyshev"``), the
    attributes as extra columns of the moment product: the reference's
    route for wide attribute blocks (more than 8 columns).
    ``dev_spec`` is a voxel-edge tile grid whose queries are the voxel
    centers.  Returns ``(centers, mask, out)``: ``out`` the (N, A) means,
    or with ``with_stats`` ``(means, build_tables' counters)``.
    """
    edge = float(spec.edge_length)
    ball = float(edge if radius is None else radius)
    if ball > edge:
        raise ValueError(
            "matmul interp covers a Chebyshev ball up to one voxel "
            f"edge ({edge}), got radius {ball}")
    centers, _, mask = unique.unique_voxels(search, spec, valid=s_valid)
    out = device_grid.fused_extract(
        centers, mask, search, s_valid, dev_spec, (ball,), "vector", None,
        "highest", search.shape[0], with_stats, attributes, "chebyshev")
    return centers, mask, out


def interp_to_voxels_matmul(search, s_valid, attributes, spec, s_cap,
                            bounds_lo, bounds_hi, *, radius=None,
                            with_stats=False):
    """:func:`interp_to_voxels`' contract through :func:`matmul_interp`,
    on a voxel-edge tile grid over the cloud's real bounds
    (``bounds_lo`` / ``bounds_hi``, host scalars) with ``s_cap`` points
    a fine tile.  With ``with_stats`` the points past ``s_cap`` are
    counted as ``dropped_search``."""
    dev_spec = device_grid.make_spec(
        bounds_lo, bounds_hi, float(spec.edge_length),
        n_query=search.shape[0], s_cap=int(s_cap))
    centers, mask, out = matmul_interp(
        search, s_valid, attributes, spec, dev_spec, radius=radius,
        with_stats=with_stats)
    if not with_stats:
        return centers, mask, out
    attr_mean, dev_stats = out
    return centers, mask, attr_mean, {
        "dropped_search": dev_stats["dropped_search"]}
