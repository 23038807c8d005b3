"""
Multiscale feature extraction of the port (port of
``nimrud_tpu/features/multiscale.py``).

For each band ``(voxel_edge, radii)`` the search cloud is
voxel-downsampled (edge 0: the raw cloud) and every radius of the band
shares one distance computation; bands concatenate left to right.
:func:`extract_scaleset_device` / :func:`extract_scaleset` take one of
the reference's methods:

* ``"fused"`` (:func:`extract_scaleset_fused`): everything on the
  device, per band a device voxel downsample and one fused extraction
  -- the ``packed_moments`` kernel (``backend="packed"``), the
  ``span_moments`` kernel (``"pallas"``) or the XLA candidate-table path
  (``"xla"``, ``ops.device_grid.fused_extract``: masked float32 matrix
  products), routed per band as the reference routes them;
* ``"dense"``: the O(N x S) masked moments of ``ops.moments``, queries
  sorted by voxel address in chunks;
* ``"tiled"``: the host tile plan and ``ops.grid.tiled_features``'s XLA
  path;
* ``"auto"``: fused at ``TILED_THRESHOLD`` or more search points with
  every band voxelized, else per band tiled (at that many voxels) or
  dense.

The ``vector`` layout (V_MSO) first interpolates the search points'
attributes onto the voxel centers (``ops.interp``: the packed, gather or
matmul interp) and then serves the masked means of those center
attributes over each radius.
"""

import numpy as np
import torch

from nimrud_tpu_torch.features import layouts
from nimrud_tpu_torch.ops import (device_grid, grid, interp, moments, native,
                                  packing, span_host, unique)
from nimrud_tpu_torch.utils.geometry import VoxelFilter

# cap on query-chunk x search pairs a step of the dense method
PAIRS_BUDGET = 1 << 24
# method="auto" takes the fused path, and a band the tiled method, from
# this many search points (voxels, for a band)
TILED_THRESHOLD = 16384
# voxel_downsample dedups on the host from this many points
HOST_VOXEL_THRESHOLD = 200_000

KINDS = ("minimal", "geometric", "oriented", "covariance", "eigen",
         "sazo", "vector")
METHODS = ("auto", "dense", "tiled", "fused")
BACKENDS = ("packed", "pallas", "xla")
INTERP_BACKENDS = ("auto", "gather", "matmul", "packed")

# the reference's precision names -> the kernels' precision: "mixed" and
# "high" (XLA matmul precisions) map onto the bf16 split, "default" onto
# the f32 sums (``features/multiscale.py:461-466`` there).  The XLA path
# sums every name in f32 (``ops.grid.PRECISIONS``).
KERNEL_PRECISION = {"highest": "highest", "default": "highest",
                    "bf16x2": "bf16x2", "mixed": "bf16x2", "high": "bf16x2"}


def kernel_precision(precision):
    """The moment kernels' precision for one of the reference's names."""
    if precision not in KERNEL_PRECISION:
        raise ValueError(f"precision must be one of "
                         f"{tuple(KERNEL_PRECISION)}, got {precision!r}")
    return KERNEL_PRECISION[precision]


def resolve_backend(tuning, backend="packed"):
    """The fused path's backend: ``tuning["backend"]`` where given, as in
    the reference, else ``backend`` (the packed kernel on every device,
    where the reference took XLA bands off a TPU)."""
    backend = (tuning or {}).get("backend") or backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: must be one of "
                         f"{BACKENDS}")
    return backend


def check_attributes(attributes, n_search):
    """``attributes`` as a (n_search, A) float32 array, A >= 1."""
    attributes = np.asarray(attributes, dtype=np.float32)
    if attributes.ndim != 2 or attributes.shape[0] != n_search \
            or attributes.shape[1] < 1:
        raise ValueError(f"attributes must be ({n_search}, A), got "
                         f"{attributes.shape}")
    return attributes


def _pow2_bucket(n, minimum=128):
    bucket = minimum
    while bucket < n:
        bucket *= 2
    return bucket


def _pad_rows_f32(array, target):
    """Rows padded to ``target`` by repeating the last row."""
    n = array.shape[0]
    if n == target:
        return np.ascontiguousarray(array, dtype=np.float32)
    out = np.zeros((target,) + array.shape[1:], dtype=np.float32)
    out[:n] = array
    if n:
        out[n:] = array[-1]
    return out


def _effective_chunk(chunk_size, n_search_padded):
    """Power-of-two query chunk no larger than ``chunk_size`` keeping the
    chunk x search block within ``PAIRS_BUDGET`` (at least 64)."""
    chunk = min(chunk_size, max(64, PAIRS_BUDGET // max(n_search_padded, 1)))
    out = 64
    while out * 2 <= chunk:
        out *= 2
    return out


def _host_unique_voxels(search, edge, bounds=None, impl="native"):
    """Host voxel downsample -> float32 centers sorted by voxel address,
    through the C++ host runtime (``impl="numpy"``: its twin).

    ``bounds``: explicit (lo, hi) grid anchor (default: the search
    cloud's own bounds); fixed-bounds models pass theirs so fit-time
    voxelization matches the serving grid exactly."""
    search = np.asarray(search, np.float32)[:, :3]
    if bounds is None:
        b_lo, b_hi = (b.astype(np.float64)
                      for b in native.minmax3(search, impl=impl))
    else:
        b_lo = np.asarray(bounds[0], np.float64)
        b_hi = np.asarray(bounds[1], np.float64)
    origin = b_lo - edge / 2
    span = (b_hi + edge / 2) - origin
    dims = np.maximum(np.ceil(span / edge).astype(np.int64), 1)
    return native.voxel_unique(search, origin, edge, dims, impl=impl)


def voxel_downsample(search, edge, attributes=None,
                     interp_metric="chebyshev", bounds=None, device="cuda"):
    """
    Voxel-downsample a search cloud at ``edge`` on ``device`` (the card
    unless the caller asks for the CPU), optionally averaging per-point
    ``attributes`` over the ball of radius ``edge`` (``interp_metric``)
    around each voxel center.  Returns ``(centers, attrs)`` as NumPy
    arrays (attrs None without attributes).

    The dedup runs on the device below ``HOST_VOXEL_THRESHOLD`` points
    when the grid fits the 30-bit key budget, on the host otherwise; the
    means come from ``grid.tiled_moments`` at ``TILED_THRESHOLD`` or
    more points, from ``moments.multiscale_moments`` below.  ``bounds``:
    explicit (lo, hi) voxel-grid anchor (default the cloud's bounds).
    """
    search = np.asarray(search, dtype=np.float32)
    spec = None
    if search.shape[0] < HOST_VOXEL_THRESHOLD:
        try:
            if bounds is None:
                spec = packing.GridSpec.fit(search[:, :3], edge)
            else:
                spec = packing.GridSpec.fit_bounds(
                    np.asarray(bounds[0], np.float64),
                    np.asarray(bounds[1], np.float64), edge)
        except ValueError:
            spec = None
    if spec is not None:
        bucket = _pow2_bucket(search.shape[0])
        padded = torch.from_numpy(_pad_rows_f32(search[:, :3], bucket))
        valid = torch.arange(bucket) < search.shape[0]
        centers, count, _ = unique.unique_voxels(
            padded.to(device), spec, valid=valid.to(device))
        centers = centers[:int(count)].cpu().numpy()
    else:
        centers = _host_unique_voxels(search, edge, bounds=bounds)
    if attributes is None:
        return centers, None

    attributes = np.asarray(attributes, dtype=np.float32)
    if search.shape[0] >= TILED_THRESHOLD:
        problem = grid.build_tiled_problem(centers, search, edge)
        got = grid.tiled_moments(problem, centers, search, (float(edge),),
                                 attributes=attributes, metric=interp_metric,
                                 device=device)
        return centers, got["attr_mean"][:, 0, :]
    n_centers = centers.shape[0]
    s_bucket = _pow2_bucket(search.shape[0])
    valid = torch.arange(s_bucket, device=device) < search.shape[0]

    def put(array, rows):
        return torch.from_numpy(_pad_rows_f32(array, rows)).to(device)

    got = moments.multiscale_moments(
        put(centers, _pow2_bucket(n_centers)), put(search[:, :3], s_bucket),
        valid, (float(edge),), attributes=put(attributes, s_bucket),
        chunk_size=_effective_chunk(256, s_bucket), metric=interp_metric)
    return centers, got["attr_mean"][:n_centers, 0, :].cpu().numpy()


def _band_features(query_padded, n_query, search, kind, edge, radii,
                   attributes, exclude_radius, chunk_size, method, tuning,
                   bounds=None, device="cuda"):
    """Features (n_query, width) of one band by the dense or tiled
    method; ``query_padded`` (a tensor on ``device``) is already padded
    and sorted."""
    if edge > 0:
        centers, attrs = voxel_downsample(
            search, edge, attributes if kind == "vector" else None,
            bounds=bounds, device=device)
    else:
        centers = np.asarray(search, dtype=np.float32)
        attrs = attributes
    if method == "tiled" or (method == "auto"
                             and centers.shape[0] >= TILED_THRESHOLD):
        query = query_padded[:n_query].cpu().numpy()
        batch = tuning.get("entry_batch", 256)
        problem = grid.build_tiled_problem(
            query, centers, tile_edge=max(radii),
            query_tile_factor=tuning.get("query_tile_factor", 3),
            query_capacity=tuning.get("query_capacity"), entry_batch=batch)
        return grid.tiled_features(
            problem, query, centers, radii, kind,
            attributes=attrs if kind == "vector" else None,
            exclude_radius=exclude_radius, entry_batch=batch,
            precision=tuning.get("precision", "highest"), device=device)

    s_bucket = _pow2_bucket(centers.shape[0])
    got = moments.multiscale_moments(
        query_padded, torch.from_numpy(_pad_rows_f32(centers, s_bucket)
                                       ).to(device),
        torch.arange(s_bucket, device=device) < centers.shape[0], radii,
        attributes=None if kind != "vector" else torch.from_numpy(
            _pad_rows_f32(attrs, s_bucket)).to(device),
        chunk_size=_effective_chunk(chunk_size, s_bucket),
        exclude_radius=exclude_radius, with_sazo=layouts.needs_sazo(kind))
    blocks = []
    for ri, radius in enumerate(radii):
        if kind == "vector":
            block = got["attr_mean"][:, ri]
        else:
            block = layouts.build_block(
                kind, got["count"][:, ri], got["mean"][:, ri],
                got["cov"][:, ri], query_padded, radius,
                sazo=got["sazo"][:, ri] if "sazo" in got else None)
        blocks.append(block[:n_query])
    return torch.cat(blocks, dim=1)


def _voxel_occupancy_cap(search, spec):
    """Host upper bound on raw points per voxel (one key sort)."""
    s64 = search.astype(np.float64)
    origin = np.asarray(spec.origin)
    cell = np.floor((s64 - origin) / spec.edge_length).astype(np.int64)
    cell = np.clip(cell, 0, [2 ** w - 1 for w in spec.widths])
    key = cell[:, 0]
    for axis, shift in enumerate(spec.shifts[1:], start=1):
        key = key | (cell[:, axis] << shift)
    _, counts = np.unique(key, return_counts=True)
    return int(counts.max())


def _interp_packed_plan(search, vox_spec, lo, hi, s_bounds, m,
                        host_centers=None, segment_wide=False):
    """Host spec and candidate capacity of the packed attribute interp
    (``ops.interp.packed_interp``): a voxel-edge tile grid whose queries
    are the band's voxel centers and whose search side is the raw cloud,
    at q_cap 128 and one coarse tile a segment (the interp's candidate
    box is voxel-scale fringe around each entry; a wide segment would
    swallow long x-runs of the raw cloud).  ``s_cap`` bounds raw points
    a fine tile: the tile grid sits about half a voxel off the voxel
    grid, so a tile overlaps at most 8 voxels and 8x the largest voxel
    occupancy bounds the sizing cloud.  The capacity is the split
    ``(caps, bounds)`` of ``span_host.candidate_caps_split`` (or one
    int), sized on the centers against the raw cloud; denser clouds
    overflow into the counted ``interp_dropped``.

    ``segment_wide`` (the multi-device sizing): one bounding capacity,
    ``span_host.candidate_cap(segment_wide=True)``.  Each shard packs
    its own subset of the centers into entries this host mirror cannot
    reproduce, but any packing's candidate set lies within its
    segment's whole x-range, and split buckets' rank cuts mean nothing
    across shard packings."""
    edge = float(vox_spec.edge_length)
    search = np.asarray(search, np.float32)[:, :3]
    if host_centers is None:
        host_centers = _host_unique_voxels(search, edge, bounds=s_bounds)
    occ = _voxel_occupancy_cap(search, vox_spec)
    ispec = device_grid.make_spec(
        lo, hi, edge, n_query=_pow2_bucket(search.shape[0]), q_cap=128,
        m=m, x_seg=1, s_cap=_pow2_bucket(8 * occ, minimum=8))
    ispec = device_grid.with_entry_estimate(ispec, host_centers)
    if segment_wide:
        return ispec, int(span_host.candidate_cap(host_centers, search,
                                                  ispec, segment_wide=True))
    icap = span_host.candidate_caps_split(host_centers, search, ispec)
    return ispec, icap if isinstance(icap, tuple) else int(icap)


def extract_scaleset_fused(query, search, scaleset, kind="minimal", *,
                           attributes=None, exclude_radius=None,
                           bounds=None, m=3, backend="packed",
                           precision="highest", tuning=None,
                           with_stats=False, device="cuda"):
    """
    Multiscale features for every query point, on ``device`` (the card
    unless the caller asks for the CPU): per band a device voxel
    downsample (``vector``: the attribute interp) and one fused
    extraction, routed per band as the reference routes it:

    * the packed kernel (``packed_moments``, a host-sized candidate
      capacity) for ``backend="packed"``, except ``vector`` with more
      than 6 attribute columns;
    * the span kernel (``span_moments``, no candidate cap) for
      ``backend="pallas"``, except ``sazo`` and ``vector``;
    * the XLA candidate-table path (``device_grid.fused_extract``, q_cap
      128, one coarse tile an entry) for everything else -- every band
      of ``backend="xla"``.

    ``vector`` needs ``attributes`` (rows aligned with ``search``);
    its interp (``tuning["interp_backend"]``, default "auto") is the
    matmul interp above 8 columns, the packed interp at 1-6 columns on
    the packed backend, the gather interp otherwise.  ``precision``:
    the reference's names, the kernels' precision by
    ``kernel_precision``; the XLA bands sum in f32 whatever the name.
    ``exclude_radius``: leave out the search points closer than this
    to the query (pairs with ``d2 < f32(e*e)``); the ``vector`` interp
    takes no exclusion, as in the reference.

    ``tuning``: the reference's dict -- ``query_capacity``,
    ``query_tile_factor`` (else ``m``), ``entry_batch``,
    ``vector_s_cap``, ``interp_backend``, ``candidate_cap``,
    ``estimate_entries`` (default True), and ``backend`` and
    ``precision``, each of which takes precedence over the argument.
    ``bounds``: fixed site (lo, hi) governing every grid; default the
    clouds' own bounds, with voxel grids anchored at the search bounds.
    Returns an (n_query, width) float32 tensor; with ``with_stats`` also
    the overflow counters summed over the bands, as device scalars:
    ``dropped_query`` (queries without an entry slot),
    ``dropped_candidates`` (candidates past the packed capacity),
    ``dropped_search`` (search points past an XLA band's tile capacity)
    and ``interp_dropped`` (the ``vector`` interp's under-reads).
    """
    tuning = tuning or {}
    precision = tuning.get("precision", precision)
    m = tuning.get("query_tile_factor", m)
    backend = resolve_backend(tuning, backend)
    prec = kernel_precision(precision)
    xla_prec = "highest" if precision == "bf16x2" else precision
    interp_backend = tuning.get("interp_backend", "auto")
    if interp_backend not in INTERP_BACKENDS:
        raise ValueError(f"unknown interp_backend {interp_backend!r}")
    query = np.asarray(query, dtype=np.float32)[:, :3]
    search = np.asarray(search, dtype=np.float32)[:, :3]
    n_attr = 0
    if kind == "vector":
        if attributes is None:
            raise ValueError("kind='vector' requires attributes")
        attributes = check_attributes(attributes, search.shape[0])
        n_attr = attributes.shape[1]
    scaleset = [(float(edge), tuple(float(r) for r in radii))
                for edge, radii in scaleset]
    if any(edge <= 0 for edge, _ in scaleset):
        raise ValueError("fused path requires voxel edges > 0")

    n_query = query.shape[0]
    if bounds is not None:
        lo = np.asarray(bounds[0], np.float64)
        hi = np.asarray(bounds[1], np.float64)
        s_lo, s_hi = lo, hi
    else:
        lo = np.minimum(query.min(0), search.min(0)).astype(np.float64)
        hi = np.maximum(query.max(0), search.max(0)).astype(np.float64)
        s_lo = search.min(0).astype(np.float64)
        s_hi = search.max(0).astype(np.float64)

    q_bucket = _pow2_bucket(n_query)
    s_bucket = _pow2_bucket(search.shape[0])
    query_dev = torch.from_numpy(_pad_rows_f32(query, q_bucket)).to(device)
    search_dev = torch.from_numpy(_pad_rows_f32(search, s_bucket)).to(device)
    q_valid = torch.arange(q_bucket, device=device) < n_query
    s_valid = torch.arange(s_bucket, device=device) < search.shape[0]
    attrs_dev = None
    if kind == "vector":
        attrs_dev = torch.from_numpy(_pad_rows_f32(attributes,
                                                   s_bucket)).to(device)

    zero = torch.zeros((), dtype=torch.int64, device=device)
    stats = dict.fromkeys(("dropped_query", "dropped_candidates",
                           "dropped_search", "interp_dropped"), zero)

    def count(band_stats):
        for key, value in band_stats.items():
            stats[key] = stats[key] + value

    use_packed = backend == "packed" and n_attr <= 6
    use_spans = backend == "pallas" and kind not in ("vector", "sazo")
    use_kernel = use_packed or use_spans
    bands = []
    for edge, radii in scaleset:
        vox_spec = packing.GridSpec.fit_bounds(s_lo, s_hi, edge)
        center_attrs = None
        if kind == "vector":
            s_cap = tuning.get("vector_s_cap") or _pow2_bucket(
                _voxel_occupancy_cap(search, vox_spec), minimum=8)
            if interp_backend == "matmul" or (interp_backend == "auto"
                                              and n_attr > 8):
                centers, center_mask, center_attrs, istats = \
                    interp.interp_to_voxels_matmul(
                        search_dev, s_valid, attrs_dev, vox_spec,
                        int(s_cap), s_lo, s_hi, with_stats=True)
            elif interp_backend == "packed" or (
                    interp_backend == "auto" and backend == "packed"
                    and n_attr <= 6):
                ispec, icap = _interp_packed_plan(search, vox_spec, lo, hi,
                                                  (s_lo, s_hi), m)
                centers, center_mask, center_attrs, istats = \
                    interp.packed_interp(search_dev, s_valid, attrs_dev,
                                         vox_spec, ispec, icap,
                                         with_stats=True)
            else:
                centers, center_mask, center_attrs, istats = \
                    interp.interp_to_voxels(search_dev, s_valid, attrs_dev,
                                            vox_spec, int(s_cap),
                                            with_stats=True)
            count({"interp_dropped": istats["dropped_search"]})
        else:
            centers, _, center_mask = unique.unique_voxels(
                search_dev, vox_spec, valid=s_valid)
        spec = device_grid.make_spec(
            lo, hi, max(radii), n_query=q_bucket, m=m,
            q_cap=tuning.get("query_capacity") or (256 if use_kernel
                                                   else 128),
            voxel_edge=edge, entry_batch=tuning.get("entry_batch", 256),
            x_seg=32 if use_kernel else 1)
        if tuning.get("estimate_entries", True):
            spec = device_grid.with_entry_estimate(spec, query)
        if use_packed:
            cap = tuning.get("candidate_cap") or span_host.candidate_cap(
                query, _host_unique_voxels(search, edge, bounds=bounds),
                spec)
            feats, band_stats = device_grid.fused_extract_packed(
                query_dev, q_valid, centers, center_mask, spec, radii, kind,
                n_query, int(cap), with_stats=True, precision=prec,
                attributes=center_attrs, exclude_radius=exclude_radius)
        elif use_spans:
            feats, band_stats = device_grid.fused_extract_spans(
                query_dev, q_valid, centers, center_mask, spec, radii, kind,
                n_query, with_stats=True, precision=prec,
                exclude_radius=exclude_radius)
        else:
            feats, band_stats = device_grid.fused_extract(
                query_dev, q_valid, centers, center_mask, spec, radii, kind,
                exclude_radius, xla_prec, n_query, with_stats=True,
                attributes=center_attrs)
        count(band_stats)
        bands.append(feats)
    features = torch.cat(bands, dim=1)
    return (features, stats) if with_stats else features


def plan_report(query, search, scaleset, *, method="tiled", tuning=None,
                device="cuda"):
    """
    Per-band static-plan occupancy, no kernel run (port of the
    reference's ``plan_report``).  For each ``(edge, radii)`` band:

      entry_fill:  live entries / entry capacity (dead entries still
                   cost kernel batches);
      q_slot_fill: valid queries / (live entries x q_cap);
      q_cap / s_cap / e_cap: the static capacities themselves.

    ``method`` "tiled" (the host-built plan; ``device`` runs the voxel
    downsample of its search side) or "fused" (the fused path's spec,
    fill from the host entry estimate, with ``e_cap_worst_case``).  The
    fused plan's backend resolves as :func:`extract_scaleset_fused`
    resolves it (``tuning["backend"]``, else the packed kernel), so the
    report describes the plan the extraction runs.
    """
    tuning = tuning or {}
    query = np.asarray(query, dtype=np.float32)[:, :3]
    search = np.asarray(search, dtype=np.float32)[:, :3]
    scaleset = [(float(edge), tuple(float(r) for r in radii))
                for edge, radii in scaleset]
    report = []
    if method == "fused":
        lo = np.minimum(query.min(0), search.min(0)).astype(np.float64)
        hi = np.maximum(query.max(0), search.max(0)).astype(np.float64)
        q_bucket = _pow2_bucket(query.shape[0])
        backend = resolve_backend(tuning)
        for edge, radii in scaleset:
            if edge <= 0:
                raise ValueError("fused plan needs voxel edges > 0")
            use_kernel = backend in ("pallas", "packed")
            spec = device_grid.make_spec(
                lo, hi, max(radii), n_query=q_bucket,
                m=tuning.get("query_tile_factor", 3),
                q_cap=tuning.get("query_capacity")
                or (256 if use_kernel else 128),
                voxel_edge=edge, entry_batch=tuning.get("entry_batch", 256),
                x_seg=32 if use_kernel else 1)
            worst = spec.e_cap
            if tuning.get("estimate_entries", True):
                spec = device_grid.with_entry_estimate(spec, query)
            live = device_grid.estimate_entries(query, spec)
            report.append({
                "edge": edge, "e_cap": spec.e_cap,
                "e_cap_worst_case": worst, "entries_live": live,
                "entry_fill": round(live / max(spec.e_cap, 1), 4),
                "q_slot_fill": round(
                    query.shape[0] / max(live * spec.q_cap, 1), 4),
                "q_cap": spec.q_cap, "s_cap": spec.s_cap})
        return report
    for edge, radii in scaleset:
        centers = voxel_downsample(search, edge, device=device)[0] \
            if edge > 0 else search
        problem = grid.build_tiled_problem(
            query, centers, tile_edge=max(radii),
            query_tile_factor=tuning.get("query_tile_factor", 3),
            query_capacity=tuning.get("query_capacity"),
            entry_batch=tuning.get("entry_batch", 256))
        stats = problem.stats
        report.append({
            "edge": edge, "e_cap": problem.n_entries,
            "entries_live": stats["entries"],
            "entry_fill": round(
                stats["entries"] / max(problem.n_entries, 1), 4),
            "q_slot_fill": round(stats["fill"], 4),
            "q_cap": stats["q_cap"], "s_cap": stats["s_cap"]})
    return report


def extract_scaleset_device(query, search, scaleset, kind="geometric", *,
                            attributes=None, exclude_radius=None,
                            chunk_size=1024, sort_queries=True,
                            method="auto", tuning=None, bounds=None, m=3,
                            backend="packed", precision="highest",
                            with_stats=False, device="cuda"):
    """
    The reference's public extraction entry point, on ``device`` (the
    card unless the caller asks for the CPU).  ``method``:

    * ``"fused"``, and ``"auto"`` at ``TILED_THRESHOLD`` or more search
      points with every band voxelized: :func:`extract_scaleset_fused`
      (``bounds``, ``m``, ``backend``, ``precision``, ``tuning`` are
      its);
    * ``"dense"`` / ``"tiled"``, and ``"auto"`` otherwise: per band the
      voxel downsample (``voxel_downsample``; edge 0 keeps the raw
      cloud), then the tiled method at ``TILED_THRESHOLD`` or more
      voxels (``"auto"``) or always (``"tiled"``: the host plan with
      ``tuning``'s ``query_tile_factor`` 3, ``query_capacity``,
      ``entry_batch`` 256, ``precision``), else the dense method
      (queries sorted by voxel address with ``sort_queries``, padded to
      chunks of ``chunk_size`` rows, shrunk to ``PAIRS_BUDGET``).

    A configuration the fused path refuses raises; it never falls back
    to another method.  Returns an (n_query, width) float32 tensor;
    with ``with_stats`` also the overflow counters
    (:func:`extract_scaleset_fused`'s; zeros on the dense and tiled
    methods, which have no capacities).
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if kind == "vector" and attributes is None:
        raise ValueError("kind='vector' requires attributes")
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    chunk_size = _pow2_bucket(chunk_size, minimum=64)
    tuning = tuning or {}
    search = np.asarray(search, dtype=np.float32)[:, :3]
    if method == "fused" or (
            method == "auto" and search.shape[0] >= TILED_THRESHOLD
            and all(float(edge) > 0 for edge, _ in scaleset)):
        return extract_scaleset_fused(
            query, search, scaleset, kind, attributes=attributes,
            exclude_radius=exclude_radius, bounds=bounds, m=m,
            backend=backend, precision=precision, tuning=tuning,
            with_stats=with_stats, device=device)

    query = np.asarray(query, dtype=np.float32)[:, :3]
    if kind == "vector":
        attributes = check_attributes(attributes, search.shape[0])
    n_query = query.shape[0]
    scaleset = [(float(edge), tuple(float(r) for r in radii))
                for edge, radii in scaleset]
    # the tiled method groups queries by tile itself; the voxel-address
    # sort only helps the dense method's chunk locality
    if method == "tiled" or (method == "auto"
                             and search.shape[0] >= TILED_THRESHOLD):
        sort_queries = False
    order = None
    if sort_queries and n_query > 1:
        finest = min(edge for edge, _ in scaleset if edge > 0) \
            if any(edge > 0 for edge, _ in scaleset) \
            else min(min(radii) for _, radii in scaleset)
        vf = VoxelFilter(query.astype(np.float64), max(finest, 1e-6))
        order = np.argsort(vf.coordinate_to_address(
            query.astype(np.float64)), kind="stable")
        query = query[order]
    q_bucket = max(-(-n_query // chunk_size) * chunk_size, chunk_size)
    query_padded = torch.from_numpy(_pad_rows_f32(query, q_bucket)).to(device)
    features = torch.cat([
        _band_features(query_padded, n_query, search, kind, edge, radii,
                       attributes, exclude_radius, chunk_size, method,
                       tuning, bounds=bounds, device=device)
        for edge, radii in scaleset], dim=1)
    if order is not None:
        inverse = np.empty_like(order)
        inverse[order] = np.arange(n_query)
        features = features[torch.from_numpy(inverse).to(device)]
    if not with_stats:
        return features
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return features, dict.fromkeys(("dropped_query", "dropped_candidates",
                                    "dropped_search", "interp_dropped"),
                                   zero)


def extract_scaleset(query, search, scaleset, kind="geometric", **kwargs):
    """As :func:`extract_scaleset_device` (the same arguments), as an
    (n_query, width) float32 NumPy array."""
    return extract_scaleset_device(query, search, scaleset, kind,
                                   **kwargs).cpu().numpy()
