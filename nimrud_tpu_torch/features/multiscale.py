"""
Multiscale feature extraction of the port (the packed and span
branches of ``nimrud_tpu/features/multiscale.py:extract_scaleset_fused``,
its public entry points ``extract_scaleset_device`` / ``extract_scaleset``
on that fused path, plus the host helpers they need, copied:
``_pow2_bucket``, ``_pad_rows_f32``, ``_host_unique_voxels`` (on the
C++ host runtime, ``ops.native``), ``_voxel_occupancy_cap`` and
``_interp_packed_plan``).

For each band ``(voxel_edge, radii)`` the search cloud is
voxel-downsampled on the device and every query's neighborhood moments
come from the packed-candidate or the span kernel; bands concatenate
left to right.  The ``vector`` layout (V_MSO) first interpolates the
search points' attributes onto the voxel centers (the packed attribute
interp, ``ops.interp.packed_interp``) and then serves the masked means
of those center attributes over each radius.
"""

import numpy as np
import torch

from nimrud_tpu_torch.ops import (device_grid, interp, native, packing,
                                  span_host, unique)
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import MAX_ATTR

TILED_THRESHOLD = 16384   # search points from which the reference's
                          # method="auto" takes the fused path
METHODS = ("auto", "dense", "tiled", "fused")

# the reference's precision names -> the kernels' precision: "mixed" and
# "high" (XLA matmul precisions) map onto the bf16 split, "default" onto
# the f32 sums (``features/multiscale.py:461-466`` there)
KERNEL_PRECISION = {"highest": "highest", "default": "highest",
                    "bf16x2": "bf16x2", "mixed": "bf16x2", "high": "bf16x2"}


def kernel_precision(precision):
    """The moment kernels' precision for one of the reference's names."""
    if precision not in KERNEL_PRECISION:
        raise ValueError(f"precision must be one of "
                         f"{tuple(KERNEL_PRECISION)}, got {precision!r}")
    return KERNEL_PRECISION[precision]


def check_attributes(attributes, n_search):
    """(n_search, A) float32 attributes the packed kernel can carry (at
    most ``MAX_ATTR`` columns; wider blocks take the reference's gather
    interp and XLA path, which the port does not carry)."""
    attributes = np.asarray(attributes, dtype=np.float32)
    if attributes.ndim != 2 or attributes.shape[0] != n_search:
        raise ValueError(f"attributes must be ({n_search}, A), got "
                         f"{attributes.shape}")
    if not 1 <= attributes.shape[1] <= MAX_ATTR:
        raise NotImplementedError(
            f"{attributes.shape[1]} attribute columns: the packed kernel "
            f"carries 1..{MAX_ATTR}; wider blocks take the reference's "
            "gather interp and XLA path (ROADMAP.md Queue A #6, the XLA "
            "fallback and reference-parity paths)")
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
                        host_centers=None):
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
    overflow into the counted ``interp_dropped``."""
    edge = float(vox_spec.edge_length)
    search = np.asarray(search, np.float32)[:, :3]
    if host_centers is None:
        host_centers = _host_unique_voxels(search, edge, bounds=s_bounds)
    occ = _voxel_occupancy_cap(search, vox_spec)
    ispec = device_grid.make_spec(
        lo, hi, edge, n_query=_pow2_bucket(search.shape[0]), q_cap=128,
        m=m, x_seg=1, s_cap=_pow2_bucket(8 * occ, minimum=8))
    ispec = device_grid.with_entry_estimate(ispec, host_centers)
    icap = span_host.candidate_caps_split(host_centers, search, ispec)
    return ispec, icap if isinstance(icap, tuple) else int(icap)


def extract_scaleset_fused(query, search, scaleset, kind="minimal", *,
                           attributes=None, exclude_radius=None,
                           bounds=None, m=3, backend="packed",
                           precision="highest", with_stats=False,
                           device="cuda"):
    """
    Multiscale features for every query point, on ``device`` (the card
    unless the caller asks for the CPU): per band a device voxel
    downsample and one fused extraction (``q_cap`` 256, segments of 32
    coarse tiles, entry capacity from the measured occupancy).
    ``backend="packed"`` packs candidate blocks at a capacity sized on
    the host (``packed_moments``); ``"pallas"`` reads the candidate
    spans in place (``span_moments``), with no candidate cap.
    ``kind``: ``minimal``, ``geometric``, ``oriented``, ``covariance``,
    ``eigen``, ``sazo`` or ``vector`` (packed only: the span path raises
    for the last two).  ``vector`` needs ``attributes`` (rows aligned
    with ``search``, 1..6 columns): per band the packed attribute interp
    (q_cap 128 on a voxel-edge grid, chebyshev ball of one edge) puts
    them on the voxel centers, and the features are their means over
    each radius, A columns a radius.  ``precision``: the reference's
    names (``kernel_precision``), for the extraction's kernel; the
    interp sums at "highest", as the reference's does.
    ``exclude_radius``: leave out the search points closer than this to
    the query (the reference's legacy self-exclusion: pairs with
    ``d2 < f32(e*e)``), in the extraction's kernel of either backend;
    the ``vector`` interp takes no exclusion, as in the reference.

    ``bounds``: fixed site (lo, hi) governing every grid; default the
    clouds' own bounds, with voxel grids anchored at the search bounds.
    Returns an (n_query, width) float32 tensor; with ``with_stats`` also
    the overflow counters summed over the bands, as device scalars:
    ``dropped_query`` (queries without an entry slot),
    ``dropped_candidates`` (candidates past the packed capacity) and
    ``interp_dropped`` (the ``vector`` interp's under-reads).
    """
    if backend == "xla":
        raise NotImplementedError(
            "the XLA candidate-table backend is not ported (ROADMAP.md "
            "Queue A #6, the XLA fallback and reference-parity paths)")
    if backend not in ("packed", "pallas"):
        raise ValueError(f"unknown backend {backend!r}: must be 'packed' "
                         "or 'pallas'")
    prec = kernel_precision(precision)
    query = np.asarray(query, dtype=np.float32)[:, :3]
    search = np.asarray(search, dtype=np.float32)[:, :3]
    if kind == "vector":
        if attributes is None:
            raise ValueError("kind='vector' requires attributes")
        attributes = check_attributes(attributes, search.shape[0])
        if backend == "pallas":
            raise NotImplementedError(
                "kind='vector' with backend='pallas': the span kernel has "
                "no attribute rows and the reference's XLA path is not "
                "ported (ROADMAP.md Queue A #6, the XLA fallback and "
                "reference-parity paths)")
    scaleset = [(float(edge), tuple(float(r) for r in radii))
                for edge, radii in scaleset]
    if any(edge <= 0 for edge, _ in scaleset):
        raise ValueError("the packed path requires voxel edges > 0")

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
                           "interp_dropped"), zero)

    def count(band_stats):
        for key, value in band_stats.items():
            stats[key] = stats[key] + value

    bands = []
    for edge, radii in scaleset:
        vox_spec = packing.GridSpec.fit_bounds(s_lo, s_hi, edge)
        center_attrs = None
        if kind == "vector":
            ispec, icap = _interp_packed_plan(search, vox_spec, lo, hi,
                                              (s_lo, s_hi), m)
            centers, center_mask, center_attrs, istats = \
                interp.packed_interp(search_dev, s_valid, attrs_dev,
                                     vox_spec, ispec, icap, with_stats=True)
            count({"interp_dropped": istats["dropped_search"]})
        else:
            centers, _, center_mask = unique.unique_voxels(
                search_dev, vox_spec, valid=s_valid)
        spec = device_grid.make_spec(
            lo, hi, max(radii), n_query=q_bucket, m=m, q_cap=256,
            voxel_edge=edge, entry_batch=256, x_seg=32)
        spec = device_grid.with_entry_estimate(spec, query)
        if backend == "pallas":
            feats, band_stats = device_grid.fused_extract_spans(
                query_dev, q_valid, centers, center_mask, spec, radii, kind,
                n_query, with_stats=True, precision=prec,
                exclude_radius=exclude_radius)
        else:
            cap = span_host.candidate_cap(
                query, _host_unique_voxels(search, edge, bounds=bounds),
                spec)
            feats, band_stats = device_grid.fused_extract_packed(
                query_dev, q_valid, centers, center_mask, spec, radii, kind,
                n_query, int(cap), with_stats=True, precision=prec,
                attributes=center_attrs, exclude_radius=exclude_radius)
        count(band_stats)
        bands.append(feats)
    features = torch.cat(bands, dim=1)
    return (features, stats) if with_stats else features


def extract_scaleset_device(query, search, scaleset, kind="geometric", *,
                            attributes=None, exclude_radius=None,
                            method="auto", bounds=None, m=3,
                            backend="packed", precision="highest",
                            device="cuda"):
    """
    The reference's public extraction entry point, on the port's one
    path: :func:`extract_scaleset_fused` (the other arguments are its).
    ``method="fused"`` takes it; ``"auto"`` takes it where the reference
    does (every band voxel-downsampled and at least ``TILED_THRESHOLD``
    search points).  What the reference computes otherwise -- the dense
    and tiled methods, and bands of voxel edge 0 -- is not ported: those
    raise ``NotImplementedError``, they never fall back.  Returns an
    (n_query, width) float32 tensor on ``device``.
    """
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    unported = "(ROADMAP.md Queue A #6, the XLA fallback and " \
        "reference-parity paths)"
    if any(float(edge) <= 0 for edge, _ in scaleset):
        raise NotImplementedError(
            f"bands of voxel edge 0 are not ported {unported}")
    if method in ("dense", "tiled") or (
            method == "auto"
            and np.asarray(search).shape[0] < TILED_THRESHOLD):
        raise NotImplementedError(
            f"method={method!r} on {np.asarray(search).shape[0]} search "
            f"points takes the reference's dense or tiled extraction, "
            f"which is not ported {unported}")
    return extract_scaleset_fused(
        query, search, scaleset, kind, attributes=attributes,
        exclude_radius=exclude_radius, bounds=bounds, m=m, backend=backend,
        precision=precision, device=device)


def extract_scaleset(query, search, scaleset, kind="geometric", **kwargs):
    """As :func:`extract_scaleset_device` (the same arguments), as an
    (n_query, width) float32 NumPy array."""
    return extract_scaleset_device(query, search, scaleset, kind,
                                   **kwargs).cpu().numpy()
