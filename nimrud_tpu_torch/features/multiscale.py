"""
Multiscale feature extraction of the port (the packed and span
branches of ``nimrud_tpu/features/multiscale.py:extract_scaleset_fused``,
plus the host helpers they need, copied: ``_pow2_bucket``,
``_pad_rows_f32`` and the NumPy branch of ``_host_unique_voxels``).

For each band ``(voxel_edge, radii)`` the search cloud is
voxel-downsampled on the device and every query's neighborhood moments
come from the packed-candidate or the span kernel; bands concatenate
left to right.
"""

import numpy as np
import torch

from nimrud_tpu_torch.ops import device_grid, packing, span_host, unique


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


def _host_unique_voxels(search, edge, bounds=None):
    """Host voxel downsample -> float32 centers sorted by voxel address.

    ``bounds``: explicit (lo, hi) grid anchor (default: the search
    cloud's own bounds); fixed-bounds models pass theirs so fit-time
    voxelization matches the serving grid exactly."""
    s64 = search.astype(np.float64)
    if bounds is None:
        b_lo, b_hi = s64.min(0), s64.max(0)
    else:
        b_lo = np.asarray(bounds[0], np.float64)
        b_hi = np.asarray(bounds[1], np.float64)
    origin = b_lo - edge / 2
    span = (b_hi + edge / 2) - origin
    dims = np.maximum(np.ceil(span / edge).astype(np.int64), 1)
    cell = np.clip(np.floor((s64 - origin) / edge).astype(np.int64),
                   0, dims - 1)
    addr = (cell[:, 0] + cell[:, 1] * dims[0]
            + cell[:, 2] * dims[0] * dims[1])
    cell = np.unique(addr)
    cx = cell % dims[0]
    cy = (cell // dims[0]) % dims[1]
    cz = cell // (dims[0] * dims[1])
    return (origin[None, :] + (np.stack([cx, cy, cz], axis=1) + 0.5)
            * edge).astype(np.float32)


def extract_scaleset_fused(query, search, scaleset, kind="minimal", *,
                           bounds=None, m=3, backend="packed",
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
    ``eigen`` or ``sazo`` (packed only: the span path raises for it).

    ``bounds``: fixed site (lo, hi) governing every grid; default the
    clouds' own bounds, with voxel grids anchored at the search bounds.
    Returns an (n_query, width) float32 tensor.
    """
    if backend == "xla":
        raise NotImplementedError(
            "the XLA candidate-table backend is not ported (ROADMAP.md "
            "Queue A #11)")
    if backend not in ("packed", "pallas"):
        raise ValueError(f"unknown backend {backend!r}: must be 'packed' "
                         "or 'pallas'")
    query = np.asarray(query, dtype=np.float32)[:, :3]
    search = np.asarray(search, dtype=np.float32)[:, :3]
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

    bands = []
    for edge, radii in scaleset:
        vox_spec = packing.GridSpec.fit_bounds(s_lo, s_hi, edge)
        centers, _, center_mask = unique.unique_voxels(
            search_dev, vox_spec, valid=s_valid)
        spec = device_grid.make_spec(
            lo, hi, max(radii), n_query=q_bucket, m=m, q_cap=256,
            voxel_edge=edge, entry_batch=256, x_seg=32)
        spec = device_grid.with_entry_estimate(spec, query)
        if backend == "pallas":
            bands.append(device_grid.fused_extract_spans(
                query_dev, q_valid, centers, center_mask, spec, radii, kind,
                n_query))
            continue
        cap = span_host.candidate_cap(
            query, _host_unique_voxels(search, edge, bounds=bounds), spec)
        bands.append(device_grid.fused_extract_packed(
            query_dev, q_valid, centers, center_mask, spec, radii, kind,
            n_query, int(cap)))
    return torch.cat(bands, dim=1)
