"""
Dense masked moment accumulation (port of ``nimrud_tpu/ops/moments.py``):
the O(|query| x |search|) path of the dense extraction method.

Per query chunk and radius, the ball mask times the augmented search
rows ``[1, s, s (x) s]`` gives count, first and second moments; the
sums are taken about the chunk's midpoint so f32 never squares large
absolute coordinates.  Distances come from the raw global coordinates,
``d2 = dx*dx + dy*dy + dz*dz`` one operation at a time (the reference's
partition-invariant form), compared against ``f32(r*r)``.  The moment
product is a plain float32 matrix product (TF32 off, see the package's
``__init__``): it is no TPU kernel in the reference either.
"""

import torch

from nimrud_tpu_torch.ops.kernels.multiscale_kernel import (
    exclusion_threshold, squared_radii)

SAZO_BIG = 1e30      # the sazo reductions' sentinels, as the reference's


def _augment(points, attributes=None):
    """[1, x, y, z, xx, xy, xz, yy, yz, zz] (+ attribute columns)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    aug = torch.stack([torch.ones_like(x), x, y, z,
                       x * x, x * y, x * z, y * y, y * z, z * z], dim=-1)
    if attributes is not None:
        aug = torch.cat([aug, attributes], dim=-1)
    return aug


def ball_stats(mom, in_ball, dz=None):
    """Per-radius statistics from a moment sum ``mom`` (..., Q, 10 + A)
    (the local frame's count, first and second moments, attribute sums)
    and its ball mask: ``count``, ``mean_local``, ``cov`` (the central
    second moment, packed), ``attr_mean``; with ``dz`` (..., Q, S), the
    signed z offsets of the pairs, also ``sazo``: the masked extreme of
    larger magnitude (the maximum on a tie), 0 for an empty ball."""
    count = mom[..., 0]
    denom = torch.clamp(count, min=1.0)[..., None]
    mean_local = mom[..., 1:4] / denom
    mx, my, mz = mean_local.unbind(-1)
    outer = torch.stack(
        [mx * mx, mx * my, mx * mz, my * my, my * mz, mz * mz], dim=-1)
    stats = {"count": count, "mean_local": mean_local,
             "cov": mom[..., 4:10] / denom - outer,
             "attr_mean": mom[..., 10:] / denom}
    if dz is not None:
        big = torch.tensor(SAZO_BIG, dtype=dz.dtype, device=dz.device)
        top = torch.where(in_ball, dz, -big).amax(-1)
        bot = torch.where(in_ball, dz, big).amin(-1)
        stats["sazo"] = torch.where(
            count > 0, torch.where(top >= -bot, top, bot),
            torch.zeros_like(top))
    return stats


def distance2(query, search, metric):
    """(..., Q, S) squared distances of (..., Q, 3) queries to (..., S, 3)
    candidates: euclidean ``dx*dx + dy*dy + dz*dz`` one operation at a
    time, or the square of the chebyshev ``max |d|`` (NaN-propagating,
    as ``jnp.maximum``)."""
    if metric == "euclidean":
        d2 = None
        for axis in range(3):
            # in place: the same rounded operations, a third of the
            # (..., Q, S) temporaries
            diff = query[..., :, None, axis] - search[..., None, :, axis]
            diff.mul_(diff)
            d2 = diff if d2 is None else d2.add_(diff)
        return d2
    if metric == "chebyshev":
        d = None
        for axis in range(3):
            a = (query[..., :, None, axis] - search[..., None, :, axis]).abs()
            d = a if d is None else torch.maximum(d, a)
        return d * d
    raise ValueError(f"unknown metric {metric!r}")


def chunk_moments(query_chunk, search, search_valid, radii,
                  attributes=None, exclude_radius=None,
                  metric="euclidean", with_sazo=False):
    """
    Moments of every search neighborhood of one query chunk, per radius.

    Args:
      query_chunk:  (Q, 3) float32.
      search:       (S, 3) float32 (padded rows allowed).
      search_valid: (S,) bool.
      radii:        the band's radii (any order).
      attributes:   optional (S, A) float32 attribute columns (their
                    masked means: the vector layout, the interp).
      exclude_radius: leave out the pairs with ``d2 < f32(e*e)``.
      metric:       "euclidean" or "chebyshev" (the max-norm ball of the
                    attribute interp).
      with_sazo:    also the signed max z offset.

    Returns a dict of (Q, R, ...) tensors: ``count`` (Q, R), ``mean``
    (Q, R, 3) in the global frame, ``cov`` (Q, R, 6), ``attr_mean``
    (Q, R, A) with attributes, ``sazo`` (Q, R) with ``with_sazo``.
    """
    center = (query_chunk.amax(0) + query_chunk.amin(0)) * 0.5
    s = search - center
    # distances and sazo offsets from the raw global coordinates: the
    # same pair gets the same d2 in every chunk
    d2 = distance2(query_chunk, search, metric)
    base = search_valid[None, :]
    if exclude_radius is not None:
        base = base & (d2 >= exclusion_threshold(exclude_radius))
    aug = _augment(s, attributes)
    dz = search[None, :, 2] - query_chunk[:, None, 2] if with_sazo else None

    per_radius = []
    for r2 in squared_radii(radii):
        in_ball = base & (d2 <= float(r2))
        mom = in_ball.to(torch.float32) @ aug
        per_radius.append(ball_stats(mom, in_ball, dz))
    out = {"count": torch.stack([p["count"] for p in per_radius], 1),
           "mean": torch.stack([p["mean_local"] + center
                                for p in per_radius], 1),
           "cov": torch.stack([p["cov"] for p in per_radius], 1)}
    if attributes is not None:
        out["attr_mean"] = torch.stack([p["attr_mean"]
                                        for p in per_radius], 1)
    if with_sazo:
        out["sazo"] = torch.stack([p["sazo"] for p in per_radius], 1)
    return out


def multiscale_moments(query, search, search_valid, radii, *,
                       attributes=None, chunk_size=256,
                       exclude_radius=None, metric="euclidean",
                       with_sazo=False):
    """
    :func:`chunk_moments` over the whole query set, one chunk of
    ``chunk_size`` rows at a time (the reference's ``lax.map``), on the
    tensors' device.  ``query`` rows must be a multiple of
    ``chunk_size`` (callers pad); chunks should be spatially coherent
    (voxel-key sorted) for f32 accuracy.
    """
    if query.shape[0] % chunk_size:
        raise ValueError(
            f"query rows ({query.shape[0]}) must be a multiple of "
            f"chunk_size ({chunk_size}); pad first")
    radii = tuple(float(r) for r in radii)
    parts = [chunk_moments(query[lo:lo + chunk_size], search, search_valid,
                           radii, attributes=attributes,
                           exclude_radius=exclude_radius, metric=metric,
                           with_sazo=with_sazo)
             for lo in range(0, query.shape[0], chunk_size)]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
