"""
Attribute interpolation onto voxel centers through the packed-candidate
machinery (port of ``nimrud_tpu/ops/interp.py:packed_interp``).

The V_MSO ``vector`` layout averages per-point attributes over the
Chebyshev ball of radius = voxel edge around every voxel center.  Here
the queries are the band's voxel centers and the search cloud is the
raw cloud: one pack plan on a voxel-edge tile grid, and the masked mean
rides the attribute rows of the ``packed_moments`` kernel's chebyshev
instance.  Fit and serving both interpolate here, so fit features are
the served features.

Not ported (ROADMAP.md Queue A #6, the XLA fallback and reference-parity
paths): the gather interp ``interp_to_voxels`` and ``matmul_interp``
that the reference takes for more than 6 attribute columns.
"""

from nimrud_tpu_torch.ops import device_grid, unique


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
