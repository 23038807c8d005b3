"""
Feature layouts on tensors (port of ``nimrud_tpu/features/layouts.py``):
neighborhood statistics (count, mean, central second moment) -> one
per-scale feature block.  Degenerate neighborhoods give zeros.

Layouts (columns per scale):
  minimal     [population, centroid, eig1, eig2]
  geometric   [density, centroid, eig1, eig2]              (G_MSO)
  oriented    [density, centroid, eig_s0, eig_s1, v0x, v0y, v1x, v1y]
                                                           (OG_MSO)
  covariance  [density, centroid, sxx, sxy, sxz, syy, syz, szz]  (C_MSO)
  eigen       [density, centroid, linearity, planarity, scattering,
               omnivariance, anisotropy, eigenentropy, trace,
               change of curvature]
  sazo        [density, centroid, eig1, eig2, sazo]

eig1 >= eig2 are the two largest covariance eigenvalues normalized to
sum 1, eig_s0 <= eig_s1 the two smallest, v0 / v1 their eigenvectors
(signs arbitrary); density is points per cm^3 of the sphere.  The
``vector`` layout (V_MSO, [attr_mean x A] per scale) is not built here:
the extraction hands the kernel's attribute means on as they are
(``device_grid._band_blocks``), as the reference does.
"""

import math

import torch

from nimrud_tpu_torch.ops.eigen import eigh3, eigvalsh3

# the reference reports densities in points per cm^3
CM3_PER_M3 = 1.0e6

LAYOUT_WIDTHS = {
    "minimal": 4,
    "geometric": 4,
    "oriented": 8,
    "covariance": 8,
    "eigen": 10,
    "sazo": 5,
}


def needs_sazo(kind):
    """Whether this layout requires the signed-max-z-offset statistic."""
    return kind == "sazo"


def _centroid_displacement(count, mean, query):
    """|query - neighborhood mean|; zero for empty neighborhoods."""
    delta = mean - query
    norm = torch.sqrt((delta * delta).sum(-1))
    return torch.where(count > 0, norm, torch.zeros_like(norm))


def _normalized_eigs(count, cov):
    """Covariance eigenvalues normalized to sum to one, descending;
    zeros for fewer than two points or zero total variance."""
    vals = eigvalsh3(cov)
    trace = cov[..., 0] + cov[..., 3] + cov[..., 5]
    ok = (count >= 2) & (trace > 0)
    safe = torch.where(trace > 0, trace, torch.ones_like(trace))
    return torch.where(ok[..., None], vals / safe[..., None],
                       torch.zeros_like(vals))


def sphere_density(count, radius):
    """Points per cubic centimeter of the spherical neighborhood."""
    volume = CM3_PER_M3 * (4.0 / 3.0) * math.pi * radius ** 3
    return count / volume


def minimal_block(count, mean, cov, query):
    """(N,) (N,3) (N,6) (N,3) -> (N, 4) [population, centroid, eig1, eig2]."""
    eigs = _normalized_eigs(count, cov)
    return torch.stack([
        count,
        _centroid_displacement(count, mean, query),
        eigs[..., 0],
        eigs[..., 1],
    ], dim=-1)


def geometric_block(count, mean, cov, query, radius):
    """G_MSO: [density, centroid, eig1, eig2]."""
    eigs = _normalized_eigs(count, cov)
    return torch.stack([
        sphere_density(count, radius),
        _centroid_displacement(count, mean, query),
        eigs[..., 0],
        eigs[..., 1],
    ], dim=-1)


def oriented_block(count, mean, cov, query, radius):
    """OG_MSO: [density, centroid, smallest two normalized eigenvalues
    (ascending), xy components of their eigenvectors]."""
    vals, vecs = eigh3(cov)                     # descending
    trace = cov[..., 0] + cov[..., 3] + cov[..., 5]
    ok = (count >= 2) & (trace > 0)
    safe = torch.where(trace > 0, trace, torch.ones_like(trace))
    norm_vals = torch.where(ok[..., None], vals / safe[..., None],
                            torch.zeros_like(vals))
    vec_ok = torch.where(ok[..., None, None], vecs, torch.zeros_like(vecs))
    return torch.stack([
        sphere_density(count, radius),
        _centroid_displacement(count, mean, query),
        norm_vals[..., 2],                      # smallest
        norm_vals[..., 1],                      # middle
        vec_ok[..., 2, 0], vec_ok[..., 2, 1],   # smallest eigvec x, y
        vec_ok[..., 1, 0], vec_ok[..., 1, 1],   # middle eigvec x, y
    ], dim=-1)


def eigen_block(count, mean, cov, query, radius):
    """The eigenvalue features of l1 >= l2 >= l3 (unnormalized): density,
    centroid, linearity (l1-l2)/l1, planarity (l2-l3)/l1, scattering
    l3/l1, omnivariance cbrt(l1 l2 l3) / trace, anisotropy (l1-l3)/l1,
    eigenentropy -sum(p log p) of p = l / trace clipped to [1e-12, 1],
    the trace, change of curvature l3 / trace.  Rows with fewer than two
    points, zero trace or l1 <= 0 are zeros past the centroid.  The cube
    root is ``pow(x, 1/3)`` of the product clipped at 0 (torch has no
    cbrt): it may differ from the reference's ``cbrt`` in the last bit."""
    vals = eigvalsh3(cov)
    l1, l2, l3 = vals.unbind(-1)
    trace = cov[..., 0] + cov[..., 3] + cov[..., 5]
    ok = (count >= 2) & (trace > 0) & (l1 > 0)
    safe_l1 = torch.where(l1 > 0, l1, torch.ones_like(l1))
    safe_trace = torch.where(trace > 0, trace, torch.ones_like(trace))

    p = torch.clamp(vals / safe_trace[..., None], 1e-12, 1.0)
    eigenentropy = -(p * torch.log(p)).sum(-1)
    omnivariance = torch.pow(torch.clamp(l1 * l2 * l3, min=0.0),
                             1.0 / 3.0) / safe_trace

    def gate(value):
        return torch.where(ok, value, torch.zeros_like(value))

    return torch.stack([
        sphere_density(count, radius),
        _centroid_displacement(count, mean, query),
        gate((l1 - l2) / safe_l1),            # linearity
        gate((l2 - l3) / safe_l1),            # planarity
        gate(l3 / safe_l1),                   # scattering
        gate(omnivariance),
        gate((l1 - l3) / safe_l1),            # anisotropy
        gate(eigenentropy),
        gate(trace),                          # sum of eigenvalues
        gate(l3 / safe_trace),                # change of curvature
    ], dim=-1)


def covariance_block(count, mean, cov, query, radius):
    """C_MSO: [density, centroid, scatter-matrix upper triangle]."""
    return torch.cat([
        torch.stack([sphere_density(count, radius),
                     _centroid_displacement(count, mean, query)], dim=-1),
        cov * count[..., None],
    ], dim=-1)


def sazo_block(count, mean, cov, query, radius, sazo):
    """G_MSO with the signed z offset of the neighborhood point farthest
    from the query in z: [density, centroid, eig1, eig2, sazo] (zero for
    empty neighborhoods, as ``moments_from_slabs`` gives it)."""
    return torch.cat([geometric_block(count, mean, cov, query, radius),
                      sazo[..., None]], dim=-1)


RECONCILE_GAP = 1e-3     # normalized eigenvalue gap (and |l3| / trace)
                         # below which rounding may move a column anywhere


def reconcile(kind, feats, ref, gap=RECONCILE_GAP):
    """
    ``feats`` with the columns the layout leaves to rounding or to an
    arbitrary choice taken as ``ref`` has them: two (N, n_scales *
    width) feature blocks of the same points, from two evaluations that
    sum in different orders.

    * ``oriented``: an eigenvector's (x, y) pair is negated where its
      sign is the other of ``ref``'s (eigenvector signs are arbitrary),
      and taken from ``ref`` where its eigenvalue lies within ``gap`` of
      another in ``ref`` (normalized eigenvalues): there rounding may
      turn the vector anywhere.  The smallest vector's gap is
      ``eig_s1 - eig_s0``; the middle vector, the cross product of the
      smallest and the largest, has the smaller of that and
      ``1 - eig_s0 - 2 eig_s1``.
    * ``eigen``: the shape columns (linearity .. curvature) are taken
      from ``ref`` where ``ref``'s ``l3 / trace`` is within ``gap`` of 0:
      the smallest eigenvalues are then rounding noise of the covariance,
      which the ratios, the entropy and the cube root magnify.
    * other layouts have no such columns.

    Returns ``(reconciled, flipped, taken)``: the block and two (N,) bool
    masks, the rows where a sign was turned and where a column was taken
    from ``ref`` with another value.
    """
    out = feats.clone()
    flipped = torch.zeros(feats.shape[0], dtype=torch.bool,
                          device=feats.device)
    taken = flipped.clone()
    width = LAYOUT_WIDTHS[kind]
    for base in range(0, feats.shape[1], width):
        if kind == "oriented":
            s0, s1 = ref[:, base + 2], ref[:, base + 3]
            gaps = (s1 - s0, torch.minimum(s1 - s0, (1.0 - s0 - s1) - s1))
            for col, g in zip((4, 6), gaps):
                c = slice(base + col, base + col + 2)
                mine, theirs = out[:, c], ref[:, c]
                loose = g < gap
                turn = ~loose & ((mine + theirs).abs().amax(1)
                                 < (mine - theirs).abs().amax(1))
                taken |= loose & (mine != theirs).any(1)
                flipped |= turn
                out[:, c] = torch.where(loose[:, None], theirs,
                                        torch.where(turn[:, None], -mine,
                                                    mine))
        elif kind == "eigen":
            c = slice(base + 2, base + width)
            loose = ref[:, base + 9].abs() < gap
            taken |= loose & (out[:, c] != ref[:, c]).any(1)
            out[:, c] = torch.where(loose[:, None], ref[:, c], out[:, c])
    return out, flipped, taken


def build_block(kind, count, mean, cov, query, radius, sazo=None):
    """Dispatch on layout kind for the geometry layouts."""
    if kind == "minimal":
        return minimal_block(count, mean, cov, query)
    if kind == "geometric":
        return geometric_block(count, mean, cov, query, radius)
    if kind == "oriented":
        return oriented_block(count, mean, cov, query, radius)
    if kind == "covariance":
        return covariance_block(count, mean, cov, query, radius)
    if kind == "eigen":
        return eigen_block(count, mean, cov, query, radius)
    if kind == "sazo":
        if sazo is None:
            raise ValueError("kind='sazo' requires the sazo statistic")
        return sazo_block(count, mean, cov, query, radius, sazo)
    raise ValueError(f"unknown feature layout {kind!r}")
