"""
Closed-form eigendecomposition of batched symmetric 3x3 matrices (port
of ``nimrud_tpu/ops/eigen.py``): the trigonometric solution (Smith
1961) for the eigenvalues, branch-light and iteration-free, and each
eigenvector from the largest cross product of two rows of
``A - lambda I``, with the reference's degenerate fallbacks.

Matrices are packed as 6-vectors ``[xx, xy, xz, yy, yz, zz]`` (upper
triangle, row-major), the layout the moment slabs emit.
"""

import math

import torch


def eigvalsh3(m6):
    """
    Eigenvalues of symmetric 3x3 matrices, **descending**.

    Args:
      m6: (..., 6) packed [xx, xy, xz, yy, yz, zz].

    Returns:
      (..., 3) eigenvalues, largest first.
    """
    xx, xy, xz, yy, yz, zz = m6.unbind(-1)

    q = (xx + yy + zz) / 3.0
    dxx, dyy, dzz = xx - q, yy - q, zz - q
    off = xy * xy + xz * xz + yz * yz
    p2 = dxx * dxx + dyy * dyy + dzz * dzz + 2.0 * off
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))

    # guard the p == 0 case (scalar matrix): all eigenvalues equal q
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    bxx, byy, bzz = dxx / safe_p, dyy / safe_p, dzz / safe_p
    bxy, bxz, byz = xy / safe_p, xz / safe_p, yz / safe_p
    half_det = 0.5 * (
        bxx * (byy * bzz - byz * byz)
        - bxy * (bxy * bzz - byz * bxz)
        + bxz * (bxy * byz - byy * bxz))
    half_det = torch.clamp(half_det, -1.0, 1.0)

    phi = torch.arccos(half_det) / 3.0
    two_p = 2.0 * p
    big = q + two_p * torch.cos(phi)
    small = q + two_p * torch.cos(phi + 2.0 * math.pi / 3.0)
    mid = 3.0 * q - big - small

    eigs = torch.stack([big, mid, small], dim=-1)
    return torch.where(p2[..., None] > 0, eigs,
                       torch.stack([q, q, q], dim=-1))


def _cross(a, b):
    """Cross product over the last axis, in ``jnp.cross``'s order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _eigvec_for(m6, lam):
    """
    One unit eigenvector of each packed matrix for eigenvalue ``lam``:
    the largest cross product of two rows of (A - lam*I).  Degenerate
    inputs (repeated eigenvalue, zero matrix) fall back to the z axis.
    The sign is arbitrary; it follows the branch taken (``n01 >= n02``,
    then ``>= n12``), as in the reference.
    """
    xx, xy, xz, yy, yz, zz = m6.unbind(-1)
    r0 = torch.stack([xx - lam, xy, xz], dim=-1)
    r1 = torch.stack([xy, yy - lam, yz], dim=-1)
    r2 = torch.stack([xz, yz, zz - lam], dim=-1)

    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = (c01 * c01).sum(-1, keepdim=True)
    n02 = (c02 * c02).sum(-1, keepdim=True)
    n12 = (c12 * c12).sum(-1, keepdim=True)

    best = torch.where(n01 >= n02, c01, c02)
    best_n = torch.maximum(n01, n02)
    best = torch.where(best_n >= n12, best, c12)
    best_n = torch.maximum(best_n, n12)

    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    scale = m6.abs().amax(-1, keepdim=True) + lam.abs()[..., None]
    degenerate = best_n <= (1e-12 * scale * scale) ** 2
    vec = torch.where(degenerate, fallback, best)
    norm = torch.sqrt((vec * vec).sum(-1, keepdim=True))
    return vec / torch.clamp(norm, min=1e-30)


def eigh3(m6):
    """
    Eigenvalues (descending) and matching unit eigenvectors of packed
    symmetric 3x3 matrices.

    Returns ``(values, vectors)``: values (..., 3) descending, vectors
    (..., 3, 3) with ``vectors[..., i, :]`` belonging to
    ``values[..., i]``.  Signs are arbitrary.  The middle vector is the
    cross product of the smallest and the largest, so the basis stays
    right-handed; where that product vanishes (a sphere) it falls back
    to the y axis.
    """
    vals = eigvalsh3(m6)
    v_big = _eigvec_for(m6, vals[..., 0])
    v_small = _eigvec_for(m6, vals[..., 2])
    v_mid = _cross(v_small, v_big)
    norm = torch.sqrt((v_mid * v_mid).sum(-1, keepdim=True))
    y_axis = torch.zeros_like(v_mid)
    y_axis[..., 1] = 1.0
    v_mid = torch.where(norm > 1e-12, v_mid / torch.clamp(norm, min=1e-30),
                        y_axis)
    return vals, torch.stack([v_big, v_mid, v_small], dim=-2)


def pack_sym3(matrices):
    """(..., 3, 3) symmetric matrices -> (..., 6) packed upper triangle."""
    return torch.stack([
        matrices[..., 0, 0], matrices[..., 0, 1], matrices[..., 0, 2],
        matrices[..., 1, 1], matrices[..., 1, 2], matrices[..., 2, 2],
    ], dim=-1)


def unpack_sym3(m6):
    """(..., 6) packed upper triangle -> (..., 3, 3) symmetric matrices."""
    xx, xy, xz, yy, yz, zz = m6.unbind(-1)
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)
