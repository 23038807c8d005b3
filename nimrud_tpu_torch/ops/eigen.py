"""
Closed-form eigenvalues of batched symmetric 3x3 matrices (port of
``nimrud_tpu/ops/eigen.py:eigvalsh3``): the trigonometric solution
(Smith 1961), branch-light and iteration-free.

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
