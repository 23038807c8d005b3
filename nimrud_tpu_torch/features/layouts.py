"""
Feature layouts on tensors (port of ``nimrud_tpu/features/layouts.py``):
neighborhood statistics (count, mean, central second moment) -> one
per-scale feature block.  Degenerate neighborhoods give zeros.

Ported: ``minimal`` [population, centroid displacement, eig1, eig2]
(eig1 >= eig2 the two largest covariance eigenvalues normalized to sum
1).  The other kinds raise ``NotImplementedError`` (ROADMAP.md).
"""

import math

import torch

from nimrud_tpu_torch.ops.eigen import eigvalsh3

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


def build_block(kind, count, mean, cov, query, radius):
    """Dispatch on layout kind (``minimal`` only in this port)."""
    if kind == "minimal":
        return minimal_block(count, mean, cov, query)
    if kind in LAYOUT_WIDTHS or kind == "vector":
        raise NotImplementedError(
            f"feature layout {kind!r} is not ported yet (ROADMAP.md "
            "Queue A #9)")
    raise ValueError(f"unknown feature layout {kind!r}")
