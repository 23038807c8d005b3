"""
The ``minimal`` layout: ``[count, |mean - q|, l1 / trace, l2 / trace]``
a radius, with ``l1 >= l2`` the two largest eigenvalues of the
neighbourhood's population covariance; the eigenvalue columns are 0
below two points, the centroid column 0 for an empty neighbourhood.
"""

import torch

from perfbench.reference.features import tf32


def block(scene, band, centers, cells, queries, mask, precision, frame):
    """The band's ``minimal`` block (s, 4): :func:`moments_block`."""
    return moments_block(centers, queries, mask, precision, frame)


def moments_block(centers, queries, mask, precision="float64", frame=None):
    """``minimal`` block (s, 4) of the neighbourhoods ``mask`` selects
    among ``centers`` (s, w, 3) float32 around ``queries`` (s, 3).

    ``precision``: "float64" (the reference: offsets from the query,
    two-pass covariance), or "tf32" (the control: the offsets from
    ``frame`` (s, 3) float32, the masked sums as a TF32 product forms
    them -- operands rounded to TF32, float32 accumulation -- and the
    rest in float32)."""
    if precision == "float64":
        x = centers.to(torch.float64) - queries.to(torch.float64)[:, None]
        w = mask.to(torch.float64)
        count = w.sum(1)
        denom = count.clamp(min=1.0)[:, None]
        mean = (w[..., None] * x).sum(1) / denom
        centred = x - mean[:, None, :]
        cov = torch.einsum("swi,swj->sij", centred * w[..., None], centred) \
            / denom[..., None]
        shift = mean
    else:
        x = centers - frame[:, None, :]
        w = mask.to(torch.float32)
        xs, ys, zs = x.unbind(-1)
        terms = torch.stack([torch.ones_like(xs), xs, ys, zs, xs * xs,
                             xs * ys, xs * zs, ys * ys, ys * zs, zs * zs],
                            dim=-1)
        sums = torch.einsum("sw,swk->sk", w, tf32(terms))
        count = sums[:, 0]
        denom = count.clamp(min=1.0)[:, None]
        mean = sums[:, 1:4] / denom
        second = sums[:, 4:10] / denom
        mx, my, mz = mean.unbind(-1)
        packed = second - torch.stack([mx * mx, mx * my, mx * mz, my * my,
                                       my * mz, mz * mz], dim=-1)
        xx, xy, xz, yy, yz, zz = packed.unbind(-1)
        cov = torch.stack([torch.stack([xx, xy, xz], -1),
                           torch.stack([xy, yy, yz], -1),
                           torch.stack([xz, yz, zz], -1)], dim=-2)
        shift = mean - (queries - frame)
    # LAPACK on the host: cuSOLVER's batched 3 x 3 solver refuses large
    # batches
    eigs = torch.linalg.eigvalsh(cov.cpu()).to(cov.device).flip(-1)
    trace = cov.diagonal(dim1=-2, dim2=-1).sum(-1)
    ok = (count >= 2) & (trace > 0)
    safe = torch.where(trace > 0, trace, torch.ones_like(trace))
    norm = torch.where(ok[:, None], eigs / safe[:, None],
                       torch.zeros_like(eigs))
    centroid = torch.where(count > 0, torch.linalg.vector_norm(shift, dim=-1),
                           torch.zeros_like(count))
    return torch.stack([count, centroid, norm[:, 0], norm[:, 1]], dim=-1)
