"""
k-nearest-neighbor geometry features (port of
``nimrud_tpu/features/knn.py``).

The radius pipelines define neighborhoods by a metric ball; these by the
k nearest search points within a search horizon (the tiled design needs
one).  Layouts:

    "minimal": [k_effective, centroid_displacement, eig1, eig2]
    "eigen":   the full eigenvalue set of ``layouts.eigen_block`` (width
               10) with column 0 = k_effective in place of the density.

Implementation: ``ops.neighbors`` kNN retrieval, then a gather of the
neighbors, their moments relative to the query point and the
closed-form eigensolve, all on the device; the neighbor indices stay
there (the reference takes them through the host, which is no
contract).
"""

import numpy as np
import torch

from nimrud_tpu_torch.features import layouts
from nimrud_tpu_torch.ops import neighbors
from nimrud_tpu_torch.ops.eigen import eigvalsh3

KINDS = ("minimal", "eigen")


def knn_features(query, search, k, max_radius, kind="minimal",
                 device="cuda"):
    """
    Geometry features over each query point's k nearest neighbors, on
    ``device`` (the card unless the caller asks for the CPU).

    Args:
      query / search: (N, >=3) arrays (XYZ used).
      k: neighbors per query.
      max_radius: search horizon (every neighbor within it is seen).
      kind: "minimal" ([k_eff, centroid, eig1, eig2]) or "eigen" (the
            full eigenvalue feature set, k_eff in column 0).

    Returns (N, width) float32 NumPy.
    """
    if kind not in KINDS:
        raise ValueError(f"unsupported knn feature kind {kind!r}")
    query = np.asarray(query, dtype=np.float32)[:, :3]
    search = np.asarray(search, dtype=np.float32)[:, :3]
    got = neighbors.neighbor_search(query, search, k, max_radius, "knn",
                                    device)
    feats = knn_block(torch.as_tensor(query, device=device),
                      torch.as_tensor(search, device=device),
                      got["indices"], got["valid"], kind)
    return feats.cpu().numpy()


def knn_moments(query, search, idx, valid):
    """Count, mean offset from the query point and covariance (6 upper
    triangle terms) of each query's valid neighbors ``idx`` (-1 pads)."""
    n_search = search.shape[0]
    search_pad = torch.cat([search, search.new_zeros((1, 3))])
    pts = search_pad[torch.where(idx < 0, n_search, idx.to(torch.int64))]
    weight = valid[..., None].to(torch.float32)
    # neighborhood math relative to the query point for f32 health
    rel = (pts - query[:, None, :]) * weight
    count = valid.sum(1).to(torch.float32)
    denom = torch.clamp(count, min=1.0)
    mean_rel = rel.sum(1) / denom[:, None]
    centered = (rel - mean_rel[:, None, :]) * weight
    x, y, z = centered.unbind(-1)
    cov = torch.stack([(x * x).sum(1), (x * y).sum(1), (x * z).sum(1),
                       (y * y).sum(1), (y * z).sum(1), (z * z).sum(1)],
                      dim=1) / denom[:, None]
    return count, mean_rel, cov


def knn_block(query, search, idx, valid, kind):
    """The ``kind`` layout of each query's neighbors (device tensors)."""
    count, mean_rel, cov = knn_moments(query, search, idx, valid)
    if kind == "eigen":
        block = layouts.eigen_block(count, mean_rel + query, cov, query,
                                    1.0)
        return torch.cat([count[:, None], block[:, 1:]], dim=1)
    if kind != "minimal":
        raise ValueError(f"unsupported knn feature kind {kind!r}")
    norm_mean = torch.sqrt((mean_rel * mean_rel).sum(1))
    centroid = torch.where(count > 0, norm_mean, torch.zeros_like(norm_mean))
    vals = eigvalsh3(cov)
    trace = cov[:, 0] + cov[:, 3] + cov[:, 5]
    ok = (count >= 2) & (trace > 0)
    safe = torch.where(trace > 0, trace, torch.ones_like(trace))
    norm = torch.where(ok[:, None], vals / safe[:, None],
                       torch.zeros_like(vals))
    return torch.stack([count, centroid, norm[:, 0], norm[:, 1]], dim=1)
