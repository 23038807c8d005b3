"""
The minimal pipeline (port of ``nimrud_tpu/features/minimal.py``): the
reference's behavioural-parity contract.  Per scale, voxel-downsample
the search cloud, find every search voxel within the radius of each
query point, and emit ``[population, centroid_displacement, eig1,
eig2]`` -- the two largest covariance eigenvalues normalized to sum 1;
empty or single-point neighborhoods give zeros.  A thin wrapper over
``features.multiscale.extract_scaleset`` (``kind="minimal"``), on the
card unless the caller passes ``device="cpu"``.
"""

import time

from nimrud_tpu_torch.features.multiscale import extract_scaleset

# the reference's tuning constants, kept for its API; the extraction's
# chunking does not read them
LEAFSIZE = 300
QUERY_CHUNK_SIZE = 1000


def one_scale_single_core(query_cloud, search_cloud, edge_length, radius,
                          verbose=False, chunk_size=1024, device="cuda"):
    """Features for one (voxel edge, radius) analysis scale: (N, 4)."""
    return extract_scaleset(
        query_cloud, search_cloud, [(edge_length, (radius,))],
        kind="minimal", chunk_size=chunk_size, device=device)


def process_single_core(query_cloud, search_cloud, edge_lengths, radii,
                        verbose=False, chunk_size=1024, device="cuda"):
    """Multiscale features aligned with the query cloud: (N, 4 *
    n_scales), scales in caller order; ``verbose`` prints the rate."""
    assert len(edge_lengths) == len(radii), \
        "edge_lengths and radii should be equal-length sequences."
    start = time.perf_counter()
    scaleset = [(edge, (radius,))
                for edge, radius in zip(edge_lengths, radii)]
    features = extract_scaleset(query_cloud, search_cloud, scaleset,
                                kind="minimal", chunk_size=chunk_size,
                                device=device)
    if verbose:
        elapsed = time.perf_counter() - start
        rate = query_cloud.shape[0] * len(radii) / max(elapsed, 1e-9)
        print(f"{len(radii)} scales over {query_cloud.shape[0]} points "
              f"in {elapsed:.3f}s ({rate:,.0f} point-scales/s)")
    return features
