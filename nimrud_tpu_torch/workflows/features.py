"""
Feature workflows: compute multiscale features over an archive and store
them back as assets (port of ``nimrud_tpu/workflows/features.py``).

Non-interactive equivalents of the reference's prompt-driven drivers
(reference: nimrud/prototypes/apc.py gmso_APC:497, ogmso_APC:2167,
vmso_APC:2357).  The port's extraction handles whole clouds on the card
(at ``multiscale.TILED_THRESHOLD`` or more points with voxelized bands,
the fused path: the ``packed_moments`` kernel); an optional partitioned
mode reproduces the reference's buffered-partition outer loop via
NestedOctree for clouds beyond device memory.
"""

import numpy as np

from nimrud_tpu_torch.archive.store import NULL_LABEL
from nimrud_tpu_torch.features.multiscale import extract_scaleset
from nimrud_tpu_torch.utils.geometry import NestedOctree

KIND_TO_NAME = {
    "minimal": "mso",
    "geometric": "gmso",
    "oriented": "ogmso",
    "covariance": "cmso",
    "eigen": "emso",
    "sazo": "szmso",
    "vector": "vmso",
}


def _select_queries(archive, label_asset, unlabeled_fraction, seed):
    """
    Query index selection with the reference's skip-sampling of unlabeled
    points (gmso_APC computes features for every labeled point but only a
    fraction of the 999-labeled ones, apc.py:598-617).
    """
    n = archive.manifest["num_points"]
    if label_asset is None:
        return np.arange(n)
    labels, index, _ = archive.get_asset(label_asset)
    labels = labels.reshape(-1)
    labeled = index[labels != NULL_LABEL]
    if unlabeled_fraction >= 1.0:
        return np.arange(n)
    mask = np.zeros(n, dtype=bool)
    mask[labeled] = True
    unlabeled = np.nonzero(~mask)[0]
    rng = np.random.RandomState(seed)
    keep = rng.random(unlabeled.size) < unlabeled_fraction
    return np.sort(np.concatenate([labeled, unlabeled[keep]]))


def extract_features(archive, scaleset, kind="geometric", *,
                     feature_name=None, label_asset=None,
                     unlabeled_fraction=1.0, attributes_asset=None,
                     search_asset=None, exclude_radius=None,
                     partition_max_population=None, method="auto",
                     hbm_budget_bytes=None, seed=0, overwrite=False,
                     device="cuda"):
    """
    Compute multiscale features for (a subset of) an archive's points and
    store them as an asset.

    Args:
      scaleset:  sequence of (voxel_edge, radii) bands.
      kind:      minimal / geometric / oriented / covariance / vector.
      label_asset + unlabeled_fraction: skip-sample unlabeled points the
                 way the reference's gmso workflow did.
      attributes_asset: per-point attribute asset for kind="vector".
      search_asset: optional asset whose *index* designates a search
                 subset (the reference's designated-search-space option).
      partition_max_population: if set, run the reference-style outer
                 partition loop (NestedOctree with buffer = largest
                 radius) with at most this many search points per tile.
                 Left as None (default "auto"), the projected device
                 footprint is checked against ``hbm_budget_bytes`` and
                 the partition loop engages automatically when the
                 cloud cannot be extracted in one piece (the reference
                 budget-checked GPU memory before every launch,
                 reference: nimrud/prototypes/mso.py:375-466).
      hbm_budget_bytes: device-memory budget for the automatic decision
                 (default: 0.85 of the card's memory, or 12 GiB for a
                 CPU ``device``).
      device:    where the extraction runs (the card unless the caller
                 asks for the CPU).

    Returns the stored feature asset name.
    """
    cloud = archive.take(original_coordinates=False).astype(np.float32)
    query_idx = _select_queries(
        archive, label_asset, unlabeled_fraction, seed)
    query = cloud[query_idx]

    if search_asset is not None:
        _, search_index, _ = archive.get_asset(search_asset)
        search = cloud[search_index]
    else:
        search_index = None
        search = cloud

    attributes = None
    if kind == "vector":
        if attributes_asset is None:
            raise ValueError("kind='vector' requires attributes_asset")
        attr_data, attr_index, _ = archive.get_asset(attributes_asset)
        attr_data = attr_data.reshape(attr_index.size, -1)
        if search_asset is not None:
            # designated search space with its own attributes (the
            # reference's vmso_APC independent-search-cloud option,
            # reference: nimrud/prototypes/apc.py:2357-2529): attribute
            # rows are realigned onto the search subset
            row_of = np.full(cloud.shape[0], -1, np.int64)
            row_of[attr_index] = np.arange(attr_index.size)
            rows = row_of[search_index]
            if (rows < 0).any():
                raise ValueError(
                    "attributes_asset does not cover every point of "
                    "the designated search space")
            attributes = attr_data[rows]
        else:
            if attr_index.size != cloud.shape[0]:
                raise ValueError(
                    "vector features need attributes for every point")
            attributes = attr_data

    buffer_radius = max(max(radii) for _, radii in scaleset)

    if partition_max_population is None:
        # automatic out-of-core decision: project the device footprint
        # and engage the buffered-partition loop when it exceeds budget
        from nimrud_tpu_torch.utils.memory import auto_partition_population
        span = cloud.max(0) - cloud.min(0) if len(cloud) else None
        partition_max_population = auto_partition_population(
            len(query), len(search), scaleset,
            budget=hbm_budget_bytes, bounds_span=span, device=device,
            n_attr=0 if attributes is None else attributes.shape[1])

    if partition_max_population is None:
        features = extract_scaleset(
            query, search, scaleset, kind,
            attributes=attributes, exclude_radius=exclude_radius,
            method=method, device=device)
    else:
        # reference-style buffered partition outer loop, per band.  The
        # voxel downsample happens GLOBALLY per band (before
        # partitioning) so results are partition-invariant -- the
        # reference anchored its voxel grid per partition, which made
        # features depend on the partitioning (a flaw, not a feature).
        from nimrud_tpu_torch.features.multiscale import voxel_downsample
        band_blocks = []
        for edge, radii in scaleset:
            if edge and edge > 0:
                centers, band_attrs = voxel_downsample(
                    search, edge,
                    attributes if kind == "vector" else None, device=device)
            else:
                centers, band_attrs = search, attributes
            tree = NestedOctree(query, centers, max(radii))
            tree.partition(partition_max_population)
            band = None
            for q_idx, s_idx in tree.partition_generator():
                if q_idx.size == 0:
                    continue
                block = extract_scaleset(
                    query[q_idx], centers[s_idx], [(0.0, radii)], kind,
                    attributes=None if band_attrs is None
                    else band_attrs[s_idx],
                    exclude_radius=exclude_radius, method=method,
                    device=device)
                if band is None:
                    band = np.zeros(
                        (query.shape[0], block.shape[1]), np.float32)
                band[q_idx] = block
            band_blocks.append(band)
        features = np.concatenate(band_blocks, axis=1)

    if feature_name is None:
        feature_name = "{}_{}".format(
            KIND_TO_NAME[kind],
            "_".join(f"{edge:g}" for edge, _ in scaleset))
    archive.add_asset(
        feature_name, features, query_idx,
        meta={"kind": kind,
              "scaleset": [[edge, list(radii)] for edge, radii in scaleset],
              "exclude_radius": exclude_radius},
        overwrite=overwrite)
    return feature_name
