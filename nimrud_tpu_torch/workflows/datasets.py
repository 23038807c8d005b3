"""
Dataset assembly and archive maintenance tools (copy of
``nimrud_tpu/workflows/datasets.py``, host NumPy over the port's
``CloudArchive``).

Non-interactive equivalents of the reference's dataset utilities
(reference: nimrud/prototypes/apc.py quick_builder:31, merge_features:1946,
chop_features:2019, snipper:2075, collapse:2118):

  build_from_class_files -- assemble a labeled archive from per-class
                            cloud files (+ optional unlabeled search-space
                            files, which get the 999 null label)
  merge_assets           -- index-intersection feature join stored back
  chop_asset             -- keep a column subset of an asset
  snip_asset             -- keep a row subset of an asset
  collapse_labels        -- merge label values
"""

import numpy as np

from nimrud_tpu_torch.archive import io as cloud_io
from nimrud_tpu_torch.archive.store import NULL_LABEL, CloudArchive


def build_from_class_files(root, class_sources, *, search_sources=(),
                           voxel=None, overwrite=False):
    """
    Build a labeled archive from per-class point sources.

    Args:
      class_sources: sequence of (label:int, source) pairs; sources are
        anything load_points accepts (arrays or file paths).
      search_sources: extra unlabeled clouds (search-space only); their
        points get the 999 null label.
      voxel: optional natural-downsample edge applied to the combined
        cloud at ingest.

    Returns the CloudArchive.
    """
    clouds, labels = [], []
    for label, source in class_sources:
        cloud = cloud_io.load_points(source)
        clouds.append(cloud[:, :3])
        labels.append(np.full(len(cloud), int(label), np.int32))
    for source in search_sources:
        cloud = cloud_io.load_points(source)
        clouds.append(cloud[:, :3])
        labels.append(np.full(len(cloud), NULL_LABEL, np.int32))
    if not clouds:
        raise ValueError("no sources given")
    combined = np.vstack(clouds)
    all_labels = np.concatenate(labels)

    if voxel:
        from nimrud_tpu_torch.archive.store import natural_voxel_indices
        keep = natural_voxel_indices(combined, voxel)
        combined, all_labels = combined[keep], all_labels[keep]

    archive = CloudArchive.create(
        root, combined, voxel=None, overwrite=overwrite)
    archive.add_asset(
        "labels", all_labels, np.arange(len(all_labels)),
        meta={"classes": sorted({int(l) for l, _ in class_sources}),
              "null_label": NULL_LABEL})
    return archive


def merge_assets(archive, asset_names, result_name, *, overwrite=False):
    """Store the index-intersection join of several assets as one."""
    index, block = archive.intersection(list(asset_names))
    archive.add_asset(
        result_name, block.astype(np.float32), index,
        meta={"merged_from": list(asset_names)}, overwrite=overwrite)
    return result_name


def chop_asset(archive, asset_name, columns, result_name=None, *,
               overwrite=False):
    """Keep a column subset of a (2-D) asset."""
    data, index, meta = archive.get_asset(asset_name)
    if data.ndim != 2:
        raise ValueError("chop_asset needs a 2-D asset")
    chopped = data[:, list(columns)]
    result_name = result_name or f"{asset_name}_chop"
    archive.add_asset(
        result_name, chopped, index,
        meta={"source": asset_name, "columns": list(columns)},
        overwrite=overwrite)
    return result_name


def snip_asset(archive, asset_name, keep_indices, result_name=None, *,
               overwrite=False):
    """Keep only the rows whose cloud index is in ``keep_indices``."""
    data, index, meta = archive.get_asset(asset_name)
    keep = np.isin(index, np.asarray(keep_indices))
    result_name = result_name or f"{asset_name}_snip"
    archive.add_asset(
        result_name, data[keep], index[keep],
        meta={"source": asset_name}, overwrite=overwrite)
    return result_name


def collapse_labels(archive, label_asset, mapping, result_name=None, *,
                    overwrite=False):
    """
    Merge label values: ``mapping`` is {old_label: new_label}; unmapped
    labels (including 999) pass through.
    """
    labels, index, meta = archive.get_asset(label_asset)
    labels = labels.reshape(-1).astype(np.int64)
    out = labels.copy()
    for old, new in mapping.items():
        out[labels == int(old)] = int(new)
    result_name = result_name or f"{label_asset}_collapsed"
    archive.add_asset(
        result_name, out.astype(np.int32), index,
        meta={"source": label_asset,
              "mapping": {str(k): int(v) for k, v in mapping.items()}},
        overwrite=overwrite)
    return result_name
