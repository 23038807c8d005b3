"""
FlexCloud: an origin-recentered point cloud with named "assets" (feature /
label arrays, each carrying its own index set into the master cloud) and
set-algebra across assets (copy of ``nimrud_tpu/utils/point_clouds.py``).

Capability parity with the reference container
(reference: nimrud/utils/point_clouds.py:15-159), plus asset management
the reference lacked (removal, listing, membership).  The on-disk
counterpart is :class:`nimrud_tpu_torch.archive.store.CloudArchive`.
"""

import numpy as np


class FlexCloud:
    """
    Wraps an (N, 3) point cloud.  Points are stored shifted so the first
    point sits at the origin (``corner`` holds the shift).  Supplemental
    per-point data is attached as named assets: each asset is a 1-D or 2-D
    array plus a sorted-unique index array addressing rows of the master
    cloud, plus arbitrary metadata.
    """

    def __init__(self, input_cloud):
        if input_cloud.ndim != 2:
            raise ValueError("input point cloud must be a 2-D array")
        if input_cloud.shape[1] != 3:
            raise ValueError("must be initialized with a 3-D point cloud")
        self.num_points = input_cloud.shape[0]
        self.id_index = np.arange(self.num_points)
        self.assets = {}
        # recenter on the first point: features downstream are
        # displacement-based, and small coordinates keep f32 healthy
        self.corner = input_cloud[0]
        self.points = input_cloud - self.corner

    # -- assets --------------------------------------------------------------

    def add_asset(self, asset_array, index_array, asset_name, meta=None):
        """
        Attach a new asset.  The index array need not be sorted or unique on
        the way in; it is stored sorted-unique with the asset rows aligned.
        """
        if asset_name in self.assets:
            raise ValueError(f"asset {asset_name} already exists")
        asset_array, index_array = self._validate_asset(
            asset_array, index_array)
        self.assets[asset_name] = {
            "asset": asset_array,
            "index": index_array,
            "meta": meta,
        }

    def _validate_asset(self, asset_array, index_array):
        """Sort/unique the index set, align the asset rows, bounds-check."""
        if asset_array.ndim > 2:
            raise ValueError("asset array has too many dimensions")
        if asset_array.shape[0] != index_array.size:
            raise ValueError("asset and index arrays misaligned")
        if index_array.min() < 0 or index_array.max() >= self.num_points:
            raise ValueError("index array addresses outside the cloud")
        unique_idx, first_occurrence = np.unique(
            index_array, return_index=True)
        return asset_array.take(first_occurrence, axis=0), unique_idx

    def remove_asset(self, asset_name):
        """Detach an asset (the reference had no way to drop one)."""
        if asset_name not in self.assets:
            raise ValueError(f"no asset named {asset_name}")
        del self.assets[asset_name]

    def asset_names(self):
        """Names of the attached assets, insertion-ordered."""
        return list(self.assets)

    def __contains__(self, asset_name):
        return asset_name in self.assets

    def intersection(self, asset_names):
        """
        Intersect the index sets of the named assets.  Returns the common
        index array and the horizontal concatenation of the matching asset
        rows (1-D assets contribute one column).
        """
        common = self.id_index
        for name in asset_names:
            common = np.intersect1d(
                common, self.assets[name]["index"], assume_unique=True)

        blocks = []
        for name in asset_names:
            entry = self.assets[name]
            keep = np.isin(entry["index"], common, assume_unique=True)
            rows = np.compress(keep, entry["asset"], axis=0)
            width = rows.shape[1] if rows.ndim == 2 else 1
            blocks.append(rows.reshape(common.size, width))
        return common, np.concatenate(blocks, axis=1)

    # -- geometry ------------------------------------------------------------

    def take(self, index_array=None, original_coordinates=True):
        """
        Return (a subset of) the cloud's points, in original coordinates by
        default or in the recentered frame.
        """
        points = self.points + self.corner if original_coordinates \
            else self.points
        if index_array is None:
            return points
        return points.take(index_array, axis=0)
