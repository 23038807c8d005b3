"""
CloudArchive: the on-disk archive for one point cloud and its assets
(port of ``nimrud_tpu/archive/store.py``, host NumPy; the same on-disk
format, so an archive written by either package opens in the other).

Replaces the reference's pickled APC object + side-car feature files
(reference: nimrud/prototypes/apc.py:110-450) with a transparent
directory-of-arrays format -- every array is a plain ``.npy``, metadata
is JSON, nothing is pickled:

    <root>/
      manifest.json          name, corner shift, counts, asset index
      points.npy             (N, 3) float32, recentered
      assets/<name>/
        data.npy             asset rows (features, labels, probabilities)
        index.npy            sorted-unique point indices for the rows
        meta.json            user metadata (scaleset, classifier, ...)

The asset/index model and set-algebra follow FlexCloud
(``utils.point_clouds``); the archive is the framework's
checkpoint/resume system, exactly as the APC was for the reference:
features are computed once and workflows restart from stored assets.

Capability parity details:
  * clouds are recentered when far from the origin (the reference used a
    100 km threshold, apc.py:246-251) and stored float32;
  * optional "natural" voxel downsampling keeps one real point per voxel
    (reference: mso.py:1248-1310 / cu_natural_vox);
  * the null label 999 marks search-space-only points (apc.py:44).
"""

import json
import os
import shutil

import numpy as np

from nimrud_tpu_torch.archive import io as cloud_io
from nimrud_tpu_torch.utils.geometry import VoxelFilter

NULL_LABEL = 999
RECENTER_THRESHOLD = 1.0e5        # meters, the reference's 100 km


def natural_voxel_indices(points, edge_length):
    """
    Indices of one representative (real) point per occupied voxel --
    the reference's natural voxel filter.
    """
    vf = VoxelFilter(np.asarray(points, dtype=np.float64), edge_length)
    addresses = vf.coordinate_to_address(
        np.asarray(points, dtype=np.float64))
    _, first = np.unique(addresses, return_index=True)
    return np.sort(first)


class CloudArchive:
    """Open with :meth:`create` or :meth:`open`."""

    def __init__(self, root, manifest, points):
        self.root = root
        self.manifest = manifest
        self.points = points

    # -- lifecycle ------------------------------------------------------------

    @classmethod
    def create(cls, root, source, name=None, voxel=None, recenter=True,
               overwrite=False):
        """
        Build an archive from an array / .npy / ASCII source.

        voxel: optional natural-downsample edge length (keeps one real
        point per voxel, like the reference's APC ingest).
        """
        root = os.fspath(root)
        if os.path.exists(root):
            if not overwrite:
                raise FileExistsError(f"{root} already exists")
            shutil.rmtree(root)
        os.makedirs(os.path.join(root, "assets"))

        cloud = cloud_io.load_points(source)
        geometry = cloud[:, :3].astype(np.float64)
        extra_columns = cloud[:, 3:]

        if voxel:
            keep = natural_voxel_indices(geometry, voxel)
            geometry = geometry[keep]
            extra_columns = extra_columns[keep]

        corner = np.zeros(3)
        if recenter and np.linalg.norm(geometry.mean(0)) > RECENTER_THRESHOLD:
            corner = geometry.mean(0)
            geometry = geometry - corner

        points = geometry.astype(np.float32)
        manifest = {
            "name": name or os.path.basename(root),
            "num_points": int(points.shape[0]),
            "corner": corner.tolist(),
            "voxel": voxel,
            "assets": {},
        }
        np.save(os.path.join(root, "points.npy"), points)
        archive = cls(root, manifest, points)
        archive._write_manifest()
        if extra_columns.shape[1]:
            archive.add_asset(
                "source_attributes", extra_columns,
                np.arange(points.shape[0]),
                meta="non-XYZ columns of the source file")
        return archive

    @classmethod
    def open(cls, root):
        root = os.fspath(root)
        with open(os.path.join(root, "manifest.json")) as handle:
            manifest = json.load(handle)
        points = np.load(os.path.join(root, "points.npy"))
        return cls(root, manifest, points)

    def _write_manifest(self):
        with open(os.path.join(self.root, "manifest.json"), "w") as handle:
            json.dump(self.manifest, handle, indent=2)

    # -- assets ---------------------------------------------------------------

    def _asset_dir(self, name):
        return os.path.join(self.root, "assets", name)

    def add_asset(self, name, data, index, meta=None, overwrite=False):
        """
        Store an asset (features / labels / probabilities) with its point
        index set (sorted-unique on disk, FlexCloud semantics).
        """
        if name in self.manifest["assets"] and not overwrite:
            raise ValueError(f"asset {name!r} already exists")
        data = np.asarray(data)
        index = np.asarray(index)
        if data.ndim > 2:
            raise ValueError("asset array has too many dimensions")
        if data.shape[0] != index.size:
            raise ValueError("asset and index arrays misaligned")
        if index.size and (index.min() < 0
                           or index.max() >= self.manifest["num_points"]):
            raise ValueError("index addresses outside the cloud")
        unique_idx, first = np.unique(index, return_index=True)
        data = data.take(first, axis=0)

        directory = self._asset_dir(name)
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, "data.npy"), data)
        np.save(os.path.join(directory, "index.npy"),
                unique_idx.astype(np.int64))
        with open(os.path.join(directory, "meta.json"), "w") as handle:
            json.dump(meta, handle, indent=2, default=str)
        self.manifest["assets"][name] = {
            "rows": int(data.shape[0]),
            "width": int(data.shape[1]) if data.ndim == 2 else 1,
        }
        self._write_manifest()

    def get_asset(self, name):
        """Returns ``(data, index, meta)``."""
        directory = self._asset_dir(name)
        data = np.load(os.path.join(directory, "data.npy"))
        index = np.load(os.path.join(directory, "index.npy"))
        with open(os.path.join(directory, "meta.json")) as handle:
            meta = json.load(handle)
        return data, index, meta

    def remove_asset(self, name):
        """Delete an asset (the reference's 'murk', apc.py:2099)."""
        shutil.rmtree(self._asset_dir(name))
        del self.manifest["assets"][name]
        self._write_manifest()

    def list_assets(self):
        return dict(self.manifest["assets"])

    def intersection(self, asset_names):
        """
        Index-set intersection + horizontal concatenation of the matching
        asset rows (FlexCloud semantics; the reference's feature-join,
        apc.py:1946-2016).
        """
        common = np.arange(self.manifest["num_points"])
        loaded = []
        for name in asset_names:
            data, index, _ = self.get_asset(name)
            loaded.append((data, index))
            common = np.intersect1d(common, index, assume_unique=True)
        blocks = []
        for data, index in loaded:
            keep = np.isin(index, common, assume_unique=True)
            rows = np.compress(keep, data, axis=0)
            width = rows.shape[1] if rows.ndim == 2 else 1
            blocks.append(rows.reshape(common.size, width))
        return common, np.concatenate(blocks, axis=1)

    # -- geometry -------------------------------------------------------------

    def take(self, index=None, original_coordinates=True):
        points = self.points.astype(np.float64)
        if original_coordinates:
            points = points + np.asarray(self.manifest["corner"])
        if index is not None:
            points = points.take(index, axis=0)
        return points

    def labeled_indices(self, label_asset="labels"):
        """Indices whose label is not the 999 null marker."""
        labels, index, _ = self.get_asset(label_asset)
        labels = labels.reshape(-1)
        return index[labels != NULL_LABEL]
