"""
The voxel address math of ``nimrud_tpu/utils/geometry.py:VoxelFilter``,
copied (host NumPy, float64): a cubic grid over a 2-D or 3-D cloud whose
per-axis grid coordinates pack into one 64-bit integer address.
``features.multiscale.extract_scaleset_device`` sorts its queries by
these addresses before the dense method, as the reference does.
"""

import numpy as np

# Voxel addresses must fit one signed 64-bit integer.
MAX_ADDRESS_LENGTH = 64


class VoxelFilter:
    """
    A cubic grid over a 2-D or 3-D point cloud.  The grid's first voxel
    (address 0) is centered on the minimum corner of the input cloud:
    the bounding region is expanded by half an edge length on every
    side.  Axis 0 takes the lowest address bits.
    """

    def __init__(self, points, edge_length):
        points = np.asarray(points)
        if points.ndim != 2:
            raise ValueError("point cloud must be a 2-D array (rows = points)")
        if points.shape[1] not in (2, 3):
            raise ValueError("only 2-D and 3-D point clouds are supported")
        if points.shape[0] < 2:
            raise ValueError("need at least 2 points to define a voxel grid")

        self.edge_length = edge_length
        self.minimum_corner = points.min(0) - edge_length / 2
        self.maximum_corner = points.max(0) + edge_length / 2

        self.shifts, self.widths = self._calculate_shift()
        self.masks = self._calculate_masks()

    def _calculate_shift(self):
        """Address bits per axis and where each axis' field starts;
        raises past the 64-bit budget."""
        span = self.maximum_corner - self.minimum_corner
        widths = np.ceil(np.log2(span / self.edge_length))
        if widths.sum() > MAX_ADDRESS_LENGTH:
            raise ValueError(
                "edge length too small: this region needs "
                f"{int(widths.sum())} address bits (max {MAX_ADDRESS_LENGTH})")
        shifts = np.cumsum(widths)[:-1]
        return shifts.astype(np.int64), widths.astype(np.int64)

    def _calculate_masks(self):
        """Per-axis bit masks of the address fields."""
        field = [(1 << int(w)) - 1 for w in self.widths]
        out = [field[0]]
        for width_bits, shift in zip(field[1:], self.shifts):
            out.append(width_bits << int(shift))
        return out

    def _check_in_bounds(self, points):
        """``points`` as an at-least-2-D array, checked against the
        filter's region and dimensionality."""
        points = np.atleast_2d(points)
        if points.ndim != 2:
            raise ValueError("wrong array shape for a point cloud")
        if points.shape[1] != self.widths.size:
            raise ValueError("wrong number of spatial dimensions")
        if (np.any(points.min(0) < self.minimum_corner)
                or np.any(points.max(0) > self.maximum_corner)):
            raise ValueError("points fall outside the filter's bounding region")
        return points

    def coordinate_to_address(self, points):
        """Real-world coordinates -> packed integer voxel addresses."""
        points = self._check_in_bounds(points)
        grid = np.floor(
            (points - self.minimum_corner) / self.edge_length).astype(np.int64)
        address = grid[:, 0].copy()
        for axis, shift in enumerate(self.shifts, start=1):
            address |= grid[:, axis] << shift      # disjoint fields
        return address
