"""
Voxel key packing on tensors (port of ``nimrud_tpu/ops/packing.py``).

Per-axis grid coordinates pack into one int32 key of at most 30 bits,
so INT32_MAX never is a valid key and serves as the padding sentinel.
The host-side sizing (``GridSpec.fit_bounds``) is the reference's NumPy,
copied; ``encode`` / ``decode`` are the jnp math on torch tensors.
"""

from dataclasses import dataclass

import numpy as np
import torch

# keys use at most 30 bits so INT32_MAX is never a valid key
MAX_KEY_BITS = 30
PAD_KEY = np.int32(2**31 - 1)


def scalar(value, like):
    """``value`` as a 0-d tensor of ``like``'s dtype and device.

    Arithmetic with a Python float goes through a CPU scalar, and CUDA's
    true division by a CPU scalar multiplies by its reciprocal, which
    can differ from the division in the last bit.  Grid binning must
    match the reference bit for bit, so divisors live on the device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


@dataclass(frozen=True)
class GridSpec:
    """
    Static description of a cubic voxel grid, computed on the host.
    Axis 0 in the lowest bits, voxel 0 centered on the region's minimum
    corner (grid origin = min - edge/2).
    """

    origin: tuple          # minimum corner of the grid (voxel 0's low corner)
    edge_length: float
    widths: tuple          # address bits per axis

    @property
    def dim(self):
        return len(self.widths)

    @property
    def shifts(self):
        out = [0]
        for w in self.widths[:-1]:
            out.append(out[-1] + w)
        return tuple(out)

    @property
    def total_bits(self):
        return sum(self.widths)

    @classmethod
    def fit(cls, points, edge_length):
        """Build a spec enclosing ``points`` (float64 math, as the
        reference's); raises past ``MAX_KEY_BITS``."""
        points = np.asarray(points, dtype=np.float64)
        return cls.fit_bounds(points.min(0), points.max(0), edge_length)

    @classmethod
    def fit_bounds(cls, lo, hi, edge_length):
        """Build a spec from precomputed bounds (min/max corners)."""
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        origin = lo - edge_length / 2
        span = (hi + edge_length / 2) - origin
        widths = np.maximum(
            np.ceil(np.log2(np.maximum(span / edge_length, 1.0))), 1
        ).astype(int)
        if widths.sum() > MAX_KEY_BITS:
            raise ValueError(
                f"grid needs {int(widths.sum())} key bits "
                f"(device budget {MAX_KEY_BITS}); tile the region first")
        return cls(tuple(float(o) for o in origin), float(edge_length),
                   tuple(int(w) for w in widths))

    # -- tensor ops ----------------------------------------------------------

    def encode(self, points):
        """(N, dim) float32 coordinates -> (N,) int32 voxel keys."""
        origin = torch.tensor(self.origin, dtype=points.dtype,
                              device=points.device)
        grid = torch.floor((points - origin)
                           / scalar(self.edge_length, points))
        top = torch.tensor([2**w - 1 for w in self.widths],
                           dtype=points.dtype, device=points.device)
        grid = torch.minimum(torch.clamp(grid, min=0), top)
        grid = grid.to(torch.int32)
        key = grid[:, 0]
        for axis, shift in enumerate(self.shifts[1:], start=1):
            key = key | (grid[:, axis] << shift)
        return key

    def decode(self, keys):
        """(N,) int32 voxel keys -> (N, dim) float32 voxel centers."""
        columns = []
        for width, shift in zip(self.widths, self.shifts):
            mask = (1 << width) - 1
            columns.append((keys >> shift) & mask)
        grid = torch.stack(columns, dim=1).to(torch.float32)
        origin = torch.tensor(self.origin, dtype=torch.float32,
                              device=keys.device)
        return (grid * scalar(self.edge_length, grid) + origin
                + scalar(self.edge_length * 0.5, grid))
