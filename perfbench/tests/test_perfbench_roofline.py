"""The pair count and the roofline arithmetic on hand-sized cases."""

import math

import numpy as np
import pytest
import torch

from perfbench.core import peaks
from perfbench.metrics import (device_idle_share, packed_moments_roofline,
                               plan_scan_ms)
from perfbench.reference import features as rfeat

LO = np.zeros(3, np.float32)
HI = np.array([8.0, 8.0, 8.0], np.float32)


def test_pair_count_by_hand():
    # a 5 x 5 x 1 layer of voxel centres 0.25 m apart at z = 4.0; the
    # query at the middle centre sees the centres within 0.5 m: itself,
    # 4 at 0.25, 4 at 0.3536, 4 at 0.5 -- 13 (those at 0.5 sit on the
    # radius exactly: undecidable, counted in)
    axis = np.arange(-2, 3) * 0.25 + 4.0
    xs, ys = np.meshgrid(axis, axis)
    search = np.stack([xs.ravel(), ys.ravel(), np.full(25, 4.0)], 1)
    sc = rfeat.Scene(torch.tensor(search, dtype=torch.float32), None,
                     [(0.25, 0.5)], LO, HI, quantized=False)
    assert sc.voxel_counts == [25]
    assert sc.pair_counts(torch.tensor([12])) == [13]
    feats, owner = sc.features(torch.tensor([12]))
    # the 4 pairs at exactly 0.5 m are undecidable: 2 ** 4 variants
    assert len(owner) == 16 and int(feats[:, 0].min()) == 9
    assert int(feats[:, 0].max()) == 13


def test_bound_by_hand():
    points, pairs, voxels = 1_000_000, [3e7, 4e7, 5e7], [4e5, 2e5, 1e5]
    seconds, term = peaks.moments_bound_s(points, pairs, voxels)
    distance = 12e7 * 8 / (132 * 128 * 1.98e9)
    tensor = 12e7 * 10 * 3 * 2 / 989e12
    moved = (points * 12 + 7e5 * 12 + 3 * points * 40) / 3.35e12
    assert term == "bytes" and seconds == pytest.approx(moved)
    assert moved > distance > tensor


def test_bound_keywords_by_hand():
    # the vector layout's second stage: 1 + A = 5 sums a pair and
    # radius, each centre read with its 4 interpolated columns
    points, pairs, voxels = 1_000_000, [3e7, 4e7, 5e7], [4e5, 2e5, 1e5]
    assert peaks.moments_bound_s(points, pairs, voxels, cols=10,
                                 pair_ops=8, voxel_bytes=12) \
        == peaks.moments_bound_s(points, pairs, voxels)
    seconds, term = peaks.moments_bound_s(points, [3e6, 4e6, 5e6], voxels,
                                          cols=5, voxel_bytes=28)
    moved = (points * 12 + 7e5 * 28 + 3 * points * 20) / 3.35e12
    assert term == "bytes" and seconds == pytest.approx(moved)
    seconds, term = peaks.moments_bound_s(points, [1e9], [4e5], cols=5,
                                          pair_ops=20)
    assert term == "distance"
    assert seconds == pytest.approx(1e9 * 20 / (132 * 128 * 1.98e9))


def test_interp_bound_by_hand():
    # 1M raw points with 4 columns, 2.5M / 2M / 2M chebyshev pairs and
    # 4e5 / 2e5 / 1e5 centres: 5 operations a pair against the bytes
    # of the cloud and its columns read once and 5 sums a centre
    points, pairs, voxels = 1_000_000, [2.5e6, 2e6, 2e6], [4e5, 2e5, 1e5]
    seconds, term = peaks.interp_bound_s(points, pairs, voxels, cols=5)
    distance = 6.5e6 * 5 / (132 * 128 * 1.98e9)
    tensor = 6.5e6 * 5 * 3 * 2 / 989e12
    moved = (points * (12 + 16) + 7e5 * 20) / 3.35e12
    assert term == "bytes" and seconds == pytest.approx(moved)
    assert moved > distance > tensor
    seconds, term = peaks.interp_bound_s(10, [1e9], [10], cols=2)
    assert term == "distance"
    assert seconds == pytest.approx(1e9 * 5 / (132 * 128 * 1.98e9))


def test_readers_by_hand():
    device = [("void (anonymous namespace)::packed_moments_kernel<1, false>"
               "(float const*)", 0.0, 100.0),
              ("void at::native::tensor_kernel_scan_innermost_dim_with_"
               "indices<long, std::less_equal<long> >(long const*)",
               100.0, 300.0),
              ("void at::native::elementwise_kernel<128, 2>", 500.0, 600.0)]
    records = {"trace": {"device": device, "window_us": (0.0, 1000.0),
                         "clouds": 2},
               "work": {"points": 1000, "pairs": [2000.0],
                        "voxels": [100.0]}}
    bound = (1000 * 12 + 100 * 12 + 1000 * 40) / 3.35e12
    assert packed_moments_roofline.read(records) == pytest.approx(
        100.0 * bound / (100e-6 / 2))
    assert plan_scan_ms.read(records) == pytest.approx(0.1)
    assert device_idle_share.read(records) == pytest.approx(60.0)
    assert packed_moments_roofline.read({"trace": None}) is None
    assert plan_scan_ms.read({"trace": {"device": device[2:],
                                         "clouds": 1}}) is None
    assert math.isfinite(bound)
