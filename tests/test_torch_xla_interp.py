"""
The gather and matmul attribute interps (``ops/interp.py``) and
``features.multiscale.voxel_downsample`` against the JAX package on the
same NumPy inputs:

* ``interp_to_voxels`` at 7, 8 and 12 attribute columns, both metrics:
  centers, masks and the ``dropped_search`` counter equal, means within
  2e-5 (``tests/test_interp.py``'s gather-against-matmul bound); its
  overflow counted as the reference counts it;
* ``interp_to_voxels_matmul`` at the same widths, the same bounds;
* ``voxel_downsample`` on both sides of ``TILED_THRESHOLD`` (its
  interp's tiled and dense branches) and of ``HOST_VOXEL_THRESHOLD``
  (device and host dedup), the thresholds patched down in both
  packages so the clouds stay small: centers equal, means within 2e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import interp as jint
from nimrud_tpu.ops import packing as jpk

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import interp as tint
from nimrud_tpu_torch.ops import packing as tpk

from torch_thread_cases import one_torch_thread  # noqa: F401

EDGE = 0.5
ATTR_ATOL = 2e-5


def _inputs(n, n_attr, seed=21, extent=5.0):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * extent).astype(np.float32)
    attrs = rng.random((n, n_attr)).astype(np.float32)
    bucket = tms._pow2_bucket(n)
    valid = np.arange(bucket) < n
    return (pts, attrs, tms._pad_rows_f32(pts, bucket),
            tms._pad_rows_f32(attrs, bucket), valid)


def _hold(ref, got, min_live=10):
    centers, mask, means, stats = got
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(centers.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(means.numpy(), np.asarray(ref[2]),
                               atol=ATTR_ATOL)
    assert int(stats["dropped_search"]) == int(ref[3]["dropped_search"])
    assert mask.sum() >= min_live and float(means.abs().max()) > 0


@pytest.mark.parametrize("n_attr", [7, 8, 12])
@pytest.mark.parametrize("metric", ["chebyshev", "euclidean"])
def test_gather_interp_matches_reference(n_attr, metric):
    pts, _, padded, apad, valid = _inputs(1500, n_attr)
    spec = jpk.GridSpec.fit(pts, EDGE)
    tspec = tpk.GridSpec.fit(pts, EDGE)
    ref = jint.interp_to_voxels(jnp.asarray(padded), jnp.asarray(valid),
                                jnp.asarray(apad), spec, 16, metric=metric,
                                batch=128, with_stats=True)
    got = tint.interp_to_voxels(torch.from_numpy(padded),
                                torch.from_numpy(valid),
                                torch.from_numpy(apad), tspec, 16,
                                metric=metric, batch=128, with_stats=True)
    _hold(ref, got)


def test_gather_interp_overflow_is_counted_as_the_reference():
    # 600 points in one voxel cell, a cap of 64: the rest are counted
    rng = np.random.default_rng(4)
    pts = (0.2 + rng.random((600, 3)) * 0.05).astype(np.float32)
    padded = tms._pad_rows_f32(pts, 1024)
    apad = np.ones((1024, 1), np.float32)
    valid = np.arange(1024) < 600
    got = tint.interp_to_voxels(
        torch.from_numpy(padded), torch.from_numpy(valid),
        torch.from_numpy(apad), tpk.GridSpec.fit(pts, EDGE), 64,
        with_stats=True)
    ref = jint.interp_to_voxels(
        jnp.asarray(padded), jnp.asarray(valid), jnp.asarray(apad),
        jpk.GridSpec.fit(pts, EDGE), 64, with_stats=True)
    assert int(got[3]["dropped_search"]) == int(ref[3]["dropped_search"]) \
        == 600 - 64
    _hold(ref, got, min_live=1)
    with pytest.raises(ValueError, match="metric"):
        tint.interp_to_voxels(torch.from_numpy(padded),
                              torch.from_numpy(valid),
                              torch.from_numpy(apad),
                              tpk.GridSpec.fit(pts, EDGE), 64,
                              metric="taxicab")


@pytest.mark.parametrize("n_attr,s_cap", [(7, 32), (8, 32), (12, 8)])
def test_matmul_interp_matches_reference(n_attr, s_cap):
    # s_cap 8: fine tiles past it drop points, counted as the reference
    pts, _, padded, apad, valid = _inputs(1200, n_attr, seed=5, extent=3.0)
    lo = pts.min(0).astype(np.float64)
    hi = pts.max(0).astype(np.float64)
    ref = jint.interp_to_voxels_matmul(
        jnp.asarray(padded), jnp.asarray(valid), jnp.asarray(apad),
        jpk.GridSpec.fit(pts, EDGE), s_cap, lo, hi, with_stats=True)
    got = tint.interp_to_voxels_matmul(
        torch.from_numpy(padded), torch.from_numpy(valid),
        torch.from_numpy(apad), tpk.GridSpec.fit(pts, EDGE), s_cap, lo, hi,
        with_stats=True)
    _hold(ref, got)
    if s_cap == 8:
        assert int(got[3]["dropped_search"]) > 0
    with pytest.raises(ValueError, match="voxel edge"):
        tint.interp_to_voxels_matmul(
            torch.from_numpy(padded), torch.from_numpy(valid),
            torch.from_numpy(apad), tpk.GridSpec.fit(pts, EDGE), s_cap,
            lo, hi, radius=2 * EDGE)


@pytest.mark.parametrize("tiled,host", [(False, False), (True, False),
                                        (True, True)])
def test_voxel_downsample_matches_reference(monkeypatch, tiled, host):
    pts, attrs, _, _, _ = _inputs(3000, 3, seed=8, extent=6.0)
    for module in (jms, tms):
        monkeypatch.setattr(module, "TILED_THRESHOLD",
                            1000 if tiled else 16384)
        monkeypatch.setattr(module, "HOST_VOXEL_THRESHOLD",
                            1000 if host else 200_000)
    bounds = (pts.min(0) - 0.3, pts.max(0) + 0.2)
    for kw in ({}, {"bounds": bounds}):
        ref_c, ref_a = jms.voxel_downsample(pts, EDGE, attrs, **kw)
        got_c, got_a = tms.voxel_downsample(pts, EDGE, attrs, device="cpu",
                                            **kw)
        np.testing.assert_array_equal(got_c, ref_c)
        np.testing.assert_allclose(got_a, ref_a, atol=ATTR_ATOL)
        centers, none = tms.voxel_downsample(pts, EDGE, device="cpu", **kw)
        assert none is None
        np.testing.assert_array_equal(centers, ref_c)
    for metric in ("euclidean",):
        ref_c, ref_a = jms.voxel_downsample(pts, EDGE, attrs,
                                            interp_metric=metric)
        got_c, got_a = tms.voxel_downsample(pts, EDGE, attrs,
                                            interp_metric=metric,
                                            device="cpu")
        np.testing.assert_allclose(got_a, ref_a, atol=ATTR_ATOL)
