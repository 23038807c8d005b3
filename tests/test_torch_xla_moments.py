"""
The dense method's moment core (``ops/moments.py``) and the host copies
it needs, against the JAX package on the same NumPy inputs:

* ``multiscale_moments`` / ``chunk_moments`` for both metrics, with and
  without the exclusion, attribute columns and the sazo statistic:
  counts and sazo values equal (both paths form ``d2`` and ``dz`` from
  the raw global coordinates, one operation at a time), means within
  5e-5 and central second moments within 2e-4 (the centroid tolerance
  of ``tests/test_minimal_parity.py``; the moments of an 8 m cloud
  summed in other orders), attribute means within 2e-5
  (``tests/test_interp.py``'s);
* ``utils.geometry.VoxelFilter``'s addresses (integers: equal),
  ``packing.GridSpec.fit`` and ``multiscale._effective_chunk``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import moments as jmom
from nimrud_tpu.ops import packing as jpk
from nimrud_tpu.utils.geometry import VoxelFilter as JVoxelFilter

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import moments as tmom
from nimrud_tpu_torch.ops import packing as tpk
from nimrud_tpu_torch.utils.geometry import VoxelFilter

from torch_thread_cases import one_torch_thread  # noqa: F401

MEAN_ATOL = 5e-5
COV_ATOL = 2e-4
ATTR_ATOL = 2e-5


def _problem(n_query=256, n_search=900, seed=0):
    rng = np.random.default_rng(seed)
    search = (rng.random((n_search, 3)) * (8, 8, 3)).astype(np.float32)
    query = (rng.random((n_query, 3)) * (8, 8, 3)).astype(np.float32)
    attrs = rng.random((n_search, 3)).astype(np.float32)
    valid = np.arange(n_search) < n_search - 30
    return query, search, attrs, valid


def _hold(got, ref):
    assert set(got) == set(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        mine = got[key].numpy()
        assert mine.shape == value.shape, key
        if key in ("count", "sazo"):
            np.testing.assert_array_equal(mine, value, err_msg=key)
        else:
            atol = {"mean": MEAN_ATOL, "cov": COV_ATOL,
                    "attr_mean": ATTR_ATOL}[key]
            np.testing.assert_allclose(mine, value, atol=atol, err_msg=key)
    assert got["count"].max() > 1


@pytest.mark.parametrize("metric", ["euclidean", "chebyshev"])
@pytest.mark.parametrize("exclude,attrs,sazo", [
    (None, False, False), (0.3, False, True), (None, True, True),
    (0.3, True, False)])
def test_multiscale_moments_match_reference(metric, exclude, attrs, sazo):
    query, search, attributes, valid = _problem()
    radii = (1.0, 0.6)
    kw = dict(chunk_size=64, exclude_radius=exclude, metric=metric,
              with_sazo=sazo)
    ref = jmom.multiscale_moments(
        jnp.asarray(query), jnp.asarray(search), jnp.asarray(valid), radii,
        attributes=jnp.asarray(attributes) if attrs else None, **kw)
    got = tmom.multiscale_moments(
        torch.from_numpy(query), torch.from_numpy(search),
        torch.from_numpy(valid), radii,
        attributes=torch.from_numpy(attributes) if attrs else None, **kw)
    _hold(got, ref)


def test_chunk_moments_exclusion_and_boundaries():
    # exactly representable coordinates on the ball's and the
    # exclusion's boundary: d2 == r*r and d2 == e*e count as the
    # reference counts them (f32(r*r) with the product in float64)
    search = np.float32([[0, 0, 0], [0.5, 0, 0], [0, 0.25, 0],
                         [0, 0, 1.0], [0.75, 0, 0]])
    query = np.float32([[0, 0, 0], [0.25, 0, 0]])
    valid = np.ones(len(search), bool)
    for exclude in (None, 0.25, 0.5):
        ref = jmom.chunk_moments(jnp.asarray(query), jnp.asarray(search),
                                 jnp.asarray(valid), (0.5, 1.0),
                                 exclude_radius=exclude, with_sazo=True)
        got = tmom.chunk_moments(torch.from_numpy(query),
                                 torch.from_numpy(search),
                                 torch.from_numpy(valid), (0.5, 1.0),
                                 exclude_radius=exclude, with_sazo=True)
        _hold(got, ref)
    with pytest.raises(ValueError, match="metric"):
        tmom.chunk_moments(torch.from_numpy(query), torch.from_numpy(search),
                           torch.from_numpy(valid), (0.5,), metric="taxicab")
    with pytest.raises(ValueError, match="multiple of chunk_size"):
        tmom.multiscale_moments(torch.from_numpy(query),
                                torch.from_numpy(search),
                                torch.from_numpy(valid), (0.5,),
                                chunk_size=64)


def test_voxel_filter_addresses_and_grid_fit():
    rng = np.random.default_rng(3)
    cloud = rng.random((500, 3)) * (40, 25, 7) + (1000, -200, 3)
    for edge in (0.1, 0.37, 2.0):
        ref, got = JVoxelFilter(cloud, edge), VoxelFilter(cloud, edge)
        np.testing.assert_array_equal(got.widths, ref.widths)
        np.testing.assert_array_equal(got.shifts, ref.shifts)
        np.testing.assert_array_equal(got.coordinate_to_address(cloud),
                                      ref.coordinate_to_address(cloud))
        c32 = cloud.astype(np.float32)
        assert tpk.GridSpec.fit(c32, edge).__dict__ \
            == jpk.GridSpec.fit(c32, edge).__dict__
        spec = tpk.GridSpec.fit(c32, edge)
        assert spec.dim == 3 and spec.total_bits == sum(spec.widths)
    with pytest.raises(ValueError, match="outside"):
        VoxelFilter(cloud, 1.0).coordinate_to_address(cloud + 100)
    with pytest.raises(ValueError, match="at least 2"):
        VoxelFilter(cloud[:1], 1.0)
    with pytest.raises(ValueError, match="key bits"):
        tpk.GridSpec.fit(np.float32([[0, 0, 0], [1e4, 1e4, 1e4]]), 1e-3)


def test_effective_chunk_matches_reference():
    for chunk in (64, 256, 1024, 4096):
        for n_search in (1, 128, 4096, 65536, 1 << 20, 1 << 24):
            assert tms._effective_chunk(chunk, n_search) \
                == jms._effective_chunk(chunk, n_search)
    assert tms.PAIRS_BUDGET == jms.PAIRS_BUDGET
    assert tms.TILED_THRESHOLD == jms.TILED_THRESHOLD
    assert tms.HOST_VOXEL_THRESHOLD == jms.HOST_VOXEL_THRESHOLD
