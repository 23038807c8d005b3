"""
``exclude_radius`` on the port's extraction paths against the JAX
package, on the same NumPy inputs:

* ``extract_scaleset_fused(exclude_radius=e)`` against the reference's
  ``extract_scaleset_fused(tuning={"backend": "packed"})`` for
  ``minimal``, ``sazo`` and ``vector`` (the interp without the
  exclusion, the extraction with it), and against ``{"backend":
  "pallas"}`` (the span kernel) for ``minimal``, both in interpret mode;
* ``tiled_features(backend="pallas", exclude_radius=e)`` against the
  reference's (the entry kernel);
* the public wrappers ``extract_scaleset_device`` / ``extract_scaleset``
  on the fused path, and on the dense and tiled methods below
  ``TILED_THRESHOLD``.

Densities (the populations) equal the reference's within an ulp; the
other columns within the cross-backend feature tolerance
(``FEATURE_ATOL``, 1e-3, as ``tests/test_torch_kinds_packed.py``);
``vector`` means within the interp and extraction tolerance of
``tests/test_torch_vector_interp.py``.
"""

import numpy as np
import pytest

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import grid as jgrid

from nimrud_tpu_torch.features import layouts
from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import grid as tgrid
from test_torch_grid import _clouds
from test_torch_kinds_packed import FEATURE_ATOL
from test_torch_spans import _scene
from test_torch_vector_interp import attr_tolerance

E = 0.3                 # drops a ring of neighbours at these densities


def _compare(kind, got, ref, plain):
    """Populations within an ulp of the reference's and fewer than
    without the exclusion somewhere; the rest within FEATURE_ATOL."""
    width = layouts.LAYOUT_WIDTHS[kind]
    assert got.shape == ref.shape == plain.shape
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, 0::width], ref[:, 0::width],
                               rtol=2.0 ** -22)
    assert np.all(got[:, 0::width] <= plain[:, 0::width])
    assert np.any(got[:, 0::width] < plain[:, 0::width])
    assert got[:, 0].max() > 0
    np.testing.assert_allclose(got, ref, atol=FEATURE_ATOL, rtol=1e-5)


@pytest.mark.parametrize("kind,backend", [
    ("minimal", "packed"), ("sazo", "packed"), ("minimal", "pallas")])
def test_extract_scaleset_fused_matches_reference(kind, backend):
    query, search = _scene(seed=12)
    scaleset = [(0.5, (1.0, 0.75))]
    ref = np.asarray(jms.extract_scaleset_fused(
        query, search, scaleset, kind, exclude_radius=E,
        tuning={"backend": backend}))
    got, stats = tms.extract_scaleset_fused(
        query, search, scaleset, kind, exclude_radius=E, backend=backend,
        with_stats=True, device="cpu")
    plain = tms.extract_scaleset_fused(query, search, scaleset, kind,
                                       backend=backend, device="cpu")
    _compare(kind, got.numpy(), ref, plain.numpy())
    assert {k: int(v) for k, v in stats.items()} == {
        "dropped_query": 0, "dropped_candidates": 0, "dropped_search": 0,
        "interp_dropped": 0}


def test_vector_extraction_matches_reference():
    # the interp takes no exclusion (its means are the reference's
    # without it); the extraction's attribute means do
    rng = np.random.default_rng(2)
    cloud = (rng.random((3000, 3)) * (8, 8, 3)).astype(np.float32)
    attrs = np.stack([cloud[:, 2] + 0.05 * rng.standard_normal(3000),
                      rng.random(3000)], axis=1).astype(np.float32)
    query = cloud[::3].copy()
    scaleset = [(0.5, (1.0, 0.75))]
    ref = np.asarray(jms.extract_scaleset_fused(
        query, cloud, scaleset, "vector", attributes=attrs,
        exclude_radius=E, tuning={"backend": "packed"}))
    got = tms.extract_scaleset_fused(
        query, cloud, scaleset, "vector", attributes=attrs,
        exclude_radius=E, device="cpu").numpy()
    plain = tms.extract_scaleset_fused(
        query, cloud, scaleset, "vector", attributes=attrs,
        device="cpu").numpy()
    assert got.shape == ref.shape == (len(query), 2 * 2)
    tol = np.tile(attr_tolerance(attrs, 2 * 4096), 2)
    assert np.all(np.abs(got - ref) <= tol)
    # the exclusion moves the means past the rounding tolerance (it
    # drops each query's nearest centers)
    assert np.any(np.abs(got - plain) > tol)


@pytest.mark.parametrize("exclude_radius", [0.0, E])
def test_tiled_features_match_reference(exclude_radius):
    query, search = _clouds()
    radii = (1.0, 0.6)
    kw = dict(query_tile_factor=2, entry_batch=16)
    problem = tgrid.build_tiled_problem(query, search, 1.0, **kw)
    jproblem = jgrid.build_tiled_problem(query, search, 1.0, **kw)
    ref = np.asarray(jgrid.tiled_features(
        jproblem, query, search, radii, "minimal",
        exclude_radius=exclude_radius, entry_batch=16, backend="pallas"))
    got = tgrid.tiled_features(problem, query, search, radii, "minimal",
                               exclude_radius=exclude_radius,
                               entry_batch=16, backend="pallas",
                               device="cpu").numpy()
    plain = tgrid.tiled_features(problem, query, search, radii, "minimal",
                                 entry_batch=16, backend="pallas",
                                 device="cpu").numpy()
    if exclude_radius == 0.0:
        # the clamp passes every pair at 0: exactly the plain features
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, ref, atol=FEATURE_ATOL, rtol=1e-5)
    else:
        _compare("minimal", got, ref, plain)


def test_extract_scaleset_wrappers_take_the_fused_path():
    query, search = _scene(n_search=17000, n_query=600, seed=3)
    scaleset = [(0.5, (1.0,))]
    fused = tms.extract_scaleset_fused(query, search, scaleset, "geometric",
                                       exclude_radius=E, device="cpu")
    for method in ("auto", "fused"):
        got = tms.extract_scaleset_device(query, search, scaleset,
                                          exclude_radius=E, method=method,
                                          device="cpu")
        assert np.array_equal(got.numpy(), fused.numpy())
    host = tms.extract_scaleset(query, search, scaleset, exclude_radius=E,
                                device="cpu")
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, fused.numpy())
    # below TILED_THRESHOLD "auto" is the reference's dense method, and
    # "dense" / "tiled" are its methods, each with the exclusion; the
    # fused path refuses an edge-0 band (the other methods take it)
    small = search[:5000]
    for method in ("dense", "tiled"):
        got = tms.extract_scaleset_device(query, small, scaleset,
                                          exclude_radius=E, method=method,
                                          device="cpu").numpy()
        if method == "dense":
            np.testing.assert_array_equal(tms.extract_scaleset_device(
                query, small, scaleset, exclude_radius=E, method="auto",
                device="cpu").numpy(), got)
        ref = np.asarray(jms.extract_scaleset_device(
            query, small, scaleset, exclude_radius=E, method=method))
        plain = tms.extract_scaleset_device(query, small, scaleset,
                                            method=method, device="cpu")
        _compare("geometric", got, ref, plain.numpy())
    with pytest.raises(ValueError, match="voxel edges"):
        tms.extract_scaleset_device(query, search, [(0.0, (1.0,))],
                                    method="fused", device="cpu")
    with pytest.raises(ValueError, match="method"):
        tms.extract_scaleset_device(query, search, scaleset,
                                    method="knn", device="cpu")
