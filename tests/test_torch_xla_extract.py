"""
The public extraction entry points on every method, against the JAX
package on the same NumPy inputs:

* ``extract_scaleset_device`` / ``extract_scaleset`` with ``method``
  "dense", "tiled", "auto" (below ``TILED_THRESHOLD``: the dense method,
  as the reference takes it on every platform) and "fused" on the XLA
  backend, each with a band of voxel edge 0 where the method takes one:
  densities within an ulp, the other columns within the cross-backend
  feature tolerance after ``layouts.reconcile``
  (``test_torch_kinds_paths._compare``), ``vector`` means within 2e-5;
* ``extract_scaleset_fused``'s per-band routing: ``sazo`` and ``vector``
  on ``backend="pallas"`` and ``vector`` past 6 columns on
  ``backend="packed"`` take XLA bands (no kernel launch), the
  ``interp_backend`` rule, and the overflow counters;
* ``features/minimal`` against the float64 oracle of
  ``tests/test_minimal_parity.py`` (populations exact, centroids within
  5e-5, normalized eigenvalues within 5e-4: that file's tolerances).
"""

import numpy as np
import pytest

from nimrud_tpu.features import multiscale as jms

from nimrud_tpu_torch.features import minimal as tmin
from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import interp as tint
from nimrud_tpu_torch.ops.kernels import gather_kernel as tgk
from nimrud_tpu_torch.ops.kernels import packed_moments as tpm
from helpers import minimal_multiscale_oracle
from test_minimal_parity import _make_clouds
from test_torch_kinds_paths import _compare
from test_torch_xla_moments import ATTR_ATOL

from torch_thread_cases import one_torch_thread  # noqa: F401

SCALESET = [(0.5, (1.0, 0.6)), (0.0, (0.4,))]


def _scene(seed=3, n_search=2500, n_query=700):
    rng = np.random.default_rng(seed)
    search = (rng.random((n_search, 3)) * (8, 8, 3)).astype(np.float32)
    query = (rng.random((n_query, 3)) * (8, 8, 3)).astype(np.float32)
    attrs = rng.random((n_search, 9)).astype(np.float32)
    return query, search, attrs


def _hold(kind, got, ref):
    if kind == "vector":
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATTR_ATOL)
    else:
        _compare(kind, got, ref)


@pytest.mark.parametrize("method", ["dense", "tiled", "auto"])
@pytest.mark.parametrize("kind", ["geometric", "sazo"])
def test_dense_and_tiled_methods_match_reference(method, kind):
    query, search, _ = _scene()
    ref = jms.extract_scaleset(query, search, SCALESET, kind, method=method,
                               chunk_size=256)
    got = tms.extract_scaleset(query, search, SCALESET, kind, method=method,
                               chunk_size=256, device="cpu")
    assert isinstance(got, np.ndarray)
    _hold(kind, got, ref)


@pytest.mark.parametrize("method,n_attr", [("dense", 2), ("tiled", 9)])
def test_vector_methods_match_reference(method, n_attr):
    query, search, attrs = _scene(seed=4)
    attrs = attrs[:, :n_attr]
    kw = dict(attributes=attrs, method=method, exclude_radius=0.1)
    ref = jms.extract_scaleset(query, search, SCALESET, "vector", **kw)
    got = tms.extract_scaleset(query, search, SCALESET, "vector",
                               device="cpu", **kw)
    _hold("vector", got, ref)


def test_unsorted_queries_and_fixed_bounds():
    query, search, _ = _scene(seed=6)
    bounds = (search.min(0) - 0.25, search.max(0) + 0.5)
    for kw in ({"sort_queries": False}, {"bounds": bounds}):
        ref = jms.extract_scaleset(query, search, SCALESET[:1], "minimal",
                                   method="dense", **kw)
        got = tms.extract_scaleset(query, search, SCALESET[:1], "minimal",
                                   method="dense", device="cpu", **kw)
        _hold("minimal", got, ref)
    with pytest.raises(ValueError, match="method"):
        tms.extract_scaleset(query, search, SCALESET, method="knn",
                             device="cpu")
    with pytest.raises(ValueError, match="kind"):
        tms.extract_scaleset(query, search, SCALESET, "spherical",
                             device="cpu")
    with pytest.raises(ValueError, match="voxel edges"):
        tms.extract_scaleset(query, search, SCALESET, method="fused",
                             device="cpu")


@pytest.mark.parametrize("kind,backend,n_attr", [
    ("minimal", "xla", 0), ("sazo", "pallas", 0), ("vector", "pallas", 2),
    ("vector", "packed", 7), ("vector", "xla", 9)])
def test_fused_xla_bands_match_reference(kind, backend, n_attr, monkeypatch):
    # the reference's fused path with the same backend routes these bands
    # to its XLA candidate-table path; so does the port, and no kernel
    # wrapper is called on them
    query, search, attrs = _scene(seed=7, n_search=2000, n_query=500)
    attrs = attrs[:, :n_attr] if n_attr else None
    scaleset = SCALESET[:1]
    calls = []
    for name in ("packed_moments", "packed_moments_plain"):
        real = getattr(tpm, name)
        monkeypatch.setattr(tpm, name, lambda *a, _r=real, **k: (
            calls.append(1), _r(*a, **k))[1])
    real_spans = tgk.span_moments
    monkeypatch.setattr(tgk, "span_moments", lambda *a, **k: (
        calls.append(1), real_spans(*a, **k))[1])
    ref = np.asarray(jms.extract_scaleset_fused(
        query, search, scaleset, kind, attributes=attrs,
        tuning={"backend": backend, "vector_s_cap": 16, "entry_batch": 16}))
    got, stats = tms.extract_scaleset_fused(
        query, search, scaleset, kind, attributes=attrs, backend=backend,
        tuning={"vector_s_cap": 16, "entry_batch": 16}, with_stats=True,
        device="cpu")
    assert not calls
    _hold(kind, got.numpy(), ref)
    assert {k: int(v) for k, v in stats.items()} == dict.fromkeys(
        ("dropped_query", "dropped_candidates", "dropped_search",
         "interp_dropped"), 0)


def test_interp_backend_rule(monkeypatch):
    query, search, attrs = _scene(seed=8, n_search=800, n_query=200)
    scaleset = [(0.5, (0.5,))]
    seen = []
    for name in ("interp_to_voxels", "interp_to_voxels_matmul",
                 "packed_interp"):
        real = getattr(tint, name)
        monkeypatch.setattr(tint, name, lambda *a, _n=name, _r=real, **k: (
            seen.append(_n), _r(*a, **k))[1])
    for width, backend, tuning, want in (
            (9, "xla", {}, "interp_to_voxels_matmul"),
            (9, "packed", {}, "interp_to_voxels_matmul"),
            (8, "packed", {}, "interp_to_voxels"),
            (6, "packed", {}, "packed_interp"),
            (2, "xla", {}, "interp_to_voxels"),
            (2, "xla", {"interp_backend": "matmul"},
             "interp_to_voxels_matmul"),
            (2, "packed", {"interp_backend": "gather"}, "interp_to_voxels")):
        seen.clear()
        tms.extract_scaleset_fused(query, search, scaleset, "vector",
                                   attributes=attrs[:, :width],
                                   backend=backend,
                                   tuning={"entry_batch": 16, **tuning},
                                   device="cpu")
        assert seen == [want], (width, backend, tuning, seen)
    with pytest.raises(ValueError, match="interp_backend"):
        tms.extract_scaleset_fused(query, search, scaleset, "vector",
                                   attributes=attrs[:, :2],
                                   tuning={"interp_backend": "knn"},
                                   device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tms.extract_scaleset_fused(query, search, scaleset,
                                   backend="ragged", device="cpu")


def test_minimal_matches_the_float64_oracle():
    edges, radii = (0.4, 0.8), (0.6, 1.2)
    query, search = _make_clouds(n_query=300, n_search=1500, edges=edges,
                                 radii=radii)
    oracle = minimal_multiscale_oracle(query, search, edges, radii)
    ours = tmin.process_single_core(query, search, edges, radii,
                                    device="cpu")
    one = tmin.one_scale_single_core(query, search, edges[0], radii[0],
                                     device="cpu")
    np.testing.assert_array_equal(one, ours[:, :4])
    assert ours.shape == (len(query), 8)
    for s in range(2):
        base = 4 * s
        np.testing.assert_array_equal(ours[:, base], oracle[:, base])
        np.testing.assert_allclose(ours[:, base + 1], oracle[:, base + 1],
                                   atol=5e-5)
        np.testing.assert_allclose(ours[:, base + 2:base + 4],
                                   oracle[:, base + 2:base + 4], atol=5e-4)
