"""
The XLA tile path against the JAX package on the same NumPy inputs:

* ``grid.tiled_moments`` (both metrics, attributes, sazo): counts and
  sazo values equal (both paths form the difference-form ``d2`` and
  ``dz`` of the entry-local coordinates one operation at a time), means
  within 5e-5, central moments within 2e-4, attribute means within 2e-5
  (``test_torch_xla_moments.py``'s tolerances);
* ``grid.tiled_features(backend="xla")`` for every layout, chebyshev and
  attributes: densities within an ulp, the other columns within the
  cross-backend feature tolerance after ``layouts.reconcile``
  (``test_torch_kinds_paths._compare``); ``vector`` within 2e-5;
* R1: ``tiled_features`` without a backend is the XLA path, equal to
  the reference's default, and ``backend="pallas"`` takes the entry
  kernel only where the reference's branch does (euclidean, no
  attributes, no sazo);
* ``device_grid.build_tables`` (every table and both counters equal,
  with and without overflow) and ``device_grid.fused_extract``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops import grid as jgrid

from nimrud_tpu_torch.ops import device_grid as tdg
from nimrud_tpu_torch.ops import grid as tgrid
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as tmk
from test_torch_grid import _clouds
from test_torch_kinds_paths import _compare
from test_torch_xla_moments import ATTR_ATOL, COV_ATOL, MEAN_ATOL

from torch_thread_cases import one_torch_thread  # noqa: F401

RADII = (1.0, 0.6)
KW = dict(query_tile_factor=2, entry_batch=16)
ALL_KINDS = ["minimal", "geometric", "oriented", "covariance", "eigen",
             "sazo"]


@pytest.fixture(scope="module")
def tiled():
    query, search = _clouds(n_search=1500, n_query=400, seed=6)
    attrs = np.random.default_rng(6).random((len(search), 3)).astype(
        np.float32)
    return (query, search, attrs,
            tgrid.build_tiled_problem(query, search, 1.0, **KW),
            jgrid.build_tiled_problem(query, search, 1.0, **KW))


@pytest.mark.parametrize("metric,attrs,sazo", [
    ("euclidean", False, True), ("chebyshev", True, False),
    ("euclidean", True, False)])
def test_tiled_moments_match_reference(tiled, metric, attrs, sazo):
    query, search, attributes, problem, jproblem = tiled
    kw = dict(attributes=attributes if attrs else None, metric=metric,
              with_sazo=sazo, entry_batch=16, exclude_radius=0.2)
    ref = jgrid.tiled_moments(jproblem, query, search, RADII, **kw)
    got = tgrid.tiled_moments(problem, query, search, RADII, device="cpu",
                              **kw)
    assert set(got) == set(ref)
    for key, value in ref.items():
        if key in ("count", "sazo"):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            atol = {"mean": MEAN_ATOL, "cov": COV_ATOL,
                    "attr_mean": ATTR_ATOL}[key]
            np.testing.assert_allclose(got[key], value, atol=atol,
                                       err_msg=key)
    assert got["count"].max() > 1


@pytest.mark.parametrize("kind", ALL_KINDS)
@pytest.mark.parametrize("metric", ["euclidean", "chebyshev"])
def test_tiled_features_xla_match_reference(tiled, kind, metric):
    query, search, _, problem, jproblem = tiled
    ref = np.asarray(jgrid.tiled_features(
        jproblem, query, search, RADII, kind, entry_batch=16, metric=metric))
    got = tgrid.tiled_features(problem, query, search, RADII, kind,
                               entry_batch=16, metric=metric,
                               device="cpu").numpy()
    _compare(kind, got, ref)


def test_tiled_vector_and_the_default_backend(tiled):
    query, search, attrs, problem, jproblem = tiled
    for metric in ("euclidean", "chebyshev"):
        ref = np.asarray(jgrid.tiled_features(
            jproblem, query, search, RADII, "vector", attributes=attrs,
            entry_batch=16, metric=metric))
        got = tgrid.tiled_features(problem, query, search, RADII, "vector",
                                   attributes=attrs, entry_batch=16,
                                   metric=metric, device="cpu").numpy()
        assert got.shape == (len(query), 3 * len(RADII))
        np.testing.assert_allclose(got, ref, atol=ATTR_ATOL)
    with pytest.raises(ValueError, match="requires attributes"):
        tgrid.tiled_features(problem, query, search, RADII, "vector",
                             device="cpu")

    # R1: no backend named is the reference's default, the XLA path --
    # not the entry kernel, whose expanded-form d2 counts otherwise at
    # the ball's boundary
    ref = np.asarray(jgrid.tiled_features(jproblem, query, search, RADII,
                                          "minimal", entry_batch=16))
    got = tgrid.tiled_features(problem, query, search, RADII, "minimal",
                               entry_batch=16, device="cpu").numpy()
    xla = tgrid.tiled_features(problem, query, search, RADII, "minimal",
                               entry_batch=16, backend="xla",
                               device="cpu").numpy()
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got[:, 0::4], ref[:, 0::4])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)
    for name in ("high", "default", "mixed"):
        np.testing.assert_array_equal(tgrid.tiled_features(
            problem, query, search, RADII, "minimal", entry_batch=16,
            precision=name, device="cpu").numpy(), got)


def test_pallas_backend_routes_as_the_reference(tiled, monkeypatch):
    # the entry kernel runs for euclidean geometry layouts only; sazo,
    # attributes and chebyshev take the XLA sums on backend="pallas"
    query, search, attrs, problem, jproblem = tiled
    calls = []
    real = tmk.entry_moments

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tmk, "entry_moments", counted)
    for kind, kw, kernel in (
            ("minimal", {}, True), ("sazo", {}, False),
            ("vector", {"attributes": attrs}, False),
            ("minimal", {"metric": "chebyshev"}, False)):
        calls.clear()
        ref = np.asarray(jgrid.tiled_features(
            jproblem, query, search, RADII, kind, entry_batch=16,
            backend="pallas", **kw))
        got = tgrid.tiled_features(problem, query, search, RADII, kind,
                                   entry_batch=16, backend="pallas",
                                   device="cpu", **kw).numpy()
        assert bool(calls) == kernel, (kind, kw)
        if kind == "vector":
            np.testing.assert_allclose(got, ref, atol=ATTR_ATOL)
        else:
            _compare(kind, got, ref)
    with pytest.raises(ValueError, match="backend"):
        tgrid.tiled_features(problem, query, search, RADII, "minimal",
                             backend="packed", device="cpu")


def _tables_inputs(seed, n_query=300, n_search=900, extent=(6, 6, 2)):
    rng = np.random.default_rng(seed)
    search = (rng.random((n_search, 3)) * extent).astype(np.float32)
    query = (rng.random((n_query, 3)) * extent).astype(np.float32)
    q_valid = np.arange(n_query) < n_query - 7
    s_valid = np.arange(n_search) < n_search - 11
    return query, q_valid, search, s_valid


@pytest.mark.parametrize("s_cap,q_cap,e_cap", [
    (None, 64, None), (8, 32, None), (None, 16, 32)])
def test_build_tables_match_reference(s_cap, q_cap, e_cap):
    # (8, ...): fine tiles past s_cap drop search points; (.., 32): the
    # entry capacity drops queries
    query, q_valid, search, s_valid = _tables_inputs(seed=8)
    kw = dict(n_query=len(query), q_cap=q_cap, entry_batch=16, m=2,
              s_cap=s_cap, voxel_edge=None if s_cap else 0.25)
    jspec = jdg.make_spec(search.min(0), search.max(0), 0.6, **kw)
    if e_cap is not None:
        import dataclasses
        jspec = dataclasses.replace(jspec, e_cap=e_cap)
    tspec = tdg.DeviceGridSpec(**jspec.__dict__)
    ref = jdg.build_tables(jnp.asarray(query), jnp.asarray(q_valid),
                           jnp.asarray(search), jnp.asarray(s_valid), jspec,
                           with_stats=True)
    got = tdg.build_tables(torch.from_numpy(query), torch.from_numpy(q_valid),
                           torch.from_numpy(search),
                           torch.from_numpy(s_valid), tspec, with_stats=True)
    for name, r, g in zip(("query_index", "neighbor_rows", "candidates"),
                          ref[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    counters = {k: (int(ref[4][k]), int(got[4][k])) for k in ref[4]}
    assert set(got[4]) == set(ref[4])
    assert all(r == g for r, g in counters.values()), counters
    if s_cap == 8:
        assert counters["dropped_search"][0] > 0
    if e_cap is not None:
        assert counters["dropped_query"][0] > 0


@pytest.mark.parametrize("kind,metric,attrs", [
    ("minimal", "euclidean", False), ("sazo", "euclidean", False),
    ("eigen", "chebyshev", False), ("vector", "chebyshev", True)])
def test_fused_extract_matches_reference(kind, metric, attrs):
    query, q_valid, search, s_valid = _tables_inputs(seed=9)
    attributes = np.random.default_rng(9).random((len(search), 2)).astype(
        np.float32)
    jspec = jdg.with_entry_estimate(jdg.make_spec(
        search.min(0), search.max(0), 0.6, n_query=len(query), s_cap=16,
        q_cap=64, entry_batch=16, m=2), query)
    tspec = tdg.DeviceGridSpec(**jspec.__dict__)
    n_out = len(query) - 3
    ref, jstats = jdg.fused_extract(
        jnp.asarray(query), jnp.asarray(q_valid), jnp.asarray(search),
        jnp.asarray(s_valid), jspec, RADII[:1] + (0.45,), kind, 0.1,
        "highest", n_out, True,
        jnp.asarray(attributes) if attrs else None, metric)
    got, tstats = tdg.fused_extract(
        torch.from_numpy(query), torch.from_numpy(q_valid),
        torch.from_numpy(search), torch.from_numpy(s_valid), tspec,
        RADII[:1] + (0.45,), kind, 0.1, "highest", n_out, with_stats=True,
        attributes=torch.from_numpy(attributes) if attrs else None,
        metric=metric)
    assert {k: int(v) for k, v in tstats.items()} \
        == {k: int(v) for k, v in jstats.items()}
    if kind == "vector":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=ATTR_ATOL)
    else:
        _compare(kind, got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="precision"):
        tdg.fused_extract(torch.from_numpy(query), torch.from_numpy(q_valid),
                          torch.from_numpy(search), torch.from_numpy(s_valid),
                          tspec, (0.5,), kind, None, "bf16x2", n_out)
