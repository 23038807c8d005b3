"""
The port's explicit neighbor retrieval and kNN features
(``nimrud_tpu_torch.ops.neighbors``, ``features.knn``) against the JAX
package on the same seeded inputs, on the CPU.

* The four cases of ``tests/test_neighbors.py``: indices, ``valid`` and
  ``count`` equal to the reference's, distances within 1e-6 (the
  reference's ``sqrt`` is not correctly rounded on the CPU: one ulp),
  and the reference tests' own cKDTree checks on the port's output.
* Ties: equidistant candidates on an exactly representable 1/8 m grid,
  k smaller than the tie group -- the indices are the reference's
  (``lax.top_k`` puts the lower candidate position first; the port keys
  its selection on (d2 bits, position)).
* The radius boundary: a candidate at exactly ``f32(r*r)`` is in, one
  ulp past it out, in both packages.
* The fused multiply-add of the expanded ``d2`` on a double-rounding
  case, and ``d2`` bit-equal to the reference's on random entries.
* ``knn_features`` (``tests/test_knn_eigen.py:16-55``): against the
  reference and its float64 oracle within those tests' tolerances.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial import cKDTree

from nimrud_tpu.features.knn import knn_features as j_knn_features
from nimrud_tpu.ops import neighbors as jnb

from nimrud_tpu_torch.features.knn import knn_features
from nimrud_tpu_torch.ops import neighbors as tnb
from torch_neighbor_cases import boundary_radius, tie_case
from torch_thread_cases import one_torch_thread  # noqa: F401


def _same(ref, got, keys=("indices", "valid", "count", "overflowed")):
    """Integer outputs equal, distances within 1e-6 (inf where the
    reference's are)."""
    for key in keys:
        if key in ref:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    a, b = ref["distances"], got["distances"]
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a)
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= 1e-6


def _both(fn, *args, **kwargs):
    ref = getattr(jnb, fn)(*args, **kwargs)
    return ref, getattr(tnb, fn)(*args, device="cpu", **kwargs)


def test_radius_neighbors_match_reference_and_kdtree():
    rng = np.random.default_rng(10)
    query = (rng.random((300, 3)) * 6).astype(np.float32)
    search = (rng.random((2000, 3)) * 6).astype(np.float32)
    radius = 0.7
    ref, got = _both("radius_neighbors", query, search, radius, k_max=64)
    _same(ref, got)
    oracle = cKDTree(search.astype(np.float64)).query_ball_point(
        query.astype(np.float64), radius)
    for i, idx in enumerate(oracle):
        assert abs(got["count"][i] - len(idx)) <= 1      # fp boundary
        if got["count"][i] == len(idx):
            assert set(got["indices"][i][got["valid"][i]].tolist()) \
                == set(idx), f"query {i}"
    assert not got["overflowed"].any()


def test_radius_neighbors_truncation_flagged():
    rng = np.random.default_rng(11)
    search = rng.normal(0, 0.1, (500, 3)).astype(np.float32)
    query = np.zeros((1, 3), np.float32)
    ref, got = _both("radius_neighbors", query, search, 1.0, k_max=16)
    _same(ref, got)
    assert got["overflowed"][0] and got["count"][0] > 16
    nearest = np.sort(np.linalg.norm(search, axis=1))[:16]
    assert np.allclose(np.sort(got["distances"][0]), nearest, atol=1e-4)


def test_knn_matches_reference_and_kdtree():
    rng = np.random.default_rng(12)
    query = (rng.random((200, 3)) * 5).astype(np.float32)
    search = (rng.random((3000, 3)) * 5).astype(np.float32)
    k = 8
    ref, got = _both("knn", query, search, k, max_radius=2.0)
    _same(ref, got)
    dist, idx = cKDTree(search.astype(np.float64)).query(
        query.astype(np.float64), k=k)
    assert (dist <= 2.0).all()
    assert np.allclose(got["distances"], dist, atol=1e-4)
    mismatch = got["indices"] != idx
    assert np.allclose(got["distances"][mismatch], dist[mismatch],
                       atol=1e-4)


def test_knn_horizon_masks():
    search = np.array([[0, 0, 0], [10, 10, 10]], np.float32)
    query = np.zeros((1, 3), np.float32)
    ref, got = _both("knn", query, search, k=4, max_radius=1.0)
    _same(ref, got)
    assert got["valid"][0].sum() == 1 and got["indices"][0][0] == 0


def test_ties_fall_as_the_reference_top_k():
    # every query sits at a cell center of the 1/8 m grid: its 8 corner
    # points are equidistant, and k = 5 splits that tie group (radius
    # 0.125 holds the 8 corners only: k_max 6 splits it too)
    query, search = tie_case()
    ref, got = _both("knn", query, search, 5, max_radius=0.5)
    _same(ref, got)
    ties = np.isclose(got["distances"][:, :, None],
                      got["distances"][:, None, :]).sum(-1) > 1
    assert ties.any(1).mean() > 0.9, "test construction: no tie groups"
    ref, got = _both("radius_neighbors", query, search, 0.125, k_max=6)
    _same(ref, got)
    assert got["overflowed"].any()


def test_radius_boundary_at_f32_r_squared():
    # radius chosen so that f32(r*r) is one pair's computed d2 exactly:
    # that candidate is in, and at one ulp less it is out
    query, search, target, radius, d2 = boundary_radius()
    ref, got = _both("radius_neighbors", query, search, radius, k_max=64)
    _same(ref, got)
    r2 = np.float32(radius * radius)
    assert target in set(got["indices"][0][got["valid"][0]].tolist())
    assert got["count"][0] == sum(v <= r2 for v in d2.values())
    query, search, target, radius, _ = boundary_radius(below=True)
    ref, got = _both("radius_neighbors", query, search, radius, k_max=64)
    _same(ref, got)
    assert target not in set(got["indices"][0][got["valid"][0]].tolist())


def test_fma_rounds_once():
    # exact a*b + c = 1 + 3 * 2^-24 - 2^-70: just below the midpoint of
    # 1 + 2^-23 and 1 + 2^-22; a float64 sum rounds onto the midpoint and
    # then to even (1 + 2^-22), one fused rounding gives 1 + 2^-23
    a = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    b = torch.tensor([2.0 ** -24 * (1 - 2.0 ** -23)], dtype=torch.float32)
    c = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    naive = (a.double() * b.double() + c.double()).float()
    assert float(naive) == 1 + 2.0 ** -22
    assert float(tnb.fma(a, b, c)) == 1 + 2.0 ** -23
    assert float(tnb.fma(-a, b, -c)) == -(1 + 2.0 ** -23)


def test_expanded_d2_is_the_reference_bits():
    rng = np.random.default_rng(13)
    q = (rng.random((4, 16, 3)) * 8 - 4).astype(np.float32)
    s = (rng.random((4, 64, 3)) * 8 - 4).astype(np.float32)

    @jax.jit
    def ref(q_local, s_local):       # nimrud_tpu/ops/neighbors.py:49-55
        d2 = (jnp.sum(q_local * q_local, axis=-1)[:, :, None]
              + jnp.sum(s_local * s_local, axis=-1)[:, None, :]
              - 2.0 * jnp.einsum("bqd,bsd->bqs", q_local, s_local,
                                 preferred_element_type=jnp.float32,
                                 precision=jax.lax.Precision.HIGHEST))
        return jnp.maximum(d2, 0.0)

    got = tnb._expanded_d2(torch.as_tensor(q), torch.as_tensor(s)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref(q, s)))


def test_unknown_mode_and_kind_raise():
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError):
        tnb.neighbor_search(pts, pts, 2, 1.0, "ball", device="cpu")
    with pytest.raises(ValueError):
        knn_features(pts, pts, 2, 1.0, kind="covariance", device="cpu")


def test_knn_features_match_reference_and_oracle():
    rng = np.random.default_rng(14)
    query = (rng.random((200, 3)) * 5).astype(np.float32)
    search = (rng.random((4000, 3)) * 5).astype(np.float32)
    k = 12
    feats = knn_features(query, search, k, max_radius=2.0, device="cpu")
    ref = np.asarray(j_knn_features(query, search, k, max_radius=2.0))
    assert feats.shape == (200, 4) and feats.dtype == np.float32
    np.testing.assert_array_equal(feats[:, 0], ref[:, 0])
    assert np.abs(feats - ref).max() < 1e-4
    dist, idx = cKDTree(search.astype(np.float64)).query(
        query.astype(np.float64), k=k)
    for qi in range(0, 200, 13):
        pts = search[idx[qi]].astype(np.float64)
        assert feats[qi, 0] == k
        mean = pts.mean(0)
        assert abs(feats[qi, 1] - np.linalg.norm(query[qi] - mean)) < 1e-4
        centered = pts - mean
        eigs = np.linalg.eigvalsh(centered.T @ centered / k)
        eigs = eigs / eigs.sum()
        assert abs(feats[qi, 2] - eigs[2]) < 1e-3
        assert abs(feats[qi, 3] - eigs[1]) < 1e-3


def test_knn_features_horizon():
    search = np.array([[0, 0, 0], [0.1, 0, 0], [9, 9, 9]], np.float32)
    query = np.zeros((1, 3), np.float32)
    feats = knn_features(query, search, k=3, max_radius=1.0, device="cpu")
    np.testing.assert_array_equal(
        feats, np.asarray(j_knn_features(query, search, k=3,
                                         max_radius=1.0)))
    assert feats[0, 0] == 2       # third point beyond the horizon


def test_knn_eigen_kind():
    rng = np.random.default_rng(15)
    query = (rng.random((50, 3)) * 3).astype(np.float32)
    search = (rng.random((2000, 3)) * 3).astype(np.float32)
    feats = knn_features(query, search, 16, max_radius=2.0, kind="eigen",
                         device="cpu")
    ref = np.asarray(j_knn_features(query, search, 16, max_radius=2.0,
                                    kind="eigen"))
    assert feats.shape == (50, 10)
    assert np.all(feats[:, 0] == 16) and np.isfinite(feats).all()
    np.testing.assert_allclose(feats, ref, rtol=5e-3, atol=5e-3)
