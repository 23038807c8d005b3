"""
The port's eigendecomposition and geometry layouts against the JAX
package on the same NumPy inputs: ``eigh3`` (values within the eigen
tolerance of ``test_torch_ops.py``, vectors up to sign where the
eigenvalues are separated, the degenerate fallback axes bit for bit),
``pack_sym3`` / ``unpack_sym3``, the five layouts of ``build_block``
(degenerate rows included: counts 0, 1 and 2, zero trace, flat
neighborhoods with l3 = 0) and the sazo rows of ``moments_from_slabs``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.features import layouts as jly
from nimrud_tpu.ops import eigen as jeig
from nimrud_tpu.ops.pallas import multiscale_kernel as jmk

from nimrud_tpu_torch.features import layouts as tly
from nimrud_tpu_torch.ops import eigen as teig
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as tmk

SEP = 1e-3          # eigenvalue gap, relative to the largest |eigenvalue|,
                    # above which an eigenvector is compared (up to sign)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pack(cov):
    return np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                     cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]],
                    axis=1).astype(np.float32)


def _covariances(n=4000, seed=7):
    """Random scatter matrices; rows 0-99 scalar (2 I), 100-199 two
    equal eigenvalues (diag(3, 1, 1)), 200-249 zero, 250-299 rank one
    (two points), 300-399 flat (l3 = 0)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3))
    cov = np.einsum("nij,nkj->nik", a, a)
    cov[:100] = np.diag([2.0, 2.0, 2.0])
    cov[100:200] = np.diag([3.0, 1.0, 1.0])
    cov[200:250] = 0.0
    d = rng.integers(-8, 9, (50, 3)) / 8.0
    cov[250:300] = np.einsum("ni,nj->nij", d, d) / 4.0
    flat = rng.normal(size=(100, 3, 2)) * np.array([1, 1, 0])[:, None]
    cov[300:400] = np.einsum("nij,nkj->nik", flat, flat)
    return cov, _pack(cov)


def _separated(vals, k):
    """Rows whose eigenvalue k is apart from the others by SEP."""
    scale = np.abs(vals).max(axis=1) + 1e-30
    gaps = np.abs(vals - vals[:, k:k + 1])
    gaps[:, k] = np.inf
    return gaps.min(axis=1) > SEP * scale


def _up_to_sign(got, ref):
    """Rowwise distance of two vector sets (..., d) up to a sign."""
    return np.minimum(np.abs(got - ref).max(-1), np.abs(got + ref).max(-1))


def test_eigh3_matches_reference():
    cov, m6 = _covariances()
    t_vals, t_vecs = (x.numpy() for x in teig.eigh3(_t(m6)))
    j_vals, j_vecs = (np.asarray(x) for x in jeig.eigh3(jnp.asarray(m6)))
    scale = np.abs(j_vals).max(axis=1, keepdims=True) + 1.0
    assert np.all(np.abs(t_vals - j_vals) <= 1e-5 * scale)
    np.testing.assert_allclose(np.linalg.norm(t_vecs, axis=-1), 1.0,
                               atol=1e-5)
    for k in range(3):
        ok = _separated(j_vals, k)
        assert ok.sum() > 3000
        assert np.all(_up_to_sign(t_vecs[ok, k], j_vecs[ok, k]) <= 1e-3)
        # each separated vector is an eigenvector (float64 residual)
        v = t_vecs[ok, k].astype(np.float64)
        resid = np.einsum("nij,nj->ni", cov[ok], v) - t_vals[ok, k, None] * v
        assert np.all(np.abs(resid).max(1) <= 1e-3 * scale[ok, 0])
    # the fallback axes, bit for bit: a scalar matrix and the zero matrix
    # give (z, y, z), diag(3, 1, 1) gives (x, y, z)
    for rows, axes in ((slice(0, 100), [2, 1, 2]),
                       (slice(200, 250), [2, 1, 2]),
                       (slice(100, 200), [0, 1, 2])):
        np.testing.assert_array_equal(t_vecs[rows], j_vecs[rows])
        np.testing.assert_array_equal(t_vecs[rows],
                                      np.broadcast_to(np.eye(3)[axes],
                                                      t_vecs[rows].shape))


def test_pack_unpack_sym3_round_trip():
    cov, m6 = _covariances()
    full = teig.unpack_sym3(_t(m6))
    np.testing.assert_array_equal(full.numpy(), cov.astype(np.float32))
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jeig.unpack_sym3(jnp.asarray(m6))))
    np.testing.assert_array_equal(teig.pack_sym3(full).numpy(), m6)
    np.testing.assert_array_equal(
        teig.pack_sym3(full).numpy(),
        np.asarray(jeig.pack_sym3(jnp.asarray(full.numpy()))))


def _stats(n=4000, seed=11):
    """Layout inputs; counts 0 / 1 / 2 among the first rows, the rank-one
    covariances at count 2, the flat ones at count 9."""
    rng = np.random.default_rng(seed)
    cov, m6 = _covariances(n, seed)
    count = rng.integers(3, 40, n).astype(np.float32)
    count[200:250] = rng.choice([0.0, 1.0, 5.0], 50)     # zero trace
    count[250:300] = 2.0
    count[300:400] = 9.0
    count[400:450] = 0.0
    count[450:500] = 1.0
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    query = rng.normal(size=(n, 3)).astype(np.float32)
    sazo = np.where(count > 0, rng.normal(size=n), 0.0).astype(np.float32)
    return count, mean, m6, query, sazo


COLUMNS = {                      # the columns each check holds, per kind
    "geometric": {"eig": [2, 3]},
    "oriented": {"eig": [2, 3], "vec": [(4, 5), (6, 7)]},
    "covariance": {"scatter": [2, 3, 4, 5, 6, 7]},
    "eigen": {"eig": [2, 3, 4, 6, 9], "log": [7], "cbrt": [5],
              "trace": [8]},
    "sazo": {"eig": [2, 3], "sazo": [4]},
}


@pytest.mark.parametrize("kind", sorted(COLUMNS))
@pytest.mark.parametrize("radius", [0.5, 2.0])
def test_block_matches_reference(kind, radius):
    count, mean, m6, query, sazo = _stats()
    args = (count, mean, m6, query)
    got = tly.build_block(kind, *map(_t, args), radius,
                          sazo=_t(sazo)).numpy()
    ref = np.asarray(jly.build_block(kind, *map(jnp.asarray, args), radius,
                                     sazo=jnp.asarray(sazo)))
    assert got.shape == ref.shape == (len(count), tly.LAYOUT_WIDTHS[kind])
    assert np.all(np.isfinite(got))
    # density: the same f32 division; centroid: minimal's tolerance
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1], ref[:, 1], atol=1e-5)
    np.testing.assert_array_equal(got[count == 0, 1], 0.0)
    cols = COLUMNS[kind]
    # normalized eigenvalue features and ratios: the eigvalsh3 tolerance
    np.testing.assert_allclose(got[:, cols.get("eig", [])],
                               ref[:, cols.get("eig", [])], atol=1e-5)
    # the scatter matrix and the sazo column: the same f32 products
    for key in ("scatter", "sazo"):
        np.testing.assert_array_equal(got[:, cols.get(key, [])],
                                      ref[:, cols.get(key, [])])
    trace = m6[:, 0] + m6[:, 3] + m6[:, 5]
    np.testing.assert_allclose(got[:, cols.get("trace", [])],
                               ref[:, cols.get("trace", [])], rtol=1e-6)
    # eigenentropy (log of p >= 1e-12)
    np.testing.assert_allclose(got[:, cols.get("log", [])],
                               ref[:, cols.get("log", [])], atol=1e-5)
    vals = np.asarray(jeig.eigvalsh3(jnp.asarray(m6))).astype(np.float64)
    for c in cols.get("cbrt", []):
        # omnivariance: torch.pow(x, 1/3) for jnp.cbrt (1 ulp apart), of
        # l1 l2 l3, whose eigenvalues the two eigensolvers give within
        # 1e-5 (|l1| + 1) each: near l3 = 0 the cube root magnifies that
        # to cbrt(|l1 l2| 1e-5 (|l1| + 1)) / trace
        l1, l2 = np.abs(vals[:, 0]), np.abs(vals[:, 1])
        tol = np.cbrt(l1 * l2 * 1e-5 * (l1 + 1.0)) / np.where(
            trace > 0, trace, 1.0)
        assert np.all(np.abs(got[:, c] - ref[:, c]) <= tol + 1e-6)
        # where l3 is well away from 0 the two agree to f32 rounding
        clear = vals[:, 2] > 1e-2 * l1
        assert clear.sum() > 1000
        np.testing.assert_allclose(got[clear, c], ref[clear, c], rtol=1e-4)
    for x, y in cols.get("vec", []):
        # vectors: signs are arbitrary; compared where their eigenvalue is
        # separated (eig_s0 is the smallest, eig_s1 the middle one)
        vals = np.asarray(jeig.eigvalsh3(jnp.asarray(m6)))
        k = 2 if x == 4 else 1
        ok = _separated(vals, k) & (count >= 2) & (trace > 0)
        assert ok.sum() > 3000
        assert np.all(_up_to_sign(got[ok][:, [x, y]],
                                  ref[ok][:, [x, y]]) <= 1e-3)
    # undefined rows (fewer than two points or zero trace) are zeros
    # past the centroid, except the sazo column
    gated = (count < 2) | (trace <= 0)
    assert gated.sum() >= 150
    shape_cols = [c for c in range(2, got.shape[1])
                  if c not in cols.get("sazo", [])
                  and c not in cols.get("scatter", [])]
    assert np.all(got[gated][:, shape_cols] == 0)
    assert np.all(ref[gated][:, shape_cols] == 0)


def test_degenerate_fallback_vectors_in_oriented_block():
    # the scalar and the two-equal rows keep their fallback axes bit for
    # bit in the served columns (rows 0-199 at counts >= 3)
    count, mean, m6, query, _ = _stats()
    args = (count[:200], mean[:200], m6[:200], query[:200])
    got = tly.oriented_block(*map(_t, args), 1.0).numpy()
    ref = np.asarray(jly.oriented_block(*map(jnp.asarray, args), 1.0))
    np.testing.assert_array_equal(got[:, 4:], ref[:, 4:])
    np.testing.assert_array_equal(got[:100, 4:], [[0, 0, 0, 1]] * 100)
    np.testing.assert_array_equal(got[100:, 4:], [[0, 0, 0, 1]] * 100)


def test_unported_and_unknown_layouts_raise():
    count, mean, m6, query, _ = (a[:10] for a in _stats())
    args = tuple(map(_t, (count, mean, m6, query)))
    # vector is no build_block layout: the extraction hands the kernel's
    # attribute means on as they are, and the reference refuses it alike
    with pytest.raises(ValueError, match="unknown feature layout"):
        tly.build_block("vector", *args, 1.0)
    with pytest.raises(ValueError, match="unknown feature layout"):
        jly.build_block("vector", *map(jnp.asarray, (count, mean, m6,
                                                     query)), 1.0)
    with pytest.raises(ValueError, match="sazo statistic"):
        tly.build_block("sazo", *args, 1.0)
    with pytest.raises(ValueError, match="unknown"):
        tly.build_block("spherical", *args, 1.0)


def test_moments_from_slabs_sazo_matches_reference():
    rng = np.random.default_rng(12)
    radii = (0.8, 0.4, 1.2)
    slabs = rng.normal(size=(5, 16, 3 * tmk.MOMENT_PAD)).astype(np.float32)
    slabs[..., 0::tmk.MOMENT_PAD] = rng.integers(0, 30, (5, 16, 3))
    hi = slabs[..., 10::tmk.MOMENT_PAD]
    lo = slabs[..., 11::tmk.MOMENT_PAD]
    hi[0, :4] = 0.75                          # ties hi == -lo
    lo[0, :4] = -0.75
    slabs[0, :4, 0::tmk.MOMENT_PAD] = 3.0
    hi[1, :4], lo[1, :4] = -1.0e30, 1.0e30    # empty: the folds' identities
    slabs[1, :4, 0::tmk.MOMENT_PAD] = 0.0
    centers = rng.normal(size=(5, 3)).astype(np.float32)
    got = tmk.moments_from_slabs(_t(slabs), _t(centers), radii,
                                 with_sazo=True)
    ref = jmk.moments_from_slabs(jnp.asarray(slabs), jnp.asarray(centers),
                                 radii, with_sazo=True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["sazo"].numpy(),
                                      np.asarray(r["sazo"]))
        np.testing.assert_array_equal(g["sazo"][0, :4].numpy(), 0.75)
        np.testing.assert_array_equal(g["sazo"][1, :4].numpy(), 0.0)
        for key in ("count", "mean_local", "mean", "cov"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]),
                                       atol=1e-5, err_msg=key)
    assert "sazo" not in tmk.moments_from_slabs(_t(slabs), _t(centers),
                                                radii)[0]


def test_reconcile_turns_signs_and_takes_rounding_bound_columns():
    # oriented rows of the same neighborhoods: a separated smallest
    # vector (mostly x) turned over (row 0); the middle vector of a
    # neighborhood with two equal eigenvalues pointing elsewhere in its
    # plane (row 1); eigen rows at l3 / trace ~ 0 (row 1) and not (row
    # 0); other kinds pass through
    count, mean, m6, query, _ = (a[:2] for a in _stats())
    m6 = np.array([[1.0, 0.1, 0.0, 2.0, 0.0, 3.0],
                   [1.0, 0.0, 0.0, 1.0, 0.0, 1e-9]], np.float32)
    args = tuple(map(_t, (count, mean, m6, query)))
    ref = tly.oriented_block(*args, 1.0)
    assert bool((ref[0, 4:6].abs() > 0.09).all())
    got = ref.clone()
    got[0, 4:6] *= -1
    got[1, 6:8] = torch.tensor([0.6, 0.8])
    rec, flipped, taken = tly.reconcile("oriented", got, ref)
    assert torch.equal(rec, ref)
    assert flipped.tolist() == [True, False]
    assert taken.tolist() == [False, True]
    ref = tly.eigen_block(*args, 1.0)
    got = ref + 1e-4
    rec, flipped, taken = tly.reconcile("eigen", got, ref)
    assert torch.equal(rec[1, 2:], ref[1, 2:]) and taken.tolist() == [
        False, True] and not flipped.any()
    assert torch.equal(rec[0], got[0]) and torch.equal(rec[:, :2],
                                                         got[:, :2])
    rec, flipped, taken = tly.reconcile("geometric", got[:, :4], ref[:, :4])
    assert torch.equal(rec, got[:, :4]) and not (flipped | taken).any()
