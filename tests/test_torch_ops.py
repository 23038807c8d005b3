"""
The port's tensor ops against the JAX package on the same NumPy inputs:
voxel keys, dedup and search tables exactly; eigenvalues, the minimal
layout and the slab conversion within the JAX tests' own tolerances.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.features import layouts as jly
from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops import eigen as jeig
from nimrud_tpu.ops import packing as jpk
from nimrud_tpu.ops import unique as juq
from nimrud_tpu.ops.pallas import multiscale_kernel as jmk

from nimrud_tpu_torch.features import layouts as tly
from nimrud_tpu_torch.ops import device_grid as tdg
from nimrud_tpu_torch.ops import eigen as teig
from nimrud_tpu_torch.ops import packing as tpk
from nimrud_tpu_torch.ops import unique as tuq
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as tmk


def _points(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    pts = (rng.random((n, 3)) * [20, 15, 4]).astype(np.float32)
    pts[:50] = pts[50:100]            # duplicates share voxels
    return pts


def _valid(n, n_live):
    return np.arange(n) < n_live


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("edge", [0.25, 0.3, 1.0])
def test_encode_decode_equal(edge):
    pts = _points()
    lo, hi = pts.min(0), pts.max(0)
    tspec = tpk.GridSpec.fit_bounds(lo, hi, edge)
    jspec = jpk.GridSpec.fit_bounds(lo, hi, edge)
    tkeys = tspec.encode(_t(pts)).numpy()
    jkeys = np.asarray(jspec.encode(jnp.asarray(pts)))
    np.testing.assert_array_equal(tkeys, jkeys)
    np.testing.assert_array_equal(
        tspec.decode(_t(tkeys)).numpy(),
        np.asarray(jspec.decode(jnp.asarray(jkeys))))


@pytest.mark.parametrize("tiled", [False, True])
def test_unique_voxels_equal(tiled):
    pts = _points()
    valid = _valid(len(pts), len(pts) - 200)
    lo, hi = pts.min(0), pts.max(0)
    tspec = tpk.GridSpec.fit_bounds(lo, hi, 0.5)
    jspec = jpk.GridSpec.fit_bounds(lo, hi, 0.5)
    ttile = jtile = None
    if tiled:
        kw = dict(n_query=4096, voxel_edge=0.5, q_cap=512, x_seg=32)
        ttile = tdg.make_spec(lo, hi, 1.0, **kw)
        jtile = jdg.make_spec(lo, hi, 1.0, **kw)
    tc, tn, tm = tuq.unique_voxels(_t(pts), tspec, valid=_t(valid),
                                   tile_spec=ttile)
    jc, jn, jm = juq.unique_voxels(jnp.asarray(pts), jspec,
                                   valid=jnp.asarray(valid),
                                   tile_spec=jtile)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tk, tcount = tuq.unique_keys(tspec.encode(_t(pts)), valid=_t(valid))
    jk, jcount = juq.unique_keys(jspec.encode(jnp.asarray(pts)),
                                 valid=jnp.asarray(valid))
    assert int(tcount) == int(jcount)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("presorted", [False, True])
def test_search_tables_equal(presorted):
    pts = _points()
    valid = _valid(len(pts), len(pts) - 100)
    lo, hi = pts.min(0), pts.max(0)
    kw = dict(n_query=4096, voxel_edge=0.25, q_cap=256, x_seg=32)
    tspec = tdg.make_spec(lo, hi, 0.5, **kw)
    jspec = jdg.make_spec(lo, hi, 0.5, **kw)
    if presorted:
        # the sanctioned producer of presorted rows
        vt = tpk.GridSpec.fit_bounds(lo, hi, 0.25)
        vj = jpk.GridSpec.fit_bounds(lo, hi, 0.25)
        tpts, _, tval = tuq.unique_voxels(_t(pts), vt, valid=_t(valid),
                                          tile_spec=tspec)
        jpts, _, jval = juq.unique_voxels(jnp.asarray(pts), vj,
                                          valid=jnp.asarray(valid),
                                          tile_spec=jspec)
    else:
        tpts, tval = _t(pts), _t(valid)
        jpts, jval = jnp.asarray(pts), jnp.asarray(valid)
    a = tdg._search_tables(tpts, tval, tspec, presorted=presorted)
    b = jdg._search_tables(jpts, jval, jspec, presorted=presorted)
    np.testing.assert_array_equal(a["sorted_pts"].numpy(),
                                  np.asarray(b["sorted_pts"]))
    np.testing.assert_array_equal(a["sc_ext"].numpy(),
                                  np.asarray(b["sc_ext"]))


def _covariances(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3, 3))
    cov = np.einsum("nij,nkj->nik", a, a)
    cov[:200] = np.diag([2.0, 2.0, 2.0])          # repeated eigenvalues
    cov[200:400] = np.diag([3.0, 1.0, 1.0])
    cov[400:450] = 0.0
    m6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
                   cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]], axis=1)
    return cov, m6.astype(np.float32)


def test_eigvalsh3_matches_reference_and_oracle():
    cov, m6 = _covariances()
    got = teig.eigvalsh3(_t(m6)).numpy()
    ref = np.asarray(jeig.eigvalsh3(jnp.asarray(m6)))
    oracle = np.linalg.eigvalsh(cov.astype(np.float64))[:, ::-1]
    scale = np.abs(oracle).max(axis=1, keepdims=True) + 1.0
    # f32 closed form vs float64 LAPACK: the tolerance of
    # tests/test_knn_eigen.py's eigen oracle (relative 1e-3)
    assert np.all(np.abs(got - oracle) <= 1e-3 * scale)
    # the same f32 formula on both frameworks: transcendental ulps only
    assert np.all(np.abs(got - ref) <= 1e-5 * scale)


def test_minimal_block_matches_reference():
    rng = np.random.default_rng(11)
    n = 3000
    _, cov = _covariances(n)
    count = rng.integers(0, 40, n).astype(np.float32)
    count[:100] = 1.0                              # degenerate: zeros
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    query = rng.normal(size=(n, 3)).astype(np.float32)
    got = tly.minimal_block(_t(count), _t(mean), _t(cov), _t(query))
    ref = jly.minimal_block(jnp.asarray(count), jnp.asarray(mean),
                            jnp.asarray(cov), jnp.asarray(query))
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(ref)[:, 0])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert np.all(got[:100, 2:].numpy() == 0)


def test_moments_from_slabs_matches_reference():
    rng = np.random.default_rng(12)
    radii = (0.8, 0.4)
    slabs = rng.normal(size=(5, 16, 2 * tmk.MOMENT_PAD)).astype(np.float32)
    slabs[..., 0::tmk.MOMENT_PAD] = rng.integers(0, 30, (5, 16, 2))
    centers = rng.normal(size=(5, 3)).astype(np.float32)
    got = tmk.moments_from_slabs(_t(slabs), _t(centers), radii)
    ref = jmk.moments_from_slabs(jnp.asarray(slabs), jnp.asarray(centers),
                                 radii)
    for g, r in zip(got, ref):
        for key in ("count", "mean_local", "mean", "cov"):
            # tests/test_pallas_kernel.py's slab-conversion tolerance
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]),
                                       atol=1e-5, err_msg=key)
