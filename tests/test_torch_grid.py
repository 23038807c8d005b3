"""
The tiled entry path of the port against the JAX package: the host
tables of ``build_tiled_problem``, the plain twin of the ``entry_moments``
kernel against the JAX Pallas kernel (interpret mode), and
``tiled_features(backend="pallas")`` against the reference's, on the
same NumPy inputs.

The expanded distance ``(|q|^2 + |s|^2) - 2 q.s`` decides the counts.
On a 1/8 grid every f32 operation is exact, so counts are equal.  With
random floats the two may sum ``q.s`` in other orders (the reference
through a dot product); there a count may differ only by candidates
whose exact squared distance lies within the expanded form's rounding
bound of r^2, which the test computes.
"""

import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops import grid as jgrid
from nimrud_tpu.ops.pallas import multiscale_kernel as jmk

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import grid as tgrid
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as tmk
from torch_entry_cases import entry_problem, with_nan

PAD = tmk.MOMENT_PAD
COUNTS = slice(0, None, PAD)


def _problem(n_entries, q_cap, flat, radii, seed, exact=True):
    rng = np.random.default_rng(seed)
    if exact:
        q = rng.integers(-16, 17, (n_entries, q_cap, 3)) / 8.0
        s = rng.integers(-24, 25, (n_entries, flat, 3)) / 8.0
        # boundary candidates: exactly at distance r along an axis
        for e in range(n_entries):
            for i in range(min(q_cap, flat // 2)):
                s[e, i] = q[e, i]
                s[e, i, i % 3] += radii[i % len(radii)] * (1 if i % 2
                                                           else -1)
    else:
        q = rng.uniform(-2, 2, (n_entries, q_cap, 3))
        s = rng.uniform(-3, 3, (n_entries, flat, 3))
    valid = rng.random((n_entries, flat)) < 0.8
    return (q.astype(np.float32), s.astype(np.float32), valid)


def _jax(q, s, valid, radii):
    return np.asarray(jmk.entry_moments(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(valid), radii,
        interpret=True))


def _count_bounds(q, s, valid, radii):
    """Per (entry, query, radius) the fewest and most neighbors any
    f32 evaluation of the expanded form can give: candidates whose exact
    d2 lies within the form's rounding bound of f32(r^2) may go either
    way."""
    q64, s64 = q.astype(np.float64), s.astype(np.float64)
    diff = q64[:, :, None, :] - s64[:, None, :, :]
    d2 = (diff * diff).sum(-1)                          # exact enough
    qq = (q64 * q64).sum(-1)[:, :, None]
    ss = (s64 * s64).sum(-1)[:, None, :]
    qs = np.abs(np.einsum("eqk,efk->eqf", q64, s64))
    slack = 8 * 2.0 ** -24 * (qq + ss + 2 * qs)
    lo, hi = [], []
    for r2 in tmk.squared_radii(radii):
        r2 = float(r2)
        lo.append(((d2 <= r2 - slack) & valid[:, None, :]).sum(-1))
        hi.append(((d2 <= r2 + slack) & valid[:, None, :]).sum(-1))
    return np.stack(lo, -1), np.stack(hi, -1)


@pytest.mark.parametrize("q_cap,flat,radii", [
    (16, 125, (0.5,)), (32, 250, (1.0, 0.5, 2.0)), (130, 64, (0.75,)),
    (8, 300, (0.5, 1.0, 1.5, 2.0))])
def test_plain_twin_matches_pallas_kernel_exact(q_cap, flat, radii):
    q, s, valid = _problem(3, q_cap, flat, radii, seed=q_cap + flat)
    ref = _jax(q, s, valid, radii)
    args = [torch.from_numpy(a) for a in (q, s, valid)]
    got_t = tmk.entry_moments_plain(*args, radii)
    got = got_t.numpy()
    assert got.shape == ref.shape == (3, q_cap, len(radii) * PAD)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert got[..., COUNTS].max() > 0
    tol = tmk.entry_tolerance(got_t, args[1], args[2]).numpy()
    assert np.all(np.abs(got - ref) <= tol)
    # the wrapper serves CPU tensors with the plain version
    np.testing.assert_array_equal(
        tmk.entry_moments(*args, radii).numpy(), got)


def test_random_floats_differ_only_within_rounding_bound():
    radii = (0.5, 1.0, 2.0)
    q, s, valid = _problem(4, 64, 256, radii, seed=3, exact=False)
    ref = _jax(q, s, valid, radii)
    got = tmk.entry_moments_plain(
        *(torch.from_numpy(a) for a in (q, s, valid)), radii).numpy()
    lo, hi = _count_bounds(q, s, valid, radii)
    for counts in (got[..., COUNTS], ref[..., COUNTS]):
        assert np.all((lo <= counts) & (counts <= hi))
    same = (got[..., COUNTS] == ref[..., COUNTS]).mean()
    assert same > 0.99


@pytest.mark.parametrize("q_cap,flat,radii", [
    (16, 1000, (0.5,)), (24, 1003, (0.5, 1.0, 2.0))])
def test_plain_twin_matches_pallas_kernel_tiled_layout(q_cap, flat, radii):
    # the validity the CUDA kernel is tuned for: prefixes of 8-slot
    # groups, about 14% valid, an empty and an all-valid entry; exact
    # coordinates with candidates on the boundary
    q, s, valid = entry_problem(4, q_cap, flat, radii, seed=flat,
                                layout="tiled", exact=True)
    assert 0.1 < valid[2:].mean() < 0.2
    ref = _jax(q, s, valid, radii)
    args = [torch.from_numpy(a) for a in (q, s, valid)]
    got_t = tmk.entry_moments_plain(*args, radii)
    got = got_t.numpy()
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert np.all(got[0, :, COUNTS] == 0)
    assert got[1, :, COUNTS].max() > got[2:, :, COUNTS].max()
    tol = tmk.entry_tolerance(got_t, args[1], args[2]).numpy()
    assert np.all(np.abs(got - ref) <= tol)


def test_nan_inputs_count_as_in_pallas_kernel():
    # the reference's d2 <= r^2 is false for NaN: a NaN query counts no
    # neighbor and a NaN candidate is nobody's; moments at NaN are not
    # held
    radii = (0.5, 2.0)
    q, s, valid = with_nan(*entry_problem(3, 16, 250, radii, seed=5,
                                          exact=True))
    ref = _jax(q, s, valid, radii)
    got = tmk.entry_moments_plain(
        *(torch.from_numpy(a) for a in (q, s, valid)), radii).numpy()
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert np.all(got[:, 1, COUNTS] == 0)
    assert got[:, 0, COUNTS].max() > 0


def test_boundary_candidate_is_counted_and_invalid_is_not():
    r = 0.5
    q = np.array([[[0.25, 0.0, 0.0]]], np.float32)
    s = np.array([[[0.75, 0, 0], [0.25, -0.5, 0], [0.25, 0, 0.5001],
                   [0.25, 0, 0]]], np.float32)
    valid = np.array([[True, True, True, False]])
    out = tmk.entry_moments(*(torch.from_numpy(a) for a in (q, s, valid)),
                            (r,))
    assert out[0, 0, 0].item() == 2.0
    assert out[0, 0, 1].item() == 1.0                  # 0.75 + 0.25
    assert np.all(out[0, 0, 10:].numpy() == 0)


def _clouds(n_search=3000, n_query=800, extent=(8, 8, 3), seed=4):
    rng = np.random.default_rng(seed)
    search = (rng.random((n_search, 3)) * extent).astype(np.float32)
    query = (rng.random((n_query, 3)) * extent).astype(np.float32)
    return query, search


@pytest.mark.parametrize("tile,m,q_capacity,batch", [
    (0.5, 2, None, 32), (1.0, 3, 64, 8), (0.7, 1, 16, 4), (0.01, 2, None, 8)])
def test_build_tiled_problem_tables_equal(tile, m, q_capacity, batch):
    # the last case spans a grid of more than 2^26 tiles (the sparse,
    # binary-search branch)
    query, search = _clouds(n_search=600, n_query=300) if tile < 0.1 \
        else _clouds()
    kw = dict(query_tile_factor=m, query_capacity=q_capacity,
              entry_batch=batch)
    a = tgrid.build_tiled_problem(query, search, tile, **kw)
    b = jgrid.build_tiled_problem(query, search, tile, **kw)
    for key in ("query_index", "neighbor_rows", "candidates",
                "entry_centers"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                      err_msg=key)
        assert getattr(a, key).dtype == getattr(b, key).dtype, key
    assert (a.tile_edge, a.n_query, a.n_entries) \
        == (b.tile_edge, b.n_query, b.n_entries)
    assert a.stats == b.stats


@pytest.mark.parametrize("radii,m,batch", [((0.5,), 3, 32),
                                           ((1.0, 0.6), 2, 16)])
def test_tiled_features_match_reference(radii, m, batch):
    query, search = _clouds()
    tile = max(radii)
    problem = tgrid.build_tiled_problem(query, search, tile,
                                        query_tile_factor=m,
                                        entry_batch=batch)
    jproblem = jgrid.build_tiled_problem(query, search, tile,
                                         query_tile_factor=m,
                                         entry_batch=batch)
    ref = np.asarray(jgrid.tiled_features(
        jproblem, query, search, radii, "minimal", entry_batch=batch,
        backend="pallas"))
    got = tgrid.tiled_features(problem, query, search, radii, "minimal",
                               entry_batch=batch, backend="pallas",
                               device="cpu").numpy()
    assert got.shape == ref.shape == (len(query), 4 * len(radii))
    np.testing.assert_array_equal(got[:, 0::4], ref[:, 0::4])
    assert got[:, 0].mean() > 1
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_entry_points_default_to_the_card():
    # the tiled path and the fused extraction run on the card unless the
    # caller asks for the CPU, as make_bench_model and GeometryClassifier
    for fn in (tgrid.tiled_features, tms.extract_scaleset_fused):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_unported_variants_raise():
    # the variants this test once saw raise are ported: the XLA path
    # (backend="xla", the default), attributes, chebyshev and sazo --
    # each equal to the reference's (tests/test_torch_xla_grid.py holds
    # them at length); what is left raises for its arguments
    query, search = _clouds(n_search=300, n_query=100)
    problem = tgrid.build_tiled_problem(query, search, 1.0)
    jproblem = jgrid.build_tiled_problem(query, search, 1.0)
    attrs = np.ones((300, 2), np.float32)
    for kind, kwargs in (("minimal", {"backend": "xla"}),
                         ("vector", {"attributes": attrs}),
                         ("minimal", {"metric": "chebyshev"}),
                         ("sazo", {"exclude_radius": 0.1})):
        ref = np.asarray(jgrid.tiled_features(jproblem, query, search,
                                              (1.0,), kind, **kwargs))
        got = tgrid.tiled_features(problem, query, search, (1.0,), kind,
                                   device="cpu", **kwargs).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)
        if kind != "vector":      # populations or densities: an ulp
            np.testing.assert_allclose(got[:, 0], ref[:, 0],
                                       rtol=2.0 ** -22)
    # precision takes the reference's names; the entry kernel's sums do
    # not depend on it (the reference's pallas branch ignores it too)
    plain = tgrid.tiled_features(problem, query, search, (1.0,), "minimal",
                                 backend="pallas", device="cpu")
    for name in ("mixed", "high", "default"):
        assert torch.equal(tgrid.tiled_features(
            problem, query, search, (1.0,), "minimal", precision=name,
            backend="pallas", device="cpu"), plain)
    with pytest.raises(ValueError, match="precision"):
        tgrid.tiled_features(problem, query, search, (1.0,), "minimal",
                             precision="bf16", backend="pallas",
                             device="cpu")
    with pytest.raises(ValueError, match="exceeds tile edge"):
        tgrid.tiled_features(problem, query, search, (2.0,), "minimal",
                             backend="pallas", device="cpu")
    q, s, valid = (torch.from_numpy(a) for a in
                   _problem(1, 8, 16, (0.5,), seed=0))
    for fn in (tmk.entry_moments, tmk.entry_moments_plain):
        assert fn(q, s, valid, (0.5,), exclude_radius=0.1).shape == (1, 8, 16)
    with pytest.raises(TypeError, match="bool"):
        tmk.entry_moments(q, s, valid.to(torch.uint8), (0.5,))
