"""
The span path of the port against the JAX package: the plain twin of
the span moment kernel against the JAX Pallas kernel (interpret mode),
``fused_extract_spans`` against the reference's, and
``extract_scaleset_fused(backend="pallas")`` against the reference's
``extract_scaleset(method="fused", tuning={"backend": "pallas"})``, on
the same NumPy inputs; the plain twin at ``precision="bf16x2"`` against
the JAX kernel at that precision and against ``"highest"``.

Counts are compared for equality.  Moments may differ by the f32
accumulation-order bound (``gather_kernel.span_tolerance``: both sum the
same rounded terms in different orders); features within ``atol=1e-3``
where populations are equal (the reference's own bar for its span
path).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops.pallas import gather_kernel as jgk

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import device_grid as tdg
from nimrud_tpu_torch.ops.kernels import gather_kernel as tgk
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import MOMENT_PAD

COUNTS = slice(0, None, MOMENT_PAD)


def _sorted_t(sorted_pts, span_rows):
    """The reference kernel's lanes-major cloud, padded as the
    reference's ``_band_spans`` pads it (``span_window`` trailing
    lanes)."""
    n = sorted_pts.shape[0]
    n_lanes = -(-(n + jgk.span_window(span_rows)) // 128) * 128
    out = np.zeros((4, n_lanes), np.float32)
    out[:3, :n] = sorted_pts.T
    return out


def _exact_problem(n_entries, q_cap, n_span, span_rows, radii, seed):
    """Spans over per-entry blocks of a sorted cloud.  Every value is a
    multiple of 1/8 below 64 in magnitude, so every f32 operation of
    both kernels is exact; span 0 of each entry holds candidates exactly
    at a radius from a query; a third of the spans are empty."""
    rng = np.random.default_rng(seed)
    centers = (np.round(rng.random((n_entries, 3)) * 200) / 4)
    q_local = rng.integers(-8, 9, (n_entries, q_cap, 3)) / 8.0
    block = 4 * span_rows
    local = rng.integers(-24, 25, (n_entries, block, 3)) / 8.0
    n_edge = min(q_cap, span_rows)
    for e in range(n_entries):
        for i in range(n_edge):
            r = radii[i % len(radii)]
            local[e, i] = q_local[e, i]
            local[e, i, i % 3] += r if i % 2 else -r
    pts = (local + centers[:, None, :]).reshape(-1, 3).astype(np.float32)
    base = (np.arange(n_entries) * block)[:, None]
    lens = rng.integers(0, span_rows + 1, (n_entries, n_span))
    lens[rng.random((n_entries, n_span)) < 1 / 3] = 0
    starts = base + rng.integers(0, block - span_rows + 1,
                                 (n_entries, n_span))
    starts[:, 0], lens[:, 0] = base[:, 0], n_edge
    return (q_local.astype(np.float32), centers.astype(np.float32),
            starts.astype(np.int32), lens.astype(np.int32), pts)


def _both(q_local, centers, starts, lens, pts, radii, span_rows):
    ref = np.asarray(jgk.span_moments(
        jnp.asarray(q_local), jnp.asarray(centers), jnp.asarray(starts),
        jnp.asarray(lens), jnp.asarray(_sorted_t(pts, span_rows)), radii,
        span_rows, interpret=True, entries_per_step=2))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (q_local, centers, starts, lens, pts)]
    got = tgk.span_moments_plain(*args, radii, span_rows)
    tol = tgk.span_tolerance(got, args[1], args[2], args[3], args[4],
                             span_rows).numpy()
    # the wrapper serves CPU tensors with the plain version
    np.testing.assert_array_equal(
        tgk.span_moments(*args, radii, span_rows).numpy(), got.numpy())
    return ref, got.numpy(), tol


@pytest.mark.parametrize("q_cap,n_span,span_rows,radii", [
    (16, 9, 40, (0.5,)), (24, 25, 24, (1.0, 0.5, 2.0)),
    (130, 4, 64, (0.75, 1.5)), (8, 25, 16, (0.5, 1.0, 1.5, 2.0))])
def test_plain_twin_matches_pallas_kernel_exact(q_cap, n_span, span_rows,
                                                radii):
    ref, got, tol = _both(*_exact_problem(3, q_cap, n_span, span_rows,
                                          radii, seed=q_cap + n_span),
                          radii, span_rows)
    assert got.shape == ref.shape == (3, q_cap, len(radii) * MOMENT_PAD)
    assert np.all(np.isfinite(got))
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert got[..., COUNTS].max() > 0
    assert np.all(np.abs(got - ref) <= tol)


def test_boundary_and_empty_spans():
    # one query; candidates exactly at r, just outside, and an empty
    # span pointing at a candidate that must not count
    r = 0.5
    center = np.array([[10.0, 20.0, 30.0]], np.float32)
    q_local = np.array([[[0.25, 0.0, 0.0]]], np.float32)
    q = center[0] + q_local[0, 0]
    pts = np.array([q + [r, 0, 0], q - [0, r, 0], q + [0, 0, r + 1e-4],
                    q + [0.125, 0, 0]], np.float32)
    starts = np.array([[0, 3, 2]], np.int32)
    lens = np.array([[2, 0, 1]], np.int32)
    out = tgk.span_moments(*(torch.from_numpy(a) for a in
                             (q_local, center, starts, lens, pts)),
                           (r,), 4)
    assert out[0, 0, 0].item() == 2.0
    assert np.all(out[0, 0, 10:].numpy() == 0)
    # a length past span_rows is clamped, as the plan clamps it
    lens[0, 0] = 4
    out = tgk.span_moments(*(torch.from_numpy(a) for a in
                             (q_local, center, starts, lens, pts)),
                           (r,), 2)
    assert out[0, 0, 0].item() == 2.0


def _scene(n_search=3000, n_query=1024, extent=(8, 8, 3), seed=11):
    rng = np.random.default_rng(seed)
    search = (rng.random((n_search, 3)) * extent).astype(np.float32)
    return search[:n_query], search


def _problem(query, search, edge, radius, x_seg):
    """The reference's own span plan (voxel-downsampled search) and the
    port's, on one spec."""
    lo = np.minimum(query.min(0), search.min(0)).astype(np.float64)
    hi = np.maximum(query.max(0), search.max(0)).astype(np.float64)
    centers = jms._host_unique_voxels(search, edge)
    kw = dict(n_query=len(query), q_cap=64, voxel_edge=edge, x_seg=x_seg)
    jspec = jdg.make_spec(lo, hi, radius, **kw)
    tspec = tdg.make_spec(lo, hi, radius, **kw)
    q_valid = np.ones(len(query), bool)
    s_valid = np.ones(len(centers), bool)
    jprob = jdg._span_problem(jnp.asarray(query), jnp.asarray(q_valid),
                              jnp.asarray(centers), jnp.asarray(s_valid),
                              jspec)
    tprob = tdg._span_problem(torch.from_numpy(query),
                              torch.from_numpy(q_valid),
                              torch.from_numpy(centers),
                              torch.from_numpy(s_valid), tspec)
    return jspec, tspec, jprob, tprob, centers


@pytest.mark.parametrize("edge,radius,x_seg", [(0.25, 0.5, 2),
                                               (0.5, 1.0, 3)])
def test_plain_twin_matches_pallas_kernel_on_reference_plan(edge, radius,
                                                            x_seg):
    # random-float coordinates: both kernels form the difference-form
    # distance with the same rounded operations, so counts are equal
    query, search = _scene()
    jspec, tspec, jprob, tprob, _ = _problem(query, search, edge, radius,
                                             x_seg)
    for key in ("span_starts", "span_lens", "sorted_pts", "q_local",
                "centers"):
        np.testing.assert_array_equal(tprob[key].numpy(),
                                      np.asarray(jprob[key]), err_msg=key)
    assert tprob["span_rows"] == jspec.span_rows
    radii = (radius, radius / 2)
    ref = np.asarray(jgk.span_moments(
        jprob["q_local"], jprob["centers"], jprob["span_starts"],
        jprob["span_lens"], jprob["sorted_t"], radii, jspec.span_rows,
        interpret=True))
    args = (tprob["q_local"].contiguous(), tprob["centers"],
            tprob["span_starts"].to(torch.int32),
            tprob["span_lens"].to(torch.int32), tprob["sorted_pts"])
    got_t = tgk.span_moments_plain(*args, radii, tprob["span_rows"])
    got = got_t.numpy()
    assert (tprob["span_lens"] == 0).any()
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert got[..., COUNTS].max() > 0
    tol = tgk.span_tolerance(got_t, *args[1:], tprob["span_rows"]).numpy()
    assert np.all(np.abs(got - ref) <= tol)


def test_fused_extract_spans_matches_reference():
    query, search = _scene(seed=5)
    jspec, tspec, _, _, centers = _problem(query, search, 0.4, 1.2, 3)
    radii = (1.2, 0.6)
    q_valid = np.arange(len(query)) < len(query) - 5     # some invalid
    s_valid = np.ones(len(centers), bool)
    ref, jstats = jdg.fused_extract_spans(
        jnp.asarray(query), jnp.asarray(q_valid), jnp.asarray(centers),
        jnp.asarray(s_valid), jspec, radii, "minimal", None, len(query),
        interpret=True, with_stats=True)
    got, tstats = tdg.fused_extract_spans(
        torch.from_numpy(query), torch.from_numpy(q_valid),
        torch.from_numpy(centers), torch.from_numpy(s_valid), tspec, radii,
        "minimal", len(query), with_stats=True)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (len(query), 8)
    assert int(tstats["dropped_query"]) == int(jstats["dropped_query"])
    np.testing.assert_array_equal(got[:, 0::4], ref[:, 0::4])
    assert got[:, 0].max() > 0
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_extract_scaleset_fused_span_backend_matches_reference():
    query, search = _scene(seed=12)
    scaleset = [(0.5, (1.0, 0.75))]
    ref = np.asarray(jms.extract_scaleset(
        query, search, scaleset, kind="minimal", method="fused",
        tuning={"backend": "pallas"}))
    got = tms.extract_scaleset_fused(query, search, scaleset, "minimal",
                                     backend="pallas", device="cpu").numpy()
    assert got.shape == ref.shape == (len(query), 8)
    np.testing.assert_array_equal(got[:, 0::4], ref[:, 0::4])
    np.testing.assert_allclose(got, ref, atol=1e-3)
    # the packed backend finds the same neighbor sets
    packed = tms.extract_scaleset_fused(query, search, scaleset, "minimal",
                                        device="cpu").numpy()
    np.testing.assert_array_equal(packed[:, 0::4], got[:, 0::4])
    np.testing.assert_allclose(packed, got, atol=1e-3)


@pytest.mark.parametrize("kwargs", [{"exclude_radius": 0.1}])
def test_unported_variants_raise(kwargs):
    # exclude_radius is ported (tests/test_torch_exclude_kernels.py): the
    # wrapper serves it on the CPU with the twin; an unknown precision
    # still raises, with or without it
    args = [torch.from_numpy(a) for a in
            _exact_problem(1, 8, 4, 8, (0.5,), seed=0)]
    assert torch.equal(tgk.span_moments(*args, (0.5,), 8, **kwargs),
                       tgk.span_moments_plain(*args, (0.5,), 8, **kwargs))
    for fn in (tgk.span_moments, tgk.span_moments_plain):
        for extra in ({}, kwargs):
            with pytest.raises(ValueError, match="precision"):
                fn(*args, (0.5,), 8, precision="bf16", **extra)


def _random_problem(n_entries, q_cap, n_span, span_rows, seed):
    """Spans over per-entry blocks of random-float points, so the bf16
    split's mid and lo terms are used; a third of the spans empty and a
    total of live rows per entry that is not a multiple of 16."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_entries, 3)) * 50).astype(np.float32)
    q_local = rng.uniform(-2, 2, (n_entries, q_cap, 3)).astype(np.float32)
    block = 4 * span_rows
    pts = (centers[:, None, :] + rng.uniform(-3, 3, (n_entries, block, 3))
           ).reshape(-1, 3).astype(np.float32)
    lens = rng.integers(0, span_rows + 1, (n_entries, n_span))
    lens[rng.random((n_entries, n_span)) < 1 / 3] = 0
    lens[:, 0] = 7
    starts = (np.arange(n_entries) * block)[:, None] + rng.integers(
        0, block - span_rows + 1, (n_entries, n_span))
    return (q_local, centers, starts.astype(np.int32), lens.astype(np.int32),
            pts)


@pytest.mark.parametrize("q_cap,n_span,span_rows,radii,exact", [
    (16, 9, 40, (0.5, 2.0), True), (24, 25, 24, (1.0,), False),
    (130, 4, 64, (0.5, 1.0, 1.5, 2.0), False)])
def test_plain_bf16x2_twin_matches_pallas_kernel(q_cap, n_span, span_rows,
                                                 radii, exact):
    make = _exact_problem if exact else _random_problem
    problem = (make(3, q_cap, n_span, span_rows, radii, seed=q_cap) if exact
               else make(3, q_cap, n_span, span_rows, seed=q_cap))
    q_local, centers, starts, lens, pts = problem
    ref = np.asarray(jgk.span_moments(
        jnp.asarray(q_local), jnp.asarray(centers), jnp.asarray(starts),
        jnp.asarray(lens), jnp.asarray(_sorted_t(pts, span_rows)), radii,
        span_rows, interpret=True, entries_per_step=2, precision="bf16x2"))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in problem]
    got_t = tgk.span_moments_plain(*args, radii, span_rows,
                                   precision="bf16x2")
    got = got_t.numpy()
    assert got.shape == ref.shape == (3, q_cap, len(radii) * MOMENT_PAD)
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert got[..., COUNTS].max() > 0
    tol = tgk.span_tolerance(got_t, *args[1:], span_rows).numpy()
    assert np.all(np.abs(got - ref) <= tol)
    np.testing.assert_array_equal(
        tgk.span_moments(*args, radii, span_rows,
                         precision="bf16x2").numpy(), got)


@pytest.mark.parametrize("q_cap,n_span,span_rows,radii", [
    (16, 25, 40, (0.5,)), (130, 9, 64, (0.5, 1.0, 1.5, 2.0))])
def test_bf16x2_matches_highest(q_cap, n_span, span_rows, radii):
    args = [torch.from_numpy(a) for a in
            _random_problem(4, q_cap, n_span, span_rows, seed=n_span)]
    high = tgk.span_moments_plain(*args, radii, span_rows)
    split = tgk.span_moments_plain(*args, radii, span_rows,
                                   precision="bf16x2")
    assert torch.equal(split[..., COUNTS], high[..., COUNTS])
    assert high[..., COUNTS].max() > 0
    tol = tgk.span_tolerance(high, *args[1:], span_rows)
    assert bool(((split - high).abs() <= tol).all())
    assert not torch.equal(split, high)     # the two orders do differ


def test_bad_inputs_raise():
    q, c, s, n, p = (torch.from_numpy(a) for a in
                     _exact_problem(2, 8, 4, 8, (0.5,), seed=1))
    with pytest.raises(TypeError, match="int32"):
        tgk.span_moments(q, c, s.to(torch.int64), n, p, (0.5,), 8)
    with pytest.raises(ValueError):
        tgk.span_moments(q, c[:1], s, n, p, (0.5,), 8)
    with pytest.raises(ValueError):
        tgk.span_moments(q, c, s, n, p, (0.1, 0.2, 0.3, 0.4, 0.5), 8)
    query, search = _scene(n_search=500, n_query=100)
    # the XLA backend is ported: the reference's fused XLA features
    tuning = {"entry_batch": 16}
    got = tms.extract_scaleset_fused(query, search, [(0.5, (1.0,))],
                                     backend="xla", tuning=tuning,
                                     device="cpu").numpy()
    ref = np.asarray(jms.extract_scaleset_fused(
        query, search, [(0.5, (1.0,))], tuning={"backend": "xla", **tuning}))
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)
    with pytest.raises(ValueError):
        tms.extract_scaleset_fused(query, search, [(0.5, (1.0,))],
                                   backend="ragged", device="cpu")
