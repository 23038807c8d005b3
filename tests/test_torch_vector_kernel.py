"""
The attribute rows and the chebyshev metric of the port's packed moment
kernel (the V_MSO path) against the JAX Pallas kernel in interpret mode,
on the same NumPy inputs, at both precisions:

* counts (and so every chebyshev and euclidean membership) equal;
* moment and attribute rows within ``moment_tolerance``: both sum the
  same rounded f32 terms in other orders, at most c_cap terms a sum,
  each attribute row bounded by its own extent (global values);
* candidates exactly at |d| = r (a 1/8 grid: every f32 operation
  exact) and 1/8 past it, NaN query coordinates on one axis at a time,
  dead FAR lanes and an entry without candidates;
* the variants the reference refuses raise its ``ValueError``.

Also ``moments_from_slabs``' ``attr_mean`` against the reference's, and
the work and bound of the attribute and chebyshev instances.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops.pallas import multiscale_kernel as jmk
from nimrud_tpu.ops.pallas import packed_kernel as jpk

from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
from nimrud_tpu_torch.ops.kernels import packed_moments as tpm
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import MOMENT_PAD


def vector_problem(n_entries, q_cap, c_cap, radii, n_attr, seed,
                   metric="euclidean"):
    """Queries and candidates on a 1/8 grid about entry centers on a 1/4
    grid, so every f32 subtraction, square and sum is exact: candidates
    at exactly |d| = r of a query along one axis (the chebyshev ball's
    face, the euclidean sphere's pole) or 1/8 past it; the dead tail of
    each block and all of entry 0 FAR; a NaN query coordinate on each
    axis in entry 1; attribute rows of mixed sign and scale (FAR on dead
    lanes, as the FAR-extended cloud gathers them)."""
    rng = np.random.default_rng(seed)
    centers = (np.round(rng.random((n_entries, 3)) * 200) / 4).astype(
        np.float32)
    q = rng.integers(-8, 9, (n_entries, q_cap, 3)) / 8.0
    c = rng.integers(-24, 25, (n_entries, c_cap, 3)) / 8.0
    for i in range(min(q_cap, c_cap // 4)):
        r = radii[i % len(radii)]
        c[:, i] = q[:, i]
        step = r + (0.125 if i % 4 == 3 else 0.0)
        c[:, i, i % 3] += step * (1 if i % 2 else -1)
    q_t = np.ascontiguousarray(
        (q + centers[:, None]).transpose(0, 2, 1)).astype(np.float32)
    cand = (c + centers[:, None]).astype(np.float32)
    n_live = rng.integers(c_cap // 2, c_cap + 1, n_entries)
    live = np.arange(c_cap)[None, :] < n_live[:, None]
    live[0] = False
    cand[~live] = tpm.FAR
    for axis in range(3):
        q_t[1, axis, 2 + axis] = np.nan
    scale = np.resize([1.0, 40.0, 0.01, 2.5e3, 7.0, 0.3], n_attr)
    attrs = (rng.normal(0.5, 1.0, (n_attr, n_entries, c_cap))
             * scale[:, None, None]).astype(np.float32)
    attrs[:, ~live] = tpm.FAR
    cand_t = np.concatenate([cand.reshape(-1, 3).T,
                             attrs.reshape(n_attr, n_entries * c_cap)]
                            ).astype(np.float32)
    return q_t, np.ascontiguousarray(cand_t), centers


def _reference(q_t, cand_t, centers, radii, **kwargs):
    return np.asarray(jpk.packed_moments(
        jnp.asarray(q_t), jnp.asarray(cand_t), jnp.asarray(centers),
        tuple(radii), interpret=True, entries_per_step=1, **kwargs))


def _hold(q_t, cand_t, centers, radii, n_attr, metric, precision):
    ref = _reference(q_t, cand_t, centers, radii, precision=precision,
                     n_attr=n_attr, metric=metric)
    args = [torch.from_numpy(a) for a in (q_t, cand_t, centers)]
    got_t = tpm.packed_moments_plain(*args, radii, precision=precision,
                                     n_attr=n_attr, metric=metric)
    got = got_t.numpy()
    assert got.shape == ref.shape == (q_t.shape[0], q_t.shape[2],
                                      len(radii) * MOMENT_PAD)
    counts = got[..., 0::MOMENT_PAD]
    np.testing.assert_array_equal(counts, ref[..., 0::MOMENT_PAD])
    assert counts.max() > 0 and counts[0].max() == 0
    # a NaN on any one axis counts nothing and sums nothing
    assert np.all(got[1, 2:5] == 0)
    assert np.all(np.isfinite(got))
    tol = tpm.moment_tolerance(got_t, args[1], args[2],
                               n_attr=n_attr).numpy()
    assert np.all(np.abs(got - ref) <= tol)
    for ri in range(len(radii)):               # rows past the attributes
        assert np.all(got[..., ri * MOMENT_PAD + 10 + n_attr:
                          (ri + 1) * MOMENT_PAD] == 0)
    # the wrapper serves CPU tensors with the plain version
    np.testing.assert_array_equal(
        tpm.packed_moments(*args, radii, precision=precision,
                           n_attr=n_attr, metric=metric).numpy(), got)
    return got, ref


@pytest.mark.parametrize("n_attr,q_cap,c_cap,radii,precision", [
    (1, 16, 128, (0.5,), "highest"),
    (2, 24, 256, (1.0, 0.25), "bf16x2"),
    (3, 16, 256, (1.0, 0.5, 2.0), "highest"),
    (4, 130, 128, (0.5, 1.0, 1.5, 2.0), "highest"),
    (5, 32, 384, (0.75,), "bf16x2"),
    (6, 16, 256, (0.5, 1.0, 1.5, 2.0), "bf16x2"),
    (6, 40, 128, (0.25, 1.25), "highest")])
def test_attr_rows_match_pallas_kernel(n_attr, q_cap, c_cap, radii,
                                       precision):
    q_t, cand_t, centers = vector_problem(4, q_cap, c_cap, radii, n_attr,
                                          seed=17 * n_attr + q_cap)
    got, _ = _hold(q_t, cand_t, centers, radii, n_attr, "euclidean",
                   precision)
    # the count and moment rows are the instance's without attributes
    plain = tpm.packed_moments_plain(
        *(torch.from_numpy(a) for a in (q_t, cand_t[:3].copy(), centers)),
        radii, precision=precision).numpy()
    keep = np.zeros(got.shape[-1], bool)
    for ri in range(len(radii)):
        keep[ri * MOMENT_PAD:ri * MOMENT_PAD + 10] = True
    np.testing.assert_array_equal(got[..., keep], plain[..., keep])


@pytest.mark.parametrize("n_attr,q_cap,c_cap,radius,precision", [
    (1, 16, 128, 0.25, "highest"), (2, 128, 256, 0.25, "highest"),
    (2, 128, 256, 0.5, "bf16x2"), (4, 24, 384, 0.125, "highest"),
    (6, 32, 128, 1.0, "bf16x2"), (0, 16, 256, 0.25, "highest")])
def test_chebyshev_matches_pallas_kernel(n_attr, q_cap, c_cap, radius,
                                         precision):
    q_t, cand_t, centers = vector_problem(4, q_cap, c_cap, (radius,),
                                          n_attr, seed=5 * q_cap + n_attr,
                                          metric="chebyshev")
    got, _ = _hold(q_t, cand_t, centers, (radius,), n_attr, "chebyshev",
                   precision)
    # the max-norm ball holds the points at |d| = r on one axis, and no
    # point 1/8 past it: its face candidates count where the euclidean
    # sphere's do too, and the cube's corners add more
    eucl = tpm.packed_moments_plain(
        *(torch.from_numpy(a) for a in (q_t, cand_t, centers)), (radius,),
        n_attr=n_attr).numpy()
    assert np.all(got[..., 0] >= eucl[..., 0])
    assert np.any(got[..., 0] > eucl[..., 0])


def test_chebyshev_boundary_is_exact():
    # one query, candidates exactly at r along each axis and on a cube
    # corner (inside), and 2^-18 (an f32 step at 30) past r on one axis
    r = 0.25
    center = np.array([[10.0, 20.0, 30.0]], np.float32)
    q = center + np.array([0.125, 0.0, -0.125], np.float32)
    cand = np.full((128, 4), tpm.FAR, np.float32)
    cand[0, :3] = q[0] + [r, 0, 0]
    cand[1, :3] = q[0] - [0, r, 0]
    cand[2, :3] = q[0] + [r, -r, r]
    cand[3, :3] = q[0] + [0, 0, r + 2.0 ** -18]
    cand[:4, 3] = [1.0, 2.0, 4.0, 8.0]
    q_t = np.ascontiguousarray(q[None].transpose(0, 2, 1))
    cand_t = np.ascontiguousarray(cand.T)
    ref = _reference(q_t, cand_t, center, (r,), n_attr=1,
                     metric="chebyshev")
    out = tpm.packed_moments(torch.from_numpy(q_t), torch.from_numpy(cand_t),
                             torch.from_numpy(center), (r,), n_attr=1,
                             metric="chebyshev").numpy()
    assert out[0, 0, 0] == ref[0, 0, 0] == 3.0
    assert out[0, 0, 10] == ref[0, 0, 10] == 7.0


@pytest.mark.parametrize("kwargs", [
    {"with_sazo": True, "n_attr": 2}, {"metric": "chebyshev",
                                       "with_sazo": True},
    {"metric": "chebyshev", "exclude_radius": 0.1}, {"n_attr": 7},
    {"metric": "manhattan"}])
def test_refused_variants_raise_as_the_reference(kwargs):
    n_attr = kwargs.get("n_attr", 0)
    q_t, cand_t, centers = vector_problem(2, 16, 128, (0.5,), n_attr,
                                          seed=0)
    with pytest.raises(ValueError):
        _reference(q_t, cand_t, centers, (0.5,), **kwargs)
    args = [torch.from_numpy(a) for a in (q_t, cand_t, centers)]
    for fn in (tpm.packed_moments, tpm.packed_moments_plain):
        with pytest.raises(ValueError):
            fn(*args, (0.5,), **kwargs)
    # cand_t must carry the attribute rows it claims
    with pytest.raises(ValueError, match="3 \\+ n_attr"):
        tpm.packed_moments_plain(args[0], args[1][:3], args[2], (0.5,),
                                 n_attr=2)


@pytest.mark.parametrize("n_attr,radii", [(2, (0.5,)),
                                          (5, (0.5, 1.0, 2.0))])
def test_attr_mean_matches_reference(n_attr, radii):
    q_t, cand_t, centers = vector_problem(3, 24, 256, radii, n_attr, seed=9)
    slabs = _reference(q_t, cand_t, centers, radii, n_attr=n_attr)
    ref = jmk.moments_from_slabs(jnp.asarray(slabs), jnp.asarray(centers),
                                 radii, n_attr=n_attr)
    got = mk.moments_from_slabs(torch.from_numpy(slabs.copy()),
                                torch.from_numpy(centers), radii,
                                n_attr=n_attr)
    for g, r in zip(got, ref):
        assert g["attr_mean"].shape == (3, 24, n_attr)
        np.testing.assert_array_equal(g["attr_mean"].numpy(),
                                      np.asarray(r["attr_mean"]))
        np.testing.assert_array_equal(g["count"].numpy(),
                                      np.asarray(r["count"]))
    assert "attr_mean" not in mk.moments_from_slabs(
        torch.from_numpy(slabs), torch.from_numpy(centers), radii)[0]


def test_attr_slots_and_bound():
    # the instance widths: 32 B columns hold 1 slot, 40 hold 4, 48 hold 6
    assert [tpm.attr_slots(a) for a in range(7)] == [1, 1, 4, 4, 4, 6, 6]
    q_t, cand_t, centers = vector_problem(3, 16, 256, (0.5, 1.0), 3, seed=4)
    args = [torch.from_numpy(a) for a in (q_t, cand_t, centers)]
    live = int((cand_t[:3] != tpm.FAR).any(0).sum())
    work = tpm.packed_moments_work(*args, (0.5, 1.0), n_attr=3)
    assert work["pairs"] == live * 16
    # 13 tensor-core columns x 3 bf16 terms x 2 flops a pair and radius
    assert work["terms_ms"]["tensor"] == pytest.approx(
        1e3 * live * 16 * 2 * 13 * 3 * 2 / 989e12)
    assert work["terms_ms"]["distance"] == pytest.approx(
        1e3 * live * 16 * 8 / (132 * 128 * 1.98e9))
    n_bytes = 4 * (q_t.size + cand_t.size + centers.size + 3 * 16 * 32)
    assert work["terms_ms"]["bytes"] == pytest.approx(1e3 * n_bytes / 3.35e12)
    # the chebyshev test: 3 subtractions and 2 maxima a pair
    cheb = tpm.packed_moments_work(*args, (0.25,), n_attr=3,
                                   metric="chebyshev")["terms_ms"]
    assert cheb["distance"] == pytest.approx(
        1e3 * live * 16 * 5 / (132 * 128 * 1.98e9))
    # the squared radii for the euclidean kernels, f32(r) for chebyshev
    assert mk.chebyshev_radii((0.1,)) == [float(np.float32(0.1)), 0.0, 0.0,
                                          0.0]
    assert mk.padded_radii((0.1,))[0] == float(np.float32(0.1 * 0.1))
