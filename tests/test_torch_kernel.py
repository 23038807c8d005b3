"""
The plain PyTorch twin of the packed moment kernel against the JAX
Pallas kernel (interpret mode), on the same NumPy inputs, at both
precisions: counts equal, moments within ``moment_tolerance`` (both sum
the same rounded f32 terms in different orders), and with ``with_sazo``
the sazo rows 10 / 11 bit for bit.  Candidates sit exactly on the
radius, dead slots hold the FAR sentinel.  Also the bf16 hi + mid + lo
split and the kernel's work and bound reckoned from its inputs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops.pallas import packed_kernel as jpk

from nimrud_tpu_torch.ops.kernels import multiscale_kernel as mk
from nimrud_tpu_torch.ops.kernels import packed_moments as tpm
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import MOMENT_PAD


def _problem(n_entries, q_cap, c_cap, radii, seed):
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_entries, 3)) * 50).astype(np.float32)
    centers = np.round(centers * 4) / 4                # exact in f32
    q_local = (rng.integers(-8, 9, (n_entries, q_cap, 3)) / 8.0)
    cand_local = rng.uniform(-3, 3, (n_entries, c_cap, 3))
    # boundary candidates: exactly at distance r of a query along an
    # axis (every value a multiple of 1/8, so every f32 op is exact)
    n_edge = min(q_cap, c_cap // 4)
    for e in range(n_entries):
        for i in range(n_edge):
            r = radii[i % len(radii)]
            axis = i % 3
            cand_local[e, i] = q_local[e, i]
            cand_local[e, i, axis] += r if i % 2 else -r
    q = (q_local + centers[:, None, :]).astype(np.float32)
    cand = (cand_local + centers[:, None, :]).astype(np.float32)
    # dead tail slots hold the FAR sentinel
    n_live = rng.integers(c_cap // 2, c_cap, n_entries)
    for e in range(n_entries):
        cand[e, n_live[e]:] = tpm.FAR
    q_t = np.ascontiguousarray(q.transpose(0, 2, 1))
    cand_t = np.ascontiguousarray(cand.reshape(-1, 3).T)
    return q_t, cand_t, centers


@pytest.mark.parametrize("q_cap,c_cap,radii", [
    (16, 128, (0.5,)), (16, 256, (1.0, 0.5, 2.0)),
    (128, 128, (1.0, 0.5, 2.0)), (128, 256, (0.75,))])
def test_plain_twin_matches_pallas_kernel(q_cap, c_cap, radii):
    q_t, cand_t, centers = _problem(3, q_cap, c_cap, radii, seed=q_cap
                                    + c_cap + len(radii))
    ref = np.asarray(jpk.packed_moments(
        jnp.asarray(q_t), jnp.asarray(cand_t), jnp.asarray(centers),
        radii, interpret=True, entries_per_step=1))
    got_t = tpm.packed_moments_plain(
        torch.from_numpy(q_t), torch.from_numpy(cand_t),
        torch.from_numpy(centers), radii)
    got = got_t.numpy()
    assert got.shape == ref.shape == (3, q_cap, len(radii) * MOMENT_PAD)
    assert np.all(np.isfinite(got))
    counts = slice(0, None, MOMENT_PAD)
    np.testing.assert_array_equal(got[..., counts], ref[..., counts])
    assert got[..., counts].max() > 0
    tol = tpm.moment_tolerance(got_t, torch.from_numpy(cand_t),
                               torch.from_numpy(centers)).numpy()
    assert np.all(np.abs(got - ref) <= tol)
    # the wrapper serves CPU tensors with the plain version
    wrapped = tpm.packed_moments(
        torch.from_numpy(q_t), torch.from_numpy(cand_t),
        torch.from_numpy(centers), radii)
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_boundary_candidates_are_counted():
    # one query, candidates exactly at r, just inside and just outside
    r = 0.5
    center = np.array([[10.0, 20.0, 30.0]], np.float32)
    q = center + np.array([0.25, 0.0, 0.0], np.float32)
    cand = np.full((128, 3), tpm.FAR, np.float32)
    cand[0] = q[0] + [r, 0, 0]
    cand[1] = q[0] - [0, r, 0]
    cand[2] = q[0] + [0, 0, r + 1e-4]
    q_t = np.ascontiguousarray(q[None].transpose(0, 2, 1))
    cand_t = np.ascontiguousarray(cand.T)
    out = tpm.packed_moments(torch.from_numpy(q_t), torch.from_numpy(cand_t),
                             torch.from_numpy(center), (r,))
    assert out[0, 0, 0].item() == 2.0
    assert np.all(out[0, 0, 10:].numpy() == 0)


@pytest.mark.parametrize("q_cap,c_cap,radii", [
    (16, 256, (1.0, 0.5, 2.0)), (128, 128, (0.75,))])
def test_plain_bf16x2_twin_matches_pallas_kernel(q_cap, c_cap, radii):
    q_t, cand_t, centers = _problem(3, q_cap, c_cap, radii, seed=7 * q_cap
                                    + c_cap)
    ref = np.asarray(jpk.packed_moments(
        jnp.asarray(q_t), jnp.asarray(cand_t), jnp.asarray(centers),
        radii, interpret=True, entries_per_step=1, precision="bf16x2"))
    args = [torch.from_numpy(a) for a in (q_t, cand_t, centers)]
    got_t = tpm.packed_moments_plain(*args, radii, precision="bf16x2")
    got = got_t.numpy()
    assert got.shape == ref.shape == (3, q_cap, len(radii) * MOMENT_PAD)
    counts = slice(0, None, MOMENT_PAD)
    np.testing.assert_array_equal(got[..., counts], ref[..., counts])
    assert got[..., counts].max() > 0
    tol = tpm.moment_tolerance(got_t, args[1], args[2]).numpy()
    assert np.all(np.abs(got - ref) <= tol)
    np.testing.assert_array_equal(
        tpm.packed_moments(*args, radii, precision="bf16x2").numpy(), got)


@pytest.mark.parametrize("q_cap,c_cap,radii", [
    (16, 128, (0.5,)), (130, 256, (0.5, 1.0, 1.5, 2.0))])
def test_bf16x2_matches_highest(q_cap, c_cap, radii):
    # random-float candidates, so the split's mid and lo terms are used
    rng = np.random.default_rng(q_cap)
    centers = (rng.random((4, 3)) * 50).astype(np.float32)
    q_t = (centers[:, :, None]
           + rng.uniform(-2, 2, (4, 3, q_cap))).astype(np.float32)
    cand = (centers.T[:, :, None]
            + rng.uniform(-3, 3, (3, 4, c_cap))).astype(np.float32)
    cand[:, :, c_cap * 3 // 4:] = tpm.FAR
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (q_t, cand.reshape(3, -1), centers)]
    high = tpm.packed_moments_plain(*args, radii)
    split = tpm.packed_moments_plain(*args, radii, precision="bf16x2")
    counts = slice(0, None, MOMENT_PAD)
    assert torch.equal(split[..., counts], high[..., counts])
    assert high[..., counts].max() > 0
    tol = tpm.moment_tolerance(high, args[1], args[2])
    assert bool(((split - high).abs() <= tol).all())


def _random_problem(n_entries, q_cap, c_cap, seed):
    """Random-float queries and candidates about each entry center (so
    the z differences round), the last quarter of each block FAR, and
    entry 0 all FAR: every one of its queries has an empty
    neighborhood."""
    rng = np.random.default_rng(seed)
    centers = (rng.random((n_entries, 3)) * 50).astype(np.float32)
    q_t = (centers[:, :, None]
           + rng.uniform(-2, 2, (n_entries, 3, q_cap))).astype(np.float32)
    cand = (centers.T[:, :, None]
            + rng.uniform(-3, 3, (3, n_entries, c_cap))).astype(np.float32)
    cand[:, :, c_cap * 3 // 4:] = tpm.FAR
    cand[:, 0] = tpm.FAR
    return q_t, np.ascontiguousarray(cand.reshape(3, -1)), centers


@pytest.mark.parametrize("q_cap,c_cap,radii,precision,exact", [
    (16, 128, (0.5,), "highest", True),
    (24, 256, (1.0, 0.25), "highest", False),
    (16, 256, (1.0, 0.5, 2.0), "bf16x2", True),
    (130, 128, (0.5, 1.0, 1.5, 2.0), "highest", False),
    (32, 384, (0.75,), "bf16x2", False)])
def test_plain_sazo_twin_matches_pallas_kernel(q_cap, c_cap, radii,
                                               precision, exact):
    seed = q_cap + c_cap + len(radii)
    if exact:
        q_t, cand_t, centers = _problem(4, q_cap, c_cap, radii, seed)
        cand_t = cand_t.copy()
        cand_t[:, :c_cap] = tpm.FAR              # entry 0: no candidate
    else:
        q_t, cand_t, centers = _random_problem(4, q_cap, c_cap, seed)
    ref = np.asarray(jpk.packed_moments(
        jnp.asarray(q_t), jnp.asarray(cand_t), jnp.asarray(centers),
        radii, interpret=True, entries_per_step=1, precision=precision,
        with_sazo=True))
    args = [torch.from_numpy(a) for a in (q_t, cand_t, centers)]
    got_t = tpm.packed_moments_plain(*args, radii, precision=precision,
                                     with_sazo=True)
    got = got_t.numpy()
    assert got.shape == ref.shape == (4, q_cap, len(radii) * MOMENT_PAD)
    counts = got[..., 0::MOMENT_PAD]
    np.testing.assert_array_equal(counts, ref[..., 0::MOMENT_PAD])
    assert counts.max() > 0 and counts[0].max() == 0 and counts.min() == 0
    # rows 10 / 11 bit for bit, the empty neighborhoods at -BIG / +BIG
    for row in (10, 11):
        np.testing.assert_array_equal(got[..., row::MOMENT_PAD],
                                      ref[..., row::MOMENT_PAD])
    empty = counts == 0
    assert np.all(got[..., 10::MOMENT_PAD][empty] == np.float32(-tpm.BIG))
    assert np.all(got[..., 11::MOMENT_PAD][empty] == np.float32(tpm.BIG))
    full = ~empty
    assert np.all(got[..., 10::MOMENT_PAD][full]
                  >= got[..., 11::MOMENT_PAD][full])
    tol = tpm.moment_tolerance(got_t, args[1], args[2]).numpy()
    assert np.all(np.abs(got - ref) <= tol)
    # the other rows equal the twin without the fold; the wrapper serves
    # CPU tensors with the twin
    plain = tpm.packed_moments_plain(*args, radii,
                                     precision=precision).numpy()
    keep = np.ones(got.shape[-1], bool)
    keep[10::MOMENT_PAD] = keep[11::MOMENT_PAD] = False
    np.testing.assert_array_equal(got[..., keep], plain[..., keep])
    np.testing.assert_array_equal(
        tpm.packed_moments(*args, radii, precision=precision,
                           with_sazo=True).numpy(), got)


def test_bf16_split3_is_exact():
    # f32 values over the kernels' ranges: local coordinates up to the
    # grid extent and below, their products, 0, FAR and FAR^2
    rng = np.random.default_rng(3)
    coords = (rng.choice([-1.0, 1.0], 20000)
              * 2.0 ** rng.uniform(-40, 11, 20000)).astype(np.float32)
    prods = (coords[:10000] * coords[10000:]).astype(np.float32)
    values = np.concatenate([
        coords, prods, coords * coords, rng.uniform(-60, 60, 5000),
        [0.0, -0.0, tpm.FAR, -tpm.FAR, tpm.FAR * tpm.FAR,
         (tpm.FAR - 37.25) ** 2]]).astype(np.float32)
    parts = mk.bf16_split3(torch.from_numpy(values))
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.to(torch.float64).numpy() for p in parts)
    np.testing.assert_array_equal(total, values.astype(np.float64))
    # the reference's split, term for term
    ref = jpk_split(values)
    for p, r in zip(parts, ref):
        np.testing.assert_array_equal(p.to(torch.float32).numpy(), r)


def jpk_split(values):
    """The reference kernel's hi / mid / lo (packed_kernel.py bf16x2
    branch), as f32 arrays."""
    aug = jnp.asarray(values)
    hi = aug.astype(jnp.bfloat16)
    rem = aug - hi.astype(jnp.float32)
    mid = rem.astype(jnp.bfloat16)
    lo = (rem - mid.astype(jnp.float32)).astype(jnp.bfloat16)
    return [np.asarray(p.astype(jnp.float32)) for p in (hi, mid, lo)]


def test_work_and_bound_from_the_inputs():
    q_t, cand_t, centers = _problem(3, 16, 256, (0.5, 1.0), seed=4)
    args = [torch.from_numpy(a) for a in (q_t, cand_t, centers)]
    live = int((cand_t != tpm.FAR).any(0).sum())
    assert 0 < live < cand_t.shape[1]
    work = tpm.packed_moments_work(*args, (0.5, 1.0))
    assert work["pairs"] == live * 16
    terms = work["terms_ms"]
    assert terms["distance"] == pytest.approx(
        1e3 * live * 16 * 8 / (132 * 128 * 1.98e9))
    # 10 moments x 3 bf16 terms x 2 flops a pair and radius
    assert terms["tensor"] == pytest.approx(
        1e3 * live * 16 * 2 * 60 / 989e12)
    n_bytes = 4 * (q_t.size + cand_t.size + centers.size + 3 * 16 * 32)
    assert terms["bytes"] == pytest.approx(1e3 * n_bytes / 3.35e12)
    # at this toy size the slabs' bytes set the bound
    assert work["bound_term"] == "bytes"
    assert work["bound_ms"] == max(terms.values())
    # at a band's size the distance does (pairs and bytes of the fit's
    # band-0 problem: E 4864, q_cap 256, c_cap 768, three quarters live)
    band = mk.moment_bound(4864 * 576 * 256, 1,
                           4 * 4864 * (3 * 256 + 3 * 768 + 3 + 16 * 256))
    assert band["bound_term"] == "distance"
    assert band["bound_ms"] == pytest.approx(0.17151, abs=1e-5)
    # at one radius the tensor-core term is a quarter of the distance's
    one = mk.moment_bound(1e9, 1, 0)
    assert one["terms_ms"]["tensor"] / one["terms_ms"]["distance"] \
        == pytest.approx(0.2537, abs=1e-4)
    assert mk.moment_bound(10, 1, 1e9)["bound_term"] == "bytes"
    # the sazo fold: a masked max and min a pair and radius on the CUDA
    # cores, 10 operations a pair at one radius and 16 at four
    for radii in ((0.5,), (0.5, 1.0, 1.5, 2.0)):
        base = tpm.packed_moments_work(*args, radii)["terms_ms"]
        sazo = tpm.packed_moments_work(*args, radii,
                                       with_sazo=True)["terms_ms"]
        assert sazo["distance"] == pytest.approx(
            base["distance"] * (8 + 2 * len(radii)) / 8)
        assert (sazo["tensor"], sazo["bytes"]) == (base["tensor"],
                                                   base["bytes"])


@pytest.mark.parametrize("kwargs", [
    {"exclude_radius": 0.1, "metric": "chebyshev", "n_attr": 1},
    {"exclude_radius": 0.0, "metric": "chebyshev", "n_attr": 1},
    {"exclude_radius": 0.25, "with_sazo": True, "n_attr": 1}])
def test_unported_variants_raise(kwargs):
    # exclude_radius is ported (tests/test_torch_exclude_kernels.py); the
    # variants the reference refuses with it still raise ValueError
    q_t, cand_t, centers = _problem(1, 16, 128, (0.5,), seed=0)
    args = (torch.from_numpy(q_t), torch.from_numpy(cand_t),
            torch.from_numpy(centers), (0.5,))
    for fn in (tpm.packed_moments, tpm.packed_moments_plain):
        with pytest.raises(ValueError):
            fn(*args, **kwargs)
        out = fn(*args, exclude_radius=kwargs["exclude_radius"])
        assert out.shape == (1, 16, MOMENT_PAD)


def test_unknown_precision_raises():
    q_t, cand_t, centers = _problem(1, 16, 128, (0.5,), seed=0)
    args = (torch.from_numpy(q_t), torch.from_numpy(cand_t),
            torch.from_numpy(centers), (0.5,))
    for fn in (tpm.packed_moments, tpm.packed_moments_plain):
        with pytest.raises(ValueError, match="precision"):
            fn(*args, precision="bf16")


def test_wrapper_rejects_bad_shapes():
    q_t, cand_t, centers = _problem(2, 16, 128, (0.5,), seed=1)
    with pytest.raises(ValueError):
        tpm.packed_moments(torch.from_numpy(q_t),
                           torch.from_numpy(cand_t[:, :-64]),
                           torch.from_numpy(centers), (0.5,))
