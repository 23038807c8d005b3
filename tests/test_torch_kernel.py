"""
The plain PyTorch twin of the packed moment kernel against the JAX
Pallas kernel (interpret mode), on the same NumPy inputs: counts equal,
moments within ``moment_tolerance`` (both sum the same rounded f32 terms
in different orders).  Candidates sit exactly on the radius, dead slots
hold the FAR sentinel.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops.pallas import packed_kernel as jpk

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


@pytest.mark.parametrize("kwargs", [
    {"exclude_radius": 0.1}, {"with_sazo": True}, {"n_attr": 2},
    {"metric": "chebyshev"}, {"precision": "bf16x2"}])
def test_unported_variants_raise(kwargs):
    q_t, cand_t, centers = _problem(1, 16, 128, (0.5,), seed=0)
    args = (torch.from_numpy(q_t), torch.from_numpy(cand_t),
            torch.from_numpy(centers), (0.5,))
    for fn in (tpm.packed_moments, tpm.packed_moments_plain):
        with pytest.raises(NotImplementedError):
            fn(*args, **kwargs)


def test_wrapper_rejects_bad_shapes():
    q_t, cand_t, centers = _problem(2, 16, 128, (0.5,), seed=1)
    with pytest.raises(ValueError):
        tpm.packed_moments(torch.from_numpy(q_t),
                           torch.from_numpy(cand_t[:, :-64]),
                           torch.from_numpy(centers), (0.5,))
