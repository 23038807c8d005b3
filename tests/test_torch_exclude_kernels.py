"""
``exclude_radius`` in the plain PyTorch twins of the three moment
kernels against the JAX Pallas kernels (interpret mode), on the same
NumPy inputs (``torch_exclude_cases``): ``exclude_radius`` in {0.0,
1e-4, ``E_ROUND``, 1e-30}, with the boundary pairs on the exclusion
radius and on each radius, and NaN on each axis.

Counts are compared for equality; moments within the f32 summation-order
bound of each kernel's tolerance function (``moment_tolerance``,
``span_tolerance``, ``entry_tolerance``: both sum the same rounded
terms in other orders); the sazo rows 10 / 11 bit for bit.  Entries
holding a NaN are compared by their counts only (the reference's
masked sums carry the NaN of a candidate's moment terms).

Also: the threshold is ``f32(e*e)`` with the product in float64 (the
reference's); exclusion at 0.0 gives slabs bit-equal to no exclusion;
the entry kernel's exclusion test clamps ``d2`` at 0 with a NaN kept;
chebyshev with an exclusion raises in both packages.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops.pallas import gather_kernel as jgk
from nimrud_tpu.ops.pallas import multiscale_kernel as jmk
from nimrud_tpu.ops.pallas import packed_kernel as jpk

from nimrud_tpu_torch.ops.kernels import gather_kernel as tgk
from nimrud_tpu_torch.ops.kernels import multiscale_kernel as tmk
from nimrud_tpu_torch.ops.kernels import packed_moments as tpm
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import MOMENT_PAD
from torch_exclude_cases import (E_ROUND, EXCLUDE_RADII, clamp_problem,
                                 entry_problem, packed_problem,
                                 span_problem)

COUNTS = slice(0, None, MOMENT_PAD)
RADII = (0.5, 1.0)
VARIANTS = {"plain": {}, "sazo": {"with_sazo": True},
            "attr1": {"n_attr": 1}, "attr4": {"n_attr": 4},
            "attr6": {"n_attr": 6}}


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bit_equal(a, b):
    """Bit for bit, NaN where the other has NaN (an entry holding a NaN
    candidate carries it into every query's moment sums)."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _packed_both(q_t, cand_t, centers, radii, **kw):
    ref = np.asarray(jpk.packed_moments(
        jnp.asarray(q_t), jnp.asarray(cand_t), jnp.asarray(centers), radii,
        interpret=True, entries_per_step=1, **kw))
    args = _torch(q_t, cand_t, centers)
    got = tpm.packed_moments_plain(*args, radii, **kw)
    # the wrapper serves CPU tensors with the plain version
    _bit_equal(tpm.packed_moments(*args, radii, **kw), got)
    return ref, got, args


@pytest.mark.parametrize("exclude_radius", EXCLUDE_RADII)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_packed_exclusion_matches_pallas_kernel(variant, exclude_radius):
    kw = dict(VARIANTS[variant], exclude_radius=exclude_radius)
    if variant == "attr4":
        kw["precision"] = "bf16x2"
    q_t, cand_t, centers = packed_problem(4, 16, 128, RADII, seed=7,
                                          n_attr=kw.get("n_attr", 0))
    ref, got_t, args = _packed_both(q_t, cand_t, centers, RADII, **kw)
    got = got_t.numpy()
    assert got.shape == ref.shape == (4, 16, len(RADII) * MOMENT_PAD)
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    # a NaN on any axis of a query counts nothing
    assert np.all(got[-1, 3:6, COUNTS] == 0)
    # the exclusion drops pairs exactly where f32(e*e) > 0 (the self
    # pairs at least)
    plain = tpm.packed_moments_plain(
        *args, RADII, **{k: v for k, v in kw.items()
                         if k != "exclude_radius"}).numpy()
    dropped = plain[..., COUNTS] - got[..., COUNTS]
    assert dropped.min() == 0
    assert (dropped.sum() > 0) == (np.float32(exclude_radius ** 2) > 0)
    finite = slice(0, 3)
    tol = tpm.moment_tolerance(got_t[finite], args[1][:, :3 * 128],
                               args[2][finite],
                               n_attr=kw.get("n_attr", 0)).numpy()
    assert np.all(np.abs(got[finite] - ref[finite]) <= tol)
    if kw.get("with_sazo"):
        for row in (10, 11):
            np.testing.assert_array_equal(got[finite, :, row::MOMENT_PAD],
                                          ref[finite, :, row::MOMENT_PAD])


def test_threshold_is_f32_of_the_float64_square():
    # E_ROUND's f32(e*e) is the d2 of ring pair k = 1; f32(e)*f32(e) in
    # f32 is larger and would drop that pair
    e_wrong = float(np.sqrt(np.float64(
        np.float32(np.float32(E_ROUND) * np.float32(E_ROUND)))))
    assert np.float32(e_wrong * e_wrong) > np.float32(E_ROUND * E_ROUND)
    q_t, cand_t, centers = packed_problem(4, 16, 128, RADII, seed=7)
    args = _torch(q_t, cand_t, centers)
    right = tpm.packed_moments_plain(*args, RADII, exclude_radius=E_ROUND)
    wrong = tpm.packed_moments_plain(*args, RADII, exclude_radius=e_wrong)
    assert torch.equal(right[:3, 6, COUNTS] - wrong[:3, 6, COUNTS],
                       torch.ones(3, len(RADII)))
    assert tmk.exclusion_threshold(E_ROUND) == float(
        np.float32(E_ROUND * E_ROUND))
    assert tmk.exclusion_args(None) == (0, 0.0)
    assert tmk.exclusion_args(E_ROUND) == (1, float(
        np.float32(E_ROUND * E_ROUND)))


@pytest.mark.parametrize("exclude_radius", EXCLUDE_RADII)
def test_span_exclusion_matches_pallas_kernel(exclude_radius):
    span_rows = 24
    q_local, centers, starts, lens, pts = span_problem(
        3, 16, 9, span_rows, RADII, seed=3)
    n_lanes = -(-(pts.shape[0] + jgk.span_window(span_rows)) // 128) * 128
    sorted_t = np.zeros((4, n_lanes), np.float32)
    sorted_t[:3, :pts.shape[0]] = pts.T
    precision = "bf16x2" if exclude_radius == E_ROUND else "highest"
    ref = np.asarray(jgk.span_moments(
        jnp.asarray(q_local), jnp.asarray(centers), jnp.asarray(starts),
        jnp.asarray(lens), jnp.asarray(sorted_t), RADII, span_rows,
        exclude_radius=exclude_radius, interpret=True, entries_per_step=2,
        precision=precision))
    args = _torch(q_local, centers, starts, lens, pts)
    got_t = tgk.span_moments_plain(*args, RADII, span_rows,
                                   exclude_radius=exclude_radius,
                                   precision=precision)
    got = got_t.numpy()
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert got[..., COUNTS].max() > 0
    tol = tgk.span_tolerance(got_t, *args[1:], span_rows).numpy()
    assert np.all(np.abs(got - ref) <= tol)
    _bit_equal(tgk.span_moments(
        *args, RADII, span_rows, exclude_radius=exclude_radius,
        precision=precision), got_t)


@pytest.mark.parametrize("exclude_radius", EXCLUDE_RADII)
def test_entry_exclusion_matches_pallas_kernel(exclude_radius):
    q, s, valid = entry_problem(4, 16, 120, RADII, seed=5)
    q[3, 1, 0] = np.nan                      # a NaN query counts nothing
    ref = np.asarray(jmk.entry_moments(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(valid), RADII,
        interpret=True, exclude_radius=exclude_radius))
    args = _torch(q, s, valid)
    got_t = tmk.entry_moments_plain(*args, RADII,
                                    exclude_radius=exclude_radius)
    got = got_t.numpy()
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert np.all(got[0, :, COUNTS] == 0)          # no valid slot
    assert np.all(got[3, 1, COUNTS] == 0)
    assert got[1:, :, COUNTS].max() > 0
    tol = tmk.entry_tolerance(got_t, args[1], args[2]).numpy()
    finite = slice(0, 3)
    assert np.all(np.abs(got[finite] - ref[finite]) <= tol[finite])
    _bit_equal(tmk.entry_moments(
        *args, RADII, exclude_radius=exclude_radius), got_t)


@pytest.mark.parametrize("exclude_radius", [0.0, 1e-30])
def test_entry_exclusion_clamps_negative_d2(exclude_radius):
    q, s, valid, d2 = clamp_problem()
    # the guard guards something: the pair's expanded d2 is negative in
    # f32, so an exclusion test without the clamp would drop it
    assert d2 < 0
    assert np.float32(exclude_radius * exclude_radius) == 0
    got = tmk.entry_moments_plain(*_torch(q, s, valid), (0.5,),
                                  exclude_radius=exclude_radius).numpy()
    ref = np.asarray(jmk.entry_moments(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(valid), (0.5,),
        interpret=True, exclude_radius=exclude_radius))
    # the JAX kernel and the twin both count the pair, and nothing for
    # the NaN query or with the NaN candidate
    assert ref[0, 0, 0] == got[0, 0, 0] == 1
    np.testing.assert_array_equal(got[..., COUNTS], ref[..., COUNTS])
    assert got[0, 1, 0] == 0 and got[0, 2:, 0].sum() == 0


def test_exclusion_at_zero_equals_no_exclusion():
    # in the difference form 0.0 drops nothing but NaN pairs, which fail
    # anyway; in the expanded form the clamp passes every non-NaN pair:
    # the slabs are bit-equal
    for kw in VARIANTS.values():
        q_t, cand_t, centers = packed_problem(4, 16, 128, RADII, seed=2,
                                              n_attr=kw.get("n_attr", 0))
        args = _torch(q_t, cand_t, centers)
        _bit_equal(tpm.packed_moments(*args, RADII, exclude_radius=0.0,
                                      **kw),
                   tpm.packed_moments(*args, RADII, **kw))
    args = _torch(*span_problem(3, 16, 9, 24, RADII, seed=4))
    _bit_equal(tgk.span_moments(*args, RADII, 24, exclude_radius=0.0),
               tgk.span_moments(*args, RADII, 24))
    for arrays in (entry_problem(3, 16, 64, RADII, seed=2),
                   clamp_problem()[:3]):
        args = _torch(*arrays)
        _bit_equal(tmk.entry_moments(*args, RADII, exclude_radius=0.0),
                   tmk.entry_moments(*args, RADII))


def test_chebyshev_exclusion_raises_in_both():
    q_t, cand_t, centers = packed_problem(2, 16, 128, (0.5,), seed=0,
                                          n_attr=1)
    with pytest.raises(ValueError):
        jpk.packed_moments(jnp.asarray(q_t), jnp.asarray(cand_t),
                           jnp.asarray(centers), (0.5,), exclude_radius=0.1,
                           interpret=True, n_attr=1, metric="chebyshev")
    for fn in (tpm.packed_moments, tpm.packed_moments_plain):
        with pytest.raises(ValueError, match="exclude_radius"):
            fn(*_torch(q_t, cand_t, centers), (0.5,), exclude_radius=0.1,
               n_attr=1, metric="chebyshev")


def test_exclusion_work_counts_its_operations():
    q_t, cand_t, centers = packed_problem(4, 16, 128, RADII, seed=1)
    args = _torch(q_t, cand_t, centers)
    for sazo in (False, True):
        base = tpm.packed_moments_work(*args, RADII, with_sazo=sazo)
        excl = tpm.packed_moments_work(*args, RADII, with_sazo=sazo,
                                       exclude_radius=0.1)
        ops = 8 + (2 * len(RADII) if sazo else 0)
        assert excl["terms_ms"]["distance"] == pytest.approx(
            base["terms_ms"]["distance"] * (ops + 2) / ops)
        assert excl["pairs"] == base["pairs"]
    span = _torch(*span_problem(3, 16, 9, 24, RADII, seed=4))
    base = tgk.span_moments_work(*span, RADII, 24)["terms_ms"]
    excl = tgk.span_moments_work(*span, RADII, 24,
                                 exclude_radius=0.1)["terms_ms"]
    assert excl["distance"] == pytest.approx(base["distance"] * 10 / 8)
    entry = _torch(*entry_problem(3, 16, 64, RADII, seed=1))
    base = tmk.entry_moments_work(*entry, RADII)["terms_ms"]
    excl = tmk.entry_moments_work(*entry, RADII,
                                  exclude_radius=0.1)["terms_ms"]
    # the compare, the select and the clamp's max
    assert excl["distance"] == pytest.approx(base["distance"] * 11 / 8)


def test_exclusion_instance_names_stay_distinct():
    # chip_smoke.py reads each instance's ptxas line and HMMA count by
    # its kernel_name: the exclusion instances keep names of their own
    from nimrud_tpu_torch.ops.kernels import cuda_build

    mangled = {
        "_ZN12_GLOBAL__N_118packed_excl_kernelILi2ELb1EEEvPKf":
            "packed_excl_kernel<2, true>",
        "_ZN12_GLOBAL__N_123packed_attr_excl_kernelILi1ELi4EEEvPKf":
            "packed_attr_excl_kernel<1, 4>",
        "_ZN12_GLOBAL__N_116span_excl_kernelILi3EEEvPKf":
            "span_excl_kernel<3>",
        "_ZN12_GLOBAL__N_117entry_excl_kernelILi1EEEvPKf":
            "entry_excl_kernel<1>",
        "_ZN12_GLOBAL__N_121packed_moments_kernelILi2ELb1EEEvPKf":
            "packed_moments_kernel<2, true>"}
    for name, expected in mangled.items():
        assert cuda_build.kernel_name(name) == expected
    sass = "\n".join(f"\t\tFunction : {name}\n        HMMA.16816 R4 ;"
                     for name in mangled)
    assert cuda_build.count_sass(sass) == dict.fromkeys(mangled.values(), 1)
