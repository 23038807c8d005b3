"""
The packed attribute interp and the ``vector`` extraction of the port
against the JAX package, on the same NumPy inputs (a scaled-down bench
scene with the reference benchmark's two attribute columns, or six):

* ``multiscale._interp_packed_plan``: the interp's tile spec and its
  split candidate capacities equal the reference's;
* ``ops.interp.packed_interp``: the voxel centers and their mask equal
  the reference's, bit for bit, the overflow counter equal (0), and the
  attribute means within ``attr_tolerance`` (the means of the same
  attributes summed in other orders: at most c_cap terms a sum);
* ``extract_scaleset_fused(kind="vector")`` against the reference's
  packed branch: the same width (A columns a radius) and every mean
  within the interp's tolerance plus the extraction's.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import interp as jinterp
from nimrud_tpu.ops import packing as jpk

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import interp as tinterp
from nimrud_tpu_torch.ops import packing as tpk
from nimrud_tpu_torch.utils import workload as twl

N = 4000
EPS32 = 2.0 ** -24


def _scene(n_attr, seed=0):
    cloud, labels = twl.make_bench_cloud(N, seed=seed)
    attrs = twl.make_bench_attributes(labels)
    if n_attr > 2:
        rng = np.random.default_rng(seed + 7)
        extra = rng.normal(0.0, 1.0, (N, n_attr - 2)) \
            * np.resize([3.0, 250.0, 0.02, 40.0], n_attr - 2)
        attrs = np.concatenate([attrs, extra], axis=1).astype(np.float32)
    return cloud, labels, attrs


def _max_cap(cap):
    return max(cap[0]) if isinstance(cap, tuple) else int(cap)


def attr_tolerance(attrs, c_cap):
    """Per column: two f32 sums of at most ``c_cap`` terms of |value| <=
    the column's extent differ by at most 2 (c_cap - 1) u count extent;
    over the count, plus each division's rounding (u |mean| each)."""
    extent = np.abs(attrs).max(0).astype(np.float64)
    return 2.0 * (c_cap + 1) * EPS32 * extent


@pytest.mark.parametrize("n_attr,edge", [(2, 0.5), (6, 0.25), (1, 1.0)])
def test_packed_interp_matches_reference(n_attr, edge):
    cloud, _, attrs = _scene(n_attr)
    if n_attr == 1:
        attrs = attrs[:, :1].copy()
    lo, hi = cloud.min(0).astype(np.float64), cloud.max(0).astype(np.float64)
    tvox = tpk.GridSpec.fit_bounds(lo, hi, edge)
    jvox = jpk.GridSpec.fit_bounds(lo, hi, edge)
    tspec, tcap = tms._interp_packed_plan(cloud, tvox, lo, hi, (lo, hi), 3)
    jspec, jcap = jms._interp_packed_plan(cloud, jvox, lo, hi, (lo, hi), 3)
    assert tspec.__dict__ == jspec.__dict__ and tspec.q_cap == 128
    assert tcap == jcap

    n_pad = 4096
    search = tms._pad_rows_f32(cloud, n_pad)
    apad = tms._pad_rows_f32(attrs, n_pad)
    valid = np.arange(n_pad) < N
    jc, jm, ja, js = jinterp.packed_interp(
        jnp.asarray(search), jnp.asarray(valid), jnp.asarray(apad), jvox,
        jspec, jcap, with_stats=True)
    tc, tm, ta, ts = tinterp.packed_interp(
        torch.from_numpy(search), torch.from_numpy(valid),
        torch.from_numpy(apad), tvox, tspec, tcap, with_stats=True)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(ts["dropped_search"]) == int(js["dropped_search"]) == 0
    ta, ja = ta.numpy(), np.asarray(ja)
    assert ta.shape == ja.shape == (n_pad, n_attr)
    mask = tm.numpy()
    assert np.all(ta[~mask] == 0)
    assert np.all(np.isfinite(ta))
    tol = attr_tolerance(attrs, _max_cap(tcap))
    assert np.all(np.abs(ta - ja) <= tol)
    # every live center sees at least its own voxel's points
    assert np.abs(ta[mask]).sum() > 0


def test_packed_interp_takes_a_ball_up_to_the_edge():
    cloud, _, attrs = _scene(2)
    lo, hi = cloud.min(0), cloud.max(0)
    vox = tpk.GridSpec.fit_bounds(lo, hi, 0.5)
    spec, cap = tms._interp_packed_plan(cloud, vox, lo, hi, (lo, hi), 3)
    args = (torch.from_numpy(cloud), torch.ones(N, dtype=torch.bool),
            torch.from_numpy(attrs), vox, spec, cap)
    with pytest.raises(ValueError, match="one voxel"):
        tinterp.packed_interp(*args, radius=0.75)
    small = tinterp.packed_interp(*args, radius=0.25)[2]
    full = tinterp.packed_interp(*args)[2]
    assert small.shape == full.shape and not torch.equal(small, full)


@pytest.mark.parametrize("n_attr,precision,fixed", [
    (2, "highest", True), (4, "bf16x2", False)])
def test_vector_extraction_matches_reference(n_attr, precision, fixed):
    cloud, _, attrs = _scene(n_attr, seed=1)
    query = cloud[::3].copy()
    scaleset = [(0.25, (0.5,)), (0.5, (1.0, 0.75))]
    bounds = (cloud.min(0) - 0.3, cloud.max(0) + 0.4) if fixed else None
    ref = np.asarray(jms.extract_scaleset_fused(
        query, cloud, scaleset, "vector", attributes=attrs,
        tuning={"backend": "packed", "precision": precision},
        bounds=bounds))
    got = tms.extract_scaleset_fused(
        query, cloud, scaleset, "vector", attributes=attrs, bounds=bounds,
        precision=precision, device="cpu").numpy()
    assert got.shape == ref.shape == (len(query), n_attr * 3)
    assert np.all(np.isfinite(got))
    # the interp's means feed the extraction's: both tolerances, with
    # capacities up to a few thousand candidates at this size
    tol = np.tile(attr_tolerance(attrs, 2 * 4096), 3)
    assert np.all(np.abs(got - ref) <= tol)
    assert np.abs(got).sum() > 0
