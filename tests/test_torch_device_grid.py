"""
The port's packed extraction against ``nimrud_tpu.ops.device_grid`` on
the same NumPy inputs: the shared query plan, the span tables and the
candidate source map equal the reference; features agree within the
reference tests' own cross-backend tolerance.

The scene is the bench scene at small scale with the bench bands: the
pack grid is the finest band's (tile 0.5, m=3, coarse edge 1.5), so the
three bands take the integer span branch (ratio 3) and the eps-widened
float branch (ratios 1.5 and 0.75).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops import packing as jpk
from nimrud_tpu.ops import unique as juq

from nimrud_tpu_torch.ops import device_grid as tdg
from nimrud_tpu_torch.ops import packing as tpk
from nimrud_tpu_torch.ops import span_host
from nimrud_tpu_torch.ops import unique as tuq
from nimrud_tpu_torch.utils import workload

N = 6000
BANDS = list(zip(workload.BENCH_EDGES, workload.BENCH_RADII))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.fixture(scope="module")
def scene():
    cloud, _ = workload.make_bench_cloud(N, seed=4)
    n_pad = 8192
    padded = np.zeros((n_pad, 3), np.float32)
    padded[:N] = cloud
    padded[N:] = cloud[-1]
    valid = np.arange(n_pad) < N
    lo, hi = cloud.min(0), cloud.max(0)
    bands = []
    for edge, radius in BANDS:
        kw = dict(n_query=n_pad, voxel_edge=edge, q_cap=256, x_seg=32)
        tspec = tdg.with_entry_estimate(
            tdg.make_spec(lo, hi, radius, **kw), cloud)
        jspec = jdg.with_entry_estimate(
            jdg.make_spec(lo, hi, radius, **kw), cloud)
        vt = tpk.GridSpec.fit_bounds(lo, hi, edge)
        vj = jpk.GridSpec.fit_bounds(lo, hi, edge)
        # tile-sorted voxel centers, as the serving step makes them
        tc, _, tm = tuq.unique_voxels(_t(padded), vt, valid=_t(valid),
                                      tile_spec=tspec)
        jc, _, jm = juq.unique_voxels(jnp.asarray(padded), vj,
                                      valid=jnp.asarray(valid),
                                      tile_spec=jspec)
        bands.append({"edge": edge, "radius": radius, "tspec": tspec,
                      "jspec": jspec, "tc": tc, "tm": tm, "jc": jc,
                      "jm": jm})
    tplan = tdg._pack_plan(_t(padded), _t(valid), bands[0]["tspec"])
    jplan = jdg._pack_plan(jnp.asarray(padded), jnp.asarray(valid),
                           bands[0]["jspec"])
    jplan["x_seg_pack"] = tplan["x_seg_pack"]
    return {"cloud": cloud, "padded": padded, "valid": valid, "lo": lo,
            "hi": hi, "bands": bands, "tplan": tplan, "jplan": jplan}


def test_pack_plan_tables_equal(scene):
    t, j = scene["tplan"], scene["jplan"]
    for key in ("start", "count", "q_order", "sorted_qids", "tx_lo",
                "tx_hi", "ty", "tz"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]),
                                      err_msg=key)
    # centers and query blocks bitwise
    np.testing.assert_array_equal(t["centers"].numpy(),
                                  np.asarray(j["centers"]))
    np.testing.assert_array_equal(t["q_t"].numpy(), np.asarray(j["q_t"]))
    assert int(t["count"].sum()) == N


@pytest.mark.parametrize("band", [0, 1, 2])
def test_band_spans_equal(scene, band):
    b = scene["bands"][band]
    ratio = scene["tplan"]["coarse_edge"] / b["tspec"].tile_edge
    assert (abs(ratio - round(ratio)) < 1e-9) == (band == 0)
    t = tdg._band_spans(scene["tplan"], b["tc"], b["tm"], b["tspec"],
                        presorted=True)
    j = jdg._band_spans(scene["jplan"], b["jc"], b["jm"], b["jspec"],
                        presorted=True)
    np.testing.assert_array_equal(t["span_starts"].numpy(),
                                  np.asarray(j["span_starts"]))
    np.testing.assert_array_equal(t["span_lens"].numpy(),
                                  np.asarray(j["span_lens"]))
    assert int(t["span_lens"].sum()) > 0
    # the pack source map and its truncation counter, at a
    # deliberately small cap and at the host-sized split caps
    n_search = b["tc"].shape[0]
    host = span_host.candidate_caps_split(
        None, jms._host_unique_voxels(scene["cloud"], b["edge"],
                                      bounds=(scene["lo"], scene["hi"])),
        b["tspec"], plan=span_host.pack_plan_np(
            scene["cloud"], np.ones(N, bool), scene["bands"][0]["tspec"]))
    caps = host[0] if isinstance(host, tuple) else (host,)
    for cap in (16,) + tuple(caps):
        ts, td = tdg._pack_src(t["span_starts"], t["span_lens"], cap,
                               n_search)
        js, jd = jdg._pack_src(j["span_starts"], j["span_lens"], cap,
                               n_search)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert int(td) == int(jd)
    assert int(tdg._pack_src(t["span_starts"], t["span_lens"], 16,
                             n_search)[1]) > 0


def _compare_features(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got))
    counts = slice(0, None, 4)
    np.testing.assert_array_equal(got[:, counts], ref[:, counts])
    # the reference tests' own cross-backend feature tolerance
    # (tests/test_pallas_kernel.py test_packed_backend_matches_span_backend)
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_fused_extract_packed_matches_reference(scene):
    b = scene["bands"][1]
    vt = tpk.GridSpec.fit_bounds(scene["lo"], scene["hi"], b["edge"])
    vj = jpk.GridSpec.fit_bounds(scene["lo"], scene["hi"], b["edge"])
    q, v = scene["padded"], scene["valid"]
    tc, _, tm = tuq.unique_voxels(_t(q), vt, valid=_t(v))
    jc, _, jm = juq.unique_voxels(jnp.asarray(q), vj, valid=jnp.asarray(v))
    cap = span_host.candidate_cap(
        scene["cloud"], jms._host_unique_voxels(scene["cloud"], b["edge"]),
        b["tspec"])
    got, tstats = tdg.fused_extract_packed(
        _t(q), _t(v), tc, tm, b["tspec"], (b["radius"],), "minimal", N,
        cap, with_stats=True)
    ref, jstats = jdg.fused_extract_packed(
        jnp.asarray(q), jnp.asarray(v), jc, jm, b["jspec"], (b["radius"],),
        "minimal", None, N, cap, interpret=True, with_stats=True)
    _compare_features(got.numpy(), ref)
    for key in ("dropped_query", "dropped_candidates"):
        assert int(tstats[key]) == int(jstats[key]) == 0, key


def test_fused_extract_packed_multi_matches_reference(scene):
    bands = scene["bands"]
    plan = span_host.pack_plan_np(scene["cloud"], np.ones(N, bool),
                                  bands[0]["tspec"])
    caps = tuple(span_host.candidate_caps_split(
        None, jms._host_unique_voxels(scene["cloud"], b["edge"],
                                      bounds=(scene["lo"], scene["hi"])),
        b["tspec"], plan=plan) for b in bands)
    radii = tuple((b["radius"],) for b in bands)
    q, v = scene["padded"], scene["valid"]
    # rank order with an identity reduce, unsorted here to caller order
    (rank, q_order), tstats = tdg.fused_extract_packed_multi(
        _t(q), _t(v), [b["tc"] for b in bands], [b["tm"] for b in bands],
        bands[0]["tspec"], tuple(b["tspec"] for b in bands), radii,
        "minimal", caps, lambda f: (f,), with_stats=True, presorted=True)
    got = torch.empty_like(rank[0])
    got[q_order] = rank[0]
    ref, jstats = jdg.fused_extract_packed_multi(
        jnp.asarray(q), jnp.asarray(v), tuple(b["jc"] for b in bands),
        tuple(b["jm"] for b in bands), bands[0]["jspec"],
        tuple(b["jspec"] for b in bands), radii, "minimal", None, N, caps,
        interpret=True, with_stats=True, presorted=True)
    _compare_features(got[:N].numpy(), ref)
    for key in ("dropped_query", "dropped_candidates"):
        assert int(tstats[key]) == int(jstats[key]), key


@pytest.mark.parametrize("e_cap", [None, 8])
def test_pack_plan_small_cloud_and_entry_overflow(e_cap):
    # more entry slots than query rows (the padded branch), and an
    # entry capacity far below demand (queries left without a slot map
    # to the sentinel position)
    import dataclasses
    cloud = workload.make_bench_cloud(200, seed=3)[0]
    q = np.concatenate([cloud, np.repeat(cloud[-1:], 56, axis=0)])
    v = np.arange(256) < 200
    kw = dict(n_query=256, voxel_edge=0.25, q_cap=16, x_seg=32)
    lo, hi = cloud.min(0), cloud.max(0)
    ts = tdg.with_entry_estimate(tdg.make_spec(lo, hi, 0.5, **kw), cloud)
    js = jdg.with_entry_estimate(jdg.make_spec(lo, hi, 0.5, **kw), cloud)
    if e_cap is not None:
        ts = dataclasses.replace(ts, e_cap=e_cap)
        js = dataclasses.replace(js, e_cap=e_cap)
    assert (ts.e_cap > len(q)) == (e_cap is None)
    t = tdg._pack_plan(_t(q), _t(v), ts)
    j = jdg._pack_plan(jnp.asarray(q), jnp.asarray(v), js)
    for key in ("start", "count", "q_order", "centers", "q_t"):
        np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(
        tdg._unsort_positions(t, ts, len(q), 10**6).numpy(),
        np.asarray(jdg._unsort_positions(j, js, len(q), 10**6)))
