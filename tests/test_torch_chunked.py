"""
Entry-chunked serving against the JAX package.

* ``device_grid.fused_extract_packed_multi`` with ``entry_chunk=96`` (a
  ragged last chunk: e_cap 256 = 96 + 96 + 64) against the reference's
  chunked program (``interpret=True``; its last chunk zero-padded) on
  the scene of its own chunked test, at its single capacity, for
  ``minimal`` with designated ``search_tables``, ``sazo`` (the sazo
  instance) and ``vector`` (attribute rows).  The rank-order rows of an
  identity reduce: counts equal, the other features within the
  reference tests' cross-backend tolerance (1e-3), counters equal.  At
  one capacity the port's chunked rows equal its un-chunked rows bit
  for bit.  Split capacities (sized per chunk) are not bitwise: a
  chunk's buckets run at other capacities than the whole plan's, and
  the plain twin's ``matmul`` sums a row's candidates in another order
  at another ``c_cap`` (about 1e-5 on this scene); the serving case
  below runs them.
* Every ``order`` ("caller", "plan", "rank", with and without a reduce,
  "plan" also chunked) against the reference's "plan" rows and
  positions and its position helpers on its own plan: positions equal,
  rows within the same tolerance.
* ``pipeline._serving_entry_chunk`` equals the reference's on a grid
  of (e_cap, q_cap, chunk_slots).
* A model with ``serving_chunk_slots`` giving 4 chunks: its specs equal
  the reference's (same ``serving_chunk_slots``) field by field, its
  counters and labels equal the reference's chunked labels (except at
  reference near-ties, as ``tests/test_torch_pipeline.py`` holds them)
  and the port's own un-chunked labels exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu import pipeline as jpl
from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops import packing as jpk
from nimrud_tpu.ops import unique as juq
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.ops import device_grid as tdg
from nimrud_tpu_torch.ops import packing as tpk
from nimrud_tpu_torch.ops import span_host
from nimrud_tpu_torch.ops import unique as tuq
from nimrud_tpu_torch.utils import workload as twl

from test_torch_device_grid import _compare_features
from test_torch_pipeline import _carried, _serve_both
from torch_thread_cases import one_torch_thread  # noqa: F401

N = 6000
N_PAD = 8192
CHUNK = 96
N_SERVE = 4000       # the bench scene: e_cap 1024, 4 chunks of 256
EDGE = 0.25
RADII = (0.8, 0.4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _identity(args, feats):
    """The reference's reduce signature: (reduce_args, rows) -> tuple."""
    return (feats,)


@pytest.fixture(scope="module")
def scene():
    """The reference test's chunked scene (tests/test_pallas_kernel.py
    test_packed_entry_chunked_matches_unchunked: 6000 points on a 12 x
    12 x 3 m block, one band, q_cap 64, x_seg 4, so e_cap 256)."""
    rng = np.random.default_rng(34)
    pts = (rng.random((N, 3)) * [12, 12, 3]).astype(np.float32)
    padded = np.vstack([pts, np.zeros((N_PAD - N, 3), np.float32)])
    valid = np.arange(N_PAD) < N
    attrs = rng.standard_normal((N_PAD, 2)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    kw = dict(n_query=N_PAD, voxel_edge=EDGE, q_cap=64, x_seg=4)
    spec = tdg.make_spec(lo, hi, max(RADII), **kw)
    jspec = jdg.make_spec(lo, hi, max(RADII), **kw)
    assert spec.e_cap == 256
    tc, _, tm = tuq.unique_voxels(
        _t(padded), tpk.GridSpec.fit_bounds(lo, hi, EDGE), valid=_t(valid),
        tile_spec=spec)
    jc, _, jm = juq.unique_voxels(
        jnp.asarray(padded), jpk.GridSpec.fit_bounds(lo, hi, EDGE),
        valid=jnp.asarray(valid), tile_spec=jspec)
    edge = EDGE

    def cap(search=None):
        return span_host.candidate_cap(
            pts, jms._host_unique_voxels(pts, edge, bounds=(lo, hi))
            if search is None else search, spec)

    return {"pts": pts, "padded": padded, "valid": valid, "attrs": attrs,
            "tspec": spec, "jspec": jspec, "tc": tc, "tm": tm, "jc": jc,
            "jm": jm, "cap": cap}


def _port(scene, kind, order="rank", chunk=CHUNK, reduce=True,
          tables=False):
    """The port's ``fused_extract_packed_multi`` on the scene at the
    single capacity of the reference's test (so each chunk is one
    kernel call in the interpret-mode reference): (outputs, stats)."""
    vector = kind == "vector"
    search, mask = (_t(scene["padded"]), _t(scene["valid"])) if vector \
        else (scene["tc"], scene["tm"])
    kw = {}
    if tables:
        kw["search_tables"] = (tdg._search_tables(
            search, mask, scene["tspec"], presorted=True),)
    out, stats = tdg.fused_extract_packed_multi(
        _t(scene["padded"]), _t(scene["valid"]), [search], [mask],
        scene["tspec"], (scene["tspec"],), (RADII,), kind,
        (scene["cap"](scene["pts"] if vector else None),),
        (lambda f: (f,)) if reduce else None, with_stats=True,
        presorted=not vector,
        attributes=(_t(scene["attrs"]),) if vector else None, order=order,
        n_out=N, entry_chunk=chunk, **kw)
    assert int(stats["dropped_query"]) == 0
    assert int(stats["dropped_candidates"]) == 0
    return out


def _reference(scene, kind, order="rank", chunk=CHUNK, reduce=True,
               tables=False):
    """The reference's ``fused_extract_packed_multi`` on the same
    inputs, in interpret mode."""
    vector = kind == "vector"
    search, mask = (jnp.asarray(scene["padded"]),
                    jnp.asarray(scene["valid"])) if vector \
        else (scene["jc"], scene["jm"])
    kw = {}
    if tables:
        kw["search_tables"] = (jdg._search_tables(
            search, mask, scene["jspec"], presorted=True),)
    out, stats = jdg.fused_extract_packed_multi(
        jnp.asarray(scene["padded"]), jnp.asarray(scene["valid"]),
        (search,), (mask,), scene["jspec"], (scene["jspec"],), (RADII,),
        kind, None, N, (scene["cap"](scene["pts"] if vector else None),),
        interpret=True, with_stats=True, order=order,
        attributes=(jnp.asarray(scene["attrs"]),) if vector else None,
        entry_chunk=chunk, reduce_fn=_identity if reduce else None,
        presorted=not vector, **kw)
    assert int(stats["dropped_candidates"]) == 0
    return out


def _compare(kind, got, ref):
    """Rows of one layout against the reference's: ``minimal`` counts
    equal and the rest within 1e-3 (``_compare_features``); ``sazo`` its
    sazo column equal and its density within 2^-22 (XLA may divide by
    the reciprocal), the rest within 1e-3; ``vector`` its attribute
    means within 1e-3."""
    got, ref = np.asarray(got), np.asarray(ref)
    if kind == "minimal":
        _compare_features(got, ref)
        return
    if kind == "sazo":
        np.testing.assert_array_equal(got[:, 4::5], ref[:, 4::5])
        np.testing.assert_allclose(got[:, 0::5], ref[:, 0::5],
                                   rtol=2.0 ** -22)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("kind,tables", [("minimal", True),
                                         ("sazo", False),
                                         ("vector", False)])
def test_chunked_rows_match_reference(scene, kind, tables):
    t_rank, t_order = _port(scene, kind, tables=tables)
    j_rank, j_order = _reference(scene, kind, tables=tables)
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    _compare(kind, t_rank[0].numpy()[:N], np.asarray(j_rank[0])[:N])
    # chunked against un-chunked on the port, at one capacity
    whole, _ = _port(scene, kind, chunk=None, tables=tables)
    assert torch.equal(t_rank[0], whole[0])


def test_orders_match_reference(scene):
    """Every order of the port against the reference's "plan" rows and
    positions and its own position helpers on the reference's plan."""
    j_flat, j_pos = _reference(scene, "minimal", order="plan", chunk=None,
                               reduce=False)
    j_flat, j_pos = np.asarray(j_flat), np.asarray(j_pos)
    n_rows = j_flat.shape[0]
    assert (j_pos < n_rows).all()
    jplan = jdg._pack_plan(jnp.asarray(scene["padded"]),
                           jnp.asarray(scene["valid"]), scene["jspec"])
    j_rank_pos = np.asarray(jdg._rank_positions(jplan, scene["jspec"],
                                                N_PAD, n_rows))

    _compare_features(_port(scene, "minimal", order="caller").numpy(),
                      j_flat[j_pos])
    for chunk in (None, CHUNK):
        flat, pos = _port(scene, "minimal", order="plan", chunk=chunk,
                          reduce=chunk is not None)
        if chunk is not None:       # the reduce's rows and a zero row
            assert not flat[0][-1].any()
            flat = flat[0][:-1]
        np.testing.assert_array_equal(pos.numpy(), j_pos)
        _compare_features(flat.numpy(), j_flat)
    flat, pos_r, order = _port(scene, "minimal", reduce=False)
    np.testing.assert_array_equal(pos_r.numpy(), j_rank_pos)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jplan["q_order"]))
    _compare_features(flat.numpy(), j_flat)
    # the rank order of a reduce: the rows at each rank's position
    (rank,), order = _port(scene, "minimal", chunk=None)
    _compare_features(rank.numpy()[:N], j_flat[j_rank_pos[:N]])


def test_order_must_be_known(scene):
    with pytest.raises(ValueError, match="unknown order"):
        _port(scene, "minimal", order="rows")


def test_serving_entry_chunk_equals_reference():
    for e_cap in (256, 1024, 3840, 40960):
        for q_cap in (64, 256, 512):
            for slots in (None, 1, 1024, 256 * 512, 300_000, 2 ** 21,
                          2 ** 40):
                assert tpl._serving_entry_chunk(e_cap, q_cap, slots) \
                    == jpl._serving_entry_chunk(e_cap, q_cap, slots), \
                    (e_cap, q_cap, slots)


@pytest.fixture(scope="module")
def fitted():
    cloud, labels = twl.make_bench_cloud(N_SERVE, seed=0)
    ref = jwl.make_bench_model(cloud, serving_chunk_slots=256 * 512)
    ref.fit(cloud, labels, sample=N_SERVE // 2)
    return cloud, ref


def test_chunked_serving_matches_reference(fitted):
    cloud, ref = fitted
    port = twl.make_bench_model(cloud, device="cpu",
                                serving_chunk_slots=256 * 512)
    port.install_classifier(_carried(ref.classifier), cloud)
    (_, jspecs), (_, tspecs) = ref._spec_cache, port._spec_cache
    pack = min((s[1] for s in tspecs), key=lambda s: s.tile_edge)
    assert tpl._serving_entry_chunk(pack.e_cap, pack.q_cap, 256 * 512) \
        == 256 and pack.e_cap == 1024
    for j, t in zip(jspecs, tspecs):
        assert t[0].__dict__ == j[0].__dict__
        assert t[1].__dict__ == j[1].__dict__
        assert (t[2], t[4], t[5]) == (j[2], j[4], j[5])
    # the chunked split capacities are not the un-chunked ones
    whole = twl.make_bench_model(cloud, device="cpu")
    whole.install_classifier(_carried(ref.classifier), cloud)
    assert [t[5] for t in tspecs] != [t[5] for t in whole._spec_cache[1]]

    other, _ = twl.make_bench_cloud(N_SERVE, seed=1)
    _serve_both(ref, port, other)
    chunked, chunked_probs = port.predict_staged(port.stage(other),
                                                 with_proba=True)
    labels, probs = whole.predict_staged(whole.stage(other),
                                         with_proba=True)
    assert torch.equal(chunked, labels)
    assert torch.equal(chunked_probs, probs)
