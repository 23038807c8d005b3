"""
The serving path's spans and counters (``nimrud_tpu_torch.utils
.profiling``) on the CPU, on a one-band model whose staged step runs in
two entry chunks:

* under ``torch.profiler``, ``install_classifier``'s sizing, ``stage``
  and ``predict_staged`` export every span into the chrome trace, each
  inside its parent's range, and keep their records: the parents as
  PERF.md's table gives them, one scan id for all of a scan's spans;
* with no profiler session a served step (``predict_stream``: staged in
  its worker thread) calls ``record_function`` zero times, makes no CUDA
  event and adds nothing to what ``collected()`` returns;
* ``slots`` is e_cap x q_cap over the entry chunks, ``slots_live`` the
  cloud's points;
* ``lanes_live`` is ``packed_moments_work``'s live lanes of the blocks
  the step launched, ``lanes`` their lanes and the lanes the specs give;
* a ``vector`` step's attribute interp runs in one
  ``nimrud.predict.search.interp`` span a band and counts its plan and
  kernel under ``interp_slots*`` / ``interp_lanes*``, so ``slots*`` and
  ``lanes*`` count the extraction alone; a ``minimal`` step opens no
  such span and counts no ``interp_*``;
* past the buffer's bound a span still opens its range, and its record
  is counted as dropped; a child span's ``.name`` is named under its
  parent, and counters are kept a scan;
* a torch without the profiler's flag turns the spans off;
* ``stage`` counts the host runtime's quantization workers
  (``quantize_workers``) under the profiler, and nothing without it.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nimrud_tpu_torch import pipeline
from nimrud_tpu_torch.features import multiscale
from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.ops.kernels import packed_moments as pm
from nimrud_tpu_torch.utils import profiling, workload

from torch_thread_cases import one_torch_thread  # noqa: F401

N = 3000
CHUNK_SLOTS = 256 * 512       # e_cap 512 at q_cap 512: two chunks

PARENTS = {
    "nimrud.size": None,
    "nimrud.stage": None,
    "nimrud.stage.specs": "nimrud.stage",
    "nimrud.stage.quantize": "nimrud.stage",
    "nimrud.stage.upload": "nimrud.stage",
    "nimrud.predict": None,
    "nimrud.predict.search": "nimrud.predict",
    "nimrud.predict.plan": "nimrud.predict",
    "nimrud.predict.spans": "nimrud.predict",
    "nimrud.predict.moments": "nimrud.predict",
    "nimrud.predict.classify": "nimrud.predict",
    "nimrud.predict.scatter": "nimrud.predict",
}


def _model(cloud):
    model = pipeline.GeometryClassifier(
        [(0.25, (0.5,))], transfer_dtype="uint16", backend="packed",
        bounds=(cloud.min(0), cloud.max(0)), trim_entries=True,
        device="cpu", serving_chunk_slots=CHUNK_SLOTS)
    rng = np.random.default_rng(0)
    clf = SoftmaxClassifier.from_state(
        rng.standard_normal((4, 3)), np.zeros(3), np.zeros(4), np.ones(4),
        "cpu")
    return model, clf


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One profiled install, stage and step: the model, the staged
    handle, the labels, the recorded spans and counters, the chrome
    trace's ranges and the moment kernel's blocks."""
    cloud = workload.make_bench_cloud(N, seed=0)[0] * np.float32(0.5)
    model, clf = _model(cloud)
    blocks = []
    original = pm.packed_moments

    def packed_moments(q_t, cand_t, centers, radii, **kw):
        blocks.append((q_t, cand_t, centers, radii))
        return original(q_t, cand_t, centers, radii, **kw)

    profiling.reset()
    pm.packed_moments = packed_moments
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.install_classifier(clf, cloud)
            staged = model.stage(cloud)
            labels = model.predict_staged(staged)
    finally:
        pm.packed_moments = original
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    return {"cloud": cloud, "model": model, "staged": staged,
            "labels": labels, "collected": profiling.collected(),
            "ranges": ranges, "blocks": blocks}


def _pack_spec(staged):
    return min((s[1] for s in staged["specs"]), key=lambda d: d.tile_edge)


def test_spans_export_nested_with_one_scan_id(traced):
    ranges = traced["ranges"]
    assert {name for name, _, _ in ranges} == set(PARENTS)
    for name, lo, hi in ranges:
        parent = PARENTS[name]
        if parent is not None:
            assert any(p == parent and p_lo <= lo and hi <= p_hi
                       for p, p_lo, p_hi in ranges), name
    got = traced["collected"]
    assert got["dropped"] == 0
    spans = got["spans"]
    assert sorted({s["name"] for s in spans}) == sorted(PARENTS)
    assert all(s["parent"] == PARENTS[s["name"]] for s in spans)
    scan = traced["staged"]["scan"]
    served = [s for s in spans if s["name"] != "nimrud.size"]
    assert all(s["device_ms"] == s["host_ms"] >= 0 for s in served)
    assert {s["scan"] for s in served} == {scan}
    assert scan not in {s["scan"] for s in spans
                        if s["name"] == "nimrud.size"}
    names = [s["name"] for s in served]
    spec = _pack_spec(traced["staged"])
    chunk = pipeline._serving_entry_chunk(spec.e_cap, spec.q_cap,
                                          CHUNK_SLOTS)
    assert -(-spec.e_cap // chunk) == 2
    assert names.count("nimrud.predict.moments") == 2    # one band
    assert names.count("nimrud.predict.classify") == 2


def test_no_profiler_no_span(traced, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("tracing work with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    before = profiling.collected()
    labels = list(traced["model"].predict_stream([traced["cloud"]]))
    assert torch.equal(labels[0], traced["labels"])
    assert profiling.collected() == before
    assert not profiling.recording()


def test_slot_counters(traced):
    spec = _pack_spec(traced["staged"])
    counters = traced["collected"]["counters"]
    assert counters["slots"] == spec.e_cap * spec.q_cap
    assert counters["slots_live"] == N


def test_lane_counters_are_the_kernels_live_lanes(traced):
    blocks = traced["blocks"]
    assert len(blocks) >= 2
    live = sum(pm.packed_moments_work(q, cand, c, radii)["pairs"]
               // q.shape[2] for q, cand, c, radii in blocks)
    counters = traced["collected"]["counters"]
    assert counters["lanes_live"] == live > 0
    spec = _pack_spec(traced["staged"])
    c_cap = traced["staged"]["specs"][0][5]
    assert counters["lanes"] == sum(cand.shape[1] for _, cand, _, _ in blocks)
    assert counters["lanes"] == workload._packed_lane_total(
        c_cap, spec.e_cap,
        pipeline._serving_entry_chunk(spec.e_cap, spec.q_cap, CHUNK_SLOTS))


def test_buffer_bound_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder(limit=3))
    scans = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(5):
            with profiling.span("nimrud.test", top=True) as record:
                scans.append(record.scan)
                with profiling.span(".child"):
                    profiling.count("things", k)
        with profiling.span("nimrud.test.orphan") as record:
            assert record is None            # no parent: nothing
    got = profiling.collected()
    assert [s["name"] for s in got["spans"]] == [
        "nimrud.test", "nimrud.test.child", "nimrud.test"]
    assert got["dropped"] == 7 and got["counters"] == {"things": 10}
    assert got["scans"] == {scan: {"things": k}
                            for k, scan in enumerate(scans)}
    opened = [e.name for e in prof.events()
              if e.name.startswith("nimrud.test")]
    assert opened.count("nimrud.test") == 5
    assert opened.count("nimrud.test.child") == 5
    assert "nimrud.test.orphan" not in opened


def test_a_torch_without_the_flag_turns_spans_off(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
        off = profiling.span("nimrud.test", top=True)
        recording = profiling.recording()
        monkeypatch.undo()             # the session's flag, before its exit
    assert off is profiling._OFF and not recording
    assert not torch.autograd.profiler._is_profiler_enabled


INTERP = "nimrud.predict.search.interp"
TWO_BANDS = [(0.25, (0.5,)), (0.5, (1.0,))]


@pytest.mark.parametrize("kind", ["minimal", "vector"])
def test_interp_span_and_counters(kind):
    """One profiled two-band step: the interp's span a band and its
    counters under their own names (``vector``), the extraction's lanes
    and slots as the specs give them, alone, in both kinds."""
    cloud = workload.make_bench_cloud(N, seed=1)[0] * np.float32(0.5)
    attrs = None
    width = 4 if kind == "minimal" else 2
    if kind == "vector":
        attrs = np.random.default_rng(2).random((N, 2)).astype(np.float32)
    model = pipeline.GeometryClassifier(
        TWO_BANDS, kind=kind, transfer_dtype="uint16", backend="packed",
        bounds=(cloud.min(0), cloud.max(0)), trim_entries=True,
        device="cpu", serving_chunk_slots=CHUNK_SLOTS)
    rng = np.random.default_rng(3)
    clf = SoftmaxClassifier.from_state(
        rng.standard_normal((2 * width, 3)), np.zeros(3),
        np.zeros(2 * width), np.ones(2 * width), "cpu")
    kw = {} if attrs is None else {"attributes": attrs}
    model.install_classifier(clf, cloud, **kw)
    widths = {"euclidean": 0, "chebyshev": 0}
    original = pm.packed_moments

    def packed_moments(q_t, cand_t, centers, radii, **kw):
        widths[kw.get("metric", "euclidean")] += cand_t.shape[1]
        return original(q_t, cand_t, centers, radii, **kw)

    profiling.reset()
    pm.packed_moments = packed_moments
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            staged = model.stage(cloud, **kw)
            model.predict_staged(staged)
    finally:
        pm.packed_moments = original
    got = profiling.collected()
    counters = got["counters"]
    interps = [s for s in got["spans"] if s["name"] == INTERP]
    spec = _pack_spec(staged)
    chunk = pipeline._serving_entry_chunk(spec.e_cap, spec.q_cap,
                                          CHUNK_SLOTS)
    lanes = sum(workload._packed_lane_total(band[5], spec.e_cap, chunk)
                for band in staged["specs"])
    assert counters["lanes"] == widths["euclidean"] == lanes
    assert counters["slots"] == spec.e_cap * spec.q_cap
    assert counters["slots_live"] == N
    assert 0 < counters["lanes_live"] <= counters["lanes"]
    if kind == "minimal":
        assert interps == [] and widths["chebyshev"] == 0
        assert not any(name.startswith("interp_") for name in counters)
        assert not any(s["name"].endswith(".interp") for s in got["spans"])
        return
    assert len(interps) == len(TWO_BANDS)
    assert all(s["parent"] == "nimrud.predict.search"
               and s["scan"] == staged["scan"] for s in interps)
    assert counters["interp_lanes"] == widths["chebyshev"] > 0
    assert 0 < counters["interp_lanes_live"] <= counters["interp_lanes"]
    assert 0 < counters["interp_slots_live"] <= counters["interp_slots"]
    assert set(counters) == {"quantize_workers"} | {
        f"{prefix}{name}" for prefix in ("", "interp_")
        for name in ("lanes", "lanes_live", "slots", "slots_live")}


@pytest.mark.parametrize("n", [150_000, 1_100_000])
def test_quantize_workers_counter(n):
    """``stage`` counts the host runtime's quantization workers under the
    profiler: one for each 1M rows of the bucket up to the process's
    CPUs, one where the bucket stays on the caller's thread (150,000
    points in 256K rows) and up to two past it (1.1M points in 2M rows);
    with no session it counts nothing."""
    cloud = workload.make_bench_cloud(n, seed=2)[0] * np.float32(0.5)
    model, _ = _model(cloud)
    q_bucket = multiscale._pow2_bucket(n)
    assert q_bucket == (1 << 18 if n < 2**20 else 1 << 21)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        model.stage(cloud)
    counters = profiling.collected()["counters"]
    assert counters["quantize_workers"] == max(1, min(
        len(os.sched_getaffinity(0)), q_bucket >> 20))
    before = profiling.collected()
    model.stage(cloud)
    assert profiling.collected() == before
