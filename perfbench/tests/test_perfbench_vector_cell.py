"""The ``site_vector.rescan_attributed_1m`` cell on the CPU: its tiny run
is correct and fills the interp's work; its configuration keeps to the
contract, with its one cut of scale; and its four per-layer readers
(``interp_ms``, ``interp_lane_live_share``, ``interp_roofline``,
``attr_moments_roofline``) give the expected values from hand-made
records and from a profiled tiny step, and None -- never 0 -- where
there is nothing to read: a program without the interp's span and
counters (the parent commit's), a geometry layout, no trace."""

import pytest

from perfbench.core import bench, peaks
from perfbench.core import cell as cellmod
from perfbench.metrics import (attr_moments_roofline, interp_lane_live_share,
                               interp_ms, interp_roofline)
from perfbench_tiny import tiny_cell, tiny_run

from nimrud_tpu_torch.utils import profiling

CELL = "site_vector.rescan_attributed_1m"
SPAN = "nimrud.predict.search.interp"
READERS = (interp_ms, interp_lane_live_share, interp_roofline,
           attr_moments_roofline)


def test_a_tiny_run_of_the_cell_is_correct():
    line, checks, records = tiny_run(CELL, trace=True, points=30000,
                                     check_rows=1024)
    assert line["correct"] is True and line["failed"] == 0, checks
    assert set(checks) == {"failed_clouds", "gap_median", "miss_share"}
    work = records["work"]
    assert work["attr_cols"] == [4.0, 4.0, 4.0]
    assert all(p > v > 0 for p, v in zip(work["interp_pairs"],
                                         work["voxels"]))
    # a CPU run has no device trace: the device readers read nothing
    assert "trace" not in records
    for reader in READERS:
        assert reader.read(records) is None


def test_the_configuration_keeps_to_the_contract():
    cell = cellmod.Cell(CELL)
    cfg, entry = cell.config, cell.entry
    assert entry["chips"] == 1 and cfg["kind"] == "vector"
    assert cell.traffic["generator"] == "rescan_attributed"
    assert cell.traffic["attributes"] == 4
    linear = cellmod.config("site_linear")
    for key in ("bands", "classifier", "classifier_fit", "transfer_dtype",
                "backend", "trim_entries", "precision", "site_bounds",
                "control_frame_m"):
        assert cfg[key] == linear[key], key
    bench_entry = {c["name"]: c for c in cellmod.load_benchmark()["configs"]}
    assert cfg["reduced"] == bench_entry["site_vector"]["reduced"] \
        == ["points"]
    assert set(cfg["reduced_why"]) == set(cfg["reduced"])
    assert set(cfg["checks"]) == {"gap_median", "miss_share"}
    assert set(cfg["limits"]) == {"gap_median", "miss_share", "miss_gap"}
    assert all(len(why) > 40 for why in cfg["limits"].values())
    assert 0 < cfg["miss_gap"] < 1
    names = {m["name"] for m in cell.per_layer}
    assert {r.__name__.rsplit(".", 1)[-1] for r in READERS} <= names
    assert {m["name"] for m in cell.end_to_end} == {"points_per_s",
                                                    "setup_s"}


def _host(name, lo_us, hi_us):
    return (name, lo_us, hi_us, "user_annotation")


def _span(name, scan, ms, start_ns=0):
    return {"name": name, "parent": None, "scan": scan, "start_ns": start_ns,
            "end_ns": start_ns + int(ms * 1e6), "host_ms": ms,
            "device_ms": ms}


WORK = {"points": 1_000_000, "pairs": [3e7, 4e7, 5e7],
        "voxels": [4e5, 2e5, 1e5], "interp_pairs": [6e6, 4.6e6, 4.5e6],
        "interp_ambiguous": [5431, 493, 418], "attr_cols": [4, 4, 4]}
HAND = {
    "work": WORK,
    "trace": {"clouds": 2, "window_us": (0.0, 1e6),
              "device": [("void packed_interp_kernel<4>(...)", 0.0, 1000.0),
                         ("void packed_interp_kernel<4>(...)", 2e3, 3e3),
                         ("void packed_attr_kernel<1, 4>(...)", 4e3, 4.5e3),
                         ("void packed_attr_kernel<1, 4>(...)", 5e3, 5.3e3),
                         ("void packed_moments_kernel<1>(...)", 6e3, 9e3)],
              "host": [_host("nimrud.predict", 10.0, 4010.0),
                       _host("nimrud.predict", 5e3, 7e3)]}}
# scan 9: another profiler session of the process, left out
COLLECTED = {
    "spans": [_span("nimrud.predict", 9, 30.0, 1), _span(SPAN, 9, 25.0),
              _span("nimrud.predict", 1, 3.99, 10), _span(SPAN, 1, 1.0),
              _span(SPAN, 1, 2.0), _span(SPAN, 1, 3.0),
              _span("nimrud.predict", 2, 1.98, 20), _span(SPAN, 2, 1.5),
              _span(SPAN, 2, 1.5), _span(SPAN, 2, 1.0)],
    "counters": {},
    "scans": {9: {"interp_lanes": 100, "interp_lanes_live": 100},
              1: {"interp_lanes": 400, "interp_lanes_live": 30,
                  "lanes": 10, "lanes_live": 10},
              2: {"interp_lanes": 600, "interp_lanes_live": 70}},
    "dropped": 0}


def test_readers_on_hand_made_records(monkeypatch):
    monkeypatch.setattr(profiling, "collected", lambda: COLLECTED)
    assert interp_ms.read(HAND) == 5.0           # scans 6 and 4 ms
    assert interp_lane_live_share.read(HAND) == 10.0
    bound, term = peaks.interp_bound_s(1_000_000, WORK["interp_pairs"],
                                       WORK["voxels"], 5)
    assert term == "bytes"
    assert interp_roofline.read(HAND) == pytest.approx(
        100.0 * bound / 1e-3)                   # 2 ms over 2 clouds
    bound, _ = peaks.moments_bound_s(1_000_000, WORK["pairs"],
                                     WORK["voxels"], cols=5, voxel_bytes=28)
    assert attr_moments_roofline.read(HAND) == pytest.approx(
        100.0 * bound / 0.4e-3)                 # 0.8 ms over 2 clouds
    for reader in READERS:
        assert 0 < reader.read(HAND)


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_readers_none_where_nothing_is_read(reader, monkeypatch):
    # a program without the interp's span and counters (the parent's)
    monkeypatch.setattr(profiling, "collected", lambda: dict(
        COLLECTED, spans=[s for s in COLLECTED["spans"] if s["name"] != SPAN],
        scans={k: {"lanes": 10, "lanes_live": 5} for k in (1, 2, 9)}))
    geometric = dict(HAND, work={k: WORK[k]
                                 for k in ("points", "pairs", "voxels")})
    no_kernels = dict(HAND, trace=dict(HAND["trace"], device=[
        e for e in HAND["trace"]["device"] if "packed_moments" in e[0]]))
    for records in ({"clouds": []}, geometric, no_kernels):
        assert reader.read(records) is None
    if reader in (interp_ms, interp_lane_live_share):
        assert reader.read(HAND) is None
    monkeypatch.delattr(profiling, "collected")
    assert reader.read({"clouds": [], "work": WORK}) is None


@pytest.fixture(scope="module")
def profiled():
    """Two tiny scans of the cell under the harness's profiler: the
    records, the program's spans and counters, and the segment's
    scans."""
    cell = tiny_cell(CELL, points=6000)
    setup = bench.Setup(cell, 2 ** 31 + 13, "cpu")
    model, handle = setup.program()
    server = bench.Server(model, handle, "cpu", setup.stage_kw())
    pool = setup.traffic.pool
    server.step(pool[0])
    profiling.reset()
    records = {"trace": bench._profile(server, pool[:2])}
    got = profiling.collected()
    return records, got, len(cell.config["bands"])


def test_span_readers_on_a_profiled_tiny_step(profiled):
    records, got, n_bands = profiled
    spans = [s for s in got["spans"] if s["name"] == SPAN]
    scans = {s["scan"] for s in spans}
    assert len(scans) == 2 and len(spans) == 2 * n_bands
    per_scan = sorted(sum(s["device_ms"] for s in spans if s["scan"] == k)
                      for k in scans)
    assert interp_ms.read(records) == pytest.approx(
        sum(per_scan) / 2) and per_scan[0] > 0
    counters = got["counters"]
    assert interp_lane_live_share.read(records) == pytest.approx(
        100.0 * counters["interp_lanes_live"] / counters["interp_lanes"])
    assert 0 < interp_lane_live_share.read(records) <= 100
