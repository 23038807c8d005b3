"""The readers of the program's own spans and counters: each gives the
expected value from hand-made records, and from the segment the harness
profiles (``core.bench._profile``) around a tiny cell's scans on the
CPU, leaving out the scans of another profiler session of the same
process; each gives None from records whose trace has only the
harness's ranges, from a program that records no spans, as the parent
commit's, without a traced segment, or where the program's records do
not pair with the segment's ranges."""

import statistics

import pytest

from perfbench.core import bench
from perfbench.metrics import (classify_ms, lane_live_share, slot_live_share,
                               upload_ms)
from perfbench_tiny import tiny_cell

from nimrud_tpu_torch.utils import profiling

READERS = (upload_ms, classify_ms, slot_live_share, lane_live_share)
PAIRED = (classify_ms, slot_live_share, lane_live_share)


def _host(name, lo_us, hi_us):
    return (name, lo_us, hi_us, "user_annotation")


def _span(name, scan, ms, start_ns=0):
    return {"name": name, "parent": None if name == "nimrud.predict"
            else "nimrud.predict", "scan": scan, "start_ns": start_ns,
            "end_ns": start_ns + int(ms * 1e6), "host_ms": ms,
            "device_ms": ms}


HAND = {
    "trace": {"clouds": 3, "device": [], "window_us": (0.0, 1e6),
              "host": [_host("perfbench.predict", 0.0, 9e3),
                       _host("nimrud.predict", 10.0, 4010.0),
                       _host("nimrud.predict", 5e3, 7e3),
                       _host("nimrud.predict", 8e3, 1.1e4),
                       _host("nimrud.stage.upload", 0.0, 500.0),
                       _host("nimrud.stage.upload", 1e3, 1.25e3),
                       ("nimrud.stage.upload", 0.0, 9e4, "cpu_op")]}}
# scan 9: an earlier profiler session of the same process, not the
# segment's: the readers leave it out
COLLECTED = {
    "spans": [_span("nimrud.predict", 9, 30.0, 1),
              _span("nimrud.predict.classify", 9, 20.0),
              _span("nimrud.predict", 1, 3.99, 10),
              _span("nimrud.predict.classify", 1, 2.0),
              _span("nimrud.predict.classify", 1, 3.0),
              _span("nimrud.predict.moments", 1, 50.0),
              _span("nimrud.predict", 2, 1.98, 20),
              _span("nimrud.predict.classify", 2, 4.0),
              _span("nimrud.predict", 3, 2.97, 30),
              _span("nimrud.predict.classify", 3, 7.0)],
    "counters": {"slots": 800, "slots_live": 300, "lanes": 2000,
                 "lanes_live": 1125},
    "scans": {9: {"slots": 400, "slots_live": 0, "lanes": 1000,
                  "lanes_live": 1000},
              1: {"slots": 200, "slots_live": 150, "lanes": 500,
                  "lanes_live": 50},
              2: {"slots": 100, "slots_live": 75, "lanes": 250,
                  "lanes_live": 50},
              3: {"slots": 100, "slots_live": 75, "lanes": 250,
                  "lanes_live": 25}},
    "dropped": 0}


def test_readers_on_hand_made_records(monkeypatch):
    monkeypatch.setattr(profiling, "collected", lambda: COLLECTED)
    assert upload_ms.read(HAND) == 0.375
    assert classify_ms.read(HAND) == 5.0          # scans 5, 4, 7 ms
    assert slot_live_share.read(HAND) == 75.0
    assert lane_live_share.read(HAND) == 12.5


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__)
def test_readers_none_without_the_programs_spans(reader, monkeypatch):
    parent = {"trace": dict(HAND["trace"], host=[
        h for h in HAND["trace"]["host"] if h[0].startswith("perfbench.")])}
    monkeypatch.delattr(profiling, "collected")
    assert reader.read(parent) is None
    assert reader.read({"clouds": []}) is None
    monkeypatch.setattr(profiling, "collected", lambda: {
        "spans": [], "counters": {}, "scans": {}, "dropped": 0},
        raising=False)
    assert reader.read(parent) is None


@pytest.mark.parametrize("reader", PAIRED, ids=lambda r: r.__name__)
def test_readers_none_where_the_records_do_not_pair(reader, monkeypatch):
    """Fewer spans than the segment's ranges, or a span whose host time
    is not its range's: the program's records are not the segment's."""
    fewer = dict(COLLECTED, spans=COLLECTED["spans"][2:])
    fewer["spans"] = [s for s in fewer["spans"] if s["scan"] != 3]
    monkeypatch.setattr(profiling, "collected", lambda: fewer)
    assert reader.read(HAND) is None
    longer = dict(COLLECTED, spans=[
        dict(s, host_ms=9.0) if s["scan"] == 2 else s
        for s in COLLECTED["spans"]])
    monkeypatch.setattr(profiling, "collected", lambda: longer)
    assert reader.read(HAND) is None


@pytest.fixture(scope="module")
def profiled():
    """A tiny ``site_linear.rescan_1m``: one scan under a profiler
    session of its own (which the readers must leave out), then two
    under the harness's profiler: the records, the program's spans and
    counters, the segment's scans and the served specs."""
    cell = tiny_cell("site_linear.rescan_1m", points=6000)
    setup = bench.Setup(cell, 2 ** 31 + 11, "cpu")
    model, handle = setup.program()
    server = bench.Server(model, handle, "cpu")
    pool = setup.traffic.pool
    server.step(pool[0])
    profiling.reset()
    bench._profile(server, pool[1:2])
    before = {s["scan"] for s in profiling.collected()["spans"]}
    records = {"trace": bench._profile(server, pool[:2])}
    got = profiling.collected()
    segment = {s["scan"] for s in got["spans"]} - before
    staged = model.stage(pool[0])
    return records, got, segment, staged


def test_readers_on_a_profiled_tiny_step(profiled):
    records, got, segment, staged = profiled
    host = records["trace"]["host"]

    def durations(name):
        return [(hi - lo) / 1e3 for n, lo, hi, c in host
                if n == name and c == "user_annotation"]

    assert len(durations("nimrud.predict")) == 2
    assert upload_ms.read(records) == statistics.median(
        durations("nimrud.stage.upload"))
    assert len(segment) == 2 and len(got["scans"]) == 3
    per_scan = [sum(s["device_ms"] for s in got["spans"]
                    if s["scan"] == scan
                    and s["name"] == "nimrud.predict.classify")
                for scan in segment]
    assert classify_ms.read(records) == statistics.median(per_scan) > 0
    pack = min((s[1] for s in staged["specs"]), key=lambda d: d.tile_edge)
    assert slot_live_share.read(records) == pytest.approx(
        100.0 * staged["n_query"] / (pack.e_cap * pack.q_cap))
    lanes = [sum(got["scans"][scan][k] for scan in segment)
             for k in ("lanes_live", "lanes")]
    assert lane_live_share.read(records) == pytest.approx(
        100.0 * lanes[0] / lanes[1])
    assert 0 < lane_live_share.read(records) <= 100
