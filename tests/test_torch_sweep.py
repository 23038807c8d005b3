"""
The port's sweep harness, plan report and profiling helpers
(``nimrud_tpu_torch.workflows.sweep``, ``features.multiscale.plan_report``,
``utils.profiling``) against the JAX package's, on the CPU.

* ``synthetic_scan`` bit-equal; ``plan_report`` field for field equal on
  the tiled plan and on the fused plan of each backend (given to both
  sides in ``tuning``: off a TPU the reference resolves XLA bands, the
  port the packed kernel).
* ``sweep_extraction``: the same configurations in the same order, the
  same keys and ``entry_fill``, error rows for the same configurations;
  only a refusal (``ValueError``) becomes an error row, anything else
  propagates.
* The profiler's parser on a hand-written chrome trace (overlapping
  kernels, a copy, a host op left out), and a CPU trace holding no
  device events raising.
"""

import gzip
import json
import os
import time

import numpy as np
import pytest

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.utils import profiling as jprof
from nimrud_tpu.workflows import sweep as jsw

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.utils import profiling as tprof
from nimrud_tpu_torch.workflows import sweep as tsw
from torch_thread_cases import one_torch_thread  # noqa: F401

CONFIG_KEYS = ("method", "query_tile_factor", "query_capacity",
               "entry_batch", "precision")


def test_synthetic_scan_is_bit_equal():
    for n, extent, seed in ((10_000, 50.0, 0), (4_321, 100.0, 3)):
        got = tsw.synthetic_scan(n, extent=extent, seed=seed)
        want = jsw.synthetic_scan(n, extent=extent, seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method,tuning", [
    ("tiled", {}), ("tiled", {"query_tile_factor": 2, "entry_batch": 64}),
    ("fused", {"backend": "packed"}), ("fused", {"backend": "xla"}),
    ("fused", {"backend": "packed", "query_capacity": 128,
               "estimate_entries": False})])
def test_plan_report_equals_reference(method, tuning):
    cloud = tsw.synthetic_scan(8_000, extent=30.0)
    scaleset = [(0.5, (1.0,)), (1.0, (2.0,))]
    got = tms.plan_report(cloud, cloud, scaleset, method=method,
                          tuning=dict(tuning), device="cpu")
    want = jms.plan_report(cloud, cloud, scaleset, method=method,
                           tuning=dict(tuning))
    assert got == want
    for band in got:
        assert 0 < band["entries_live"] <= band["e_cap"]
        assert 0 < band["entry_fill"] <= 1 and 0 < band["q_slot_fill"] <= 1
    if tuning.get("backend") == "xla":
        assert any(b["e_cap"] < b["e_cap_worst_case"] for b in got)


def test_fused_plan_defaults_to_the_packed_backend():
    cloud = tsw.synthetic_scan(6_000, extent=30.0)
    scaleset = [(0.5, (1.0,))]
    assert tms.plan_report(cloud, cloud, scaleset, method="fused") \
        == tms.plan_report(cloud, cloud, scaleset, method="fused",
                           tuning={"backend": "packed"})
    with pytest.raises(ValueError, match="voxel edges"):
        tms.plan_report(cloud, cloud, [(0.0, (1.0,))], method="fused")


def _printed_rows(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _packed_plan_reference(monkeypatch):
    """The reference's plan report of the packed backend (which the port
    runs off a TPU too) for its sweep's fused rows."""
    plan = jms.plan_report

    def packed(*args, tuning=None, **kwargs):
        return plan(*args, tuning={**(tuning or {}), "backend": "packed"},
                    **kwargs)

    monkeypatch.setattr(jms, "plan_report", packed)


def test_sweep_rows_match_reference(monkeypatch, capsys):
    cloud = tsw.synthetic_scan(20_000)
    kwargs = dict(cloud=cloud, scaleset=[(1.0, (2.0,))],
                  repeats=1, tile_factors=(2, 3), capacities=(None,),
                  entry_batches=(256,), methods=("tiled", "fused"))
    ranked = tsw.sweep_extraction(device="cpu", **kwargs)
    got = _printed_rows(capsys)
    _packed_plan_reference(monkeypatch)
    jsw.sweep_extraction(**kwargs)
    want = _printed_rows(capsys)
    assert [[r[k] for k in CONFIG_KEYS] for r in got] \
        == [[r[k] for k in CONFIG_KEYS] for r in want]
    assert len(got) == 4
    for a, b in zip(got, want):
        assert list(a) == list(b) and "error" not in a
        assert a["entry_fill"] == b["entry_fill"]
        assert a["seconds"] > 0 and a["point_scales_per_sec"] > 0
    rates = [r["point_scales_per_sec"] for r in ranked]
    assert rates == sorted(rates, reverse=True)
    # each row's fill is the port's plan for its tuning
    for row in got:
        tuning = {k: row[k] for k in CONFIG_KEYS[1:]}
        plan = tms.plan_report(cloud, cloud, kwargs["scaleset"],
                               method=row["method"], tuning=tuning,
                               device="cpu")
        assert row["entry_fill"] == [band["entry_fill"] for band in plan]


def test_refused_configuration_is_an_error_row(capsys):
    cloud = tsw.synthetic_scan(3_000, extent=20.0)
    kwargs = dict(cloud=cloud, scaleset=[(0.0, (1.0,)), (0.5, (1.0,))],
                  repeats=1, tile_factors=(3,), capacities=(None,),
                  entry_batches=(128,), methods=("fused",))
    got = tsw.sweep_extraction(device="cpu", **kwargs)
    want = jsw.sweep_extraction(**kwargs)
    assert got == want
    assert len(got) == 1 and got[0]["error"] == \
        "fused path requires voxel edges > 0"
    assert _printed_rows(capsys)[0] == got[0]


def test_other_failures_propagate_out_of_the_sweep(monkeypatch):
    # a kernel that does not build or launch raises RuntimeError: no
    # error row may hide it
    def fail(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tms, "extract_scaleset_device", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tsw.sweep_extraction(cloud=tsw.synthetic_scan(2_000, extent=20.0),
                             scaleset=[(0.5, (1.0,))], repeats=1,
                             tile_factors=(3,), capacities=(None,),
                             entry_batches=(128,), verbose=False,
                             device="cpu")


def test_sweep_trace_on_the_cpu_holds_no_device_events(tmp_path):
    trace_dir = str(tmp_path / "trace")
    ranked = tsw.sweep_extraction(
        cloud=tsw.synthetic_scan(3_000, extent=20.0), repeats=1,
        tile_factors=(3,), capacities=(64,), entry_batches=(128,),
        verbose=False, trace_dir=trace_dir, device="cpu")
    assert ranked and "error" not in ranked[0]
    found = [f for _, _, files in os.walk(trace_dir) for f in files]
    assert len(found) == 1 and found[0].endswith(".trace.json.gz")
    assert len(tprof.trace_events(trace_dir)) > 0
    with pytest.raises(ValueError, match="no device events"):
        tprof.device_track_stats(trace_dir)


def _write_trace(path, events, gz):
    text = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(path, "wt") as handle:
            handle.write(text)
    else:
        with open(path, "w") as handle:
            handle.write(text)


@pytest.mark.parametrize("gz", [False, True])
def test_device_trace_parser(tmp_path, gz):
    events = [
        {"ph": "X", "cat": "kernel", "name": "packed_moments",
         "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "sort", "ts": 120.0,
         "dur": 60.0},                                   # overlaps
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 300.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "packed_moments",
         "ts": 400.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 1000.0},                                 # host, left out
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}}]
    suffix = ".trace.json.gz" if gz else ".trace.json"
    _write_trace(str(tmp_path / f"a_old{suffix}"), events[4:], gz)
    _write_trace(str(tmp_path / f"b_new{suffix}"), events, gz)
    busy, window = tprof.device_track_stats(str(tmp_path))
    assert (busy, window) == (80.0 + 20.0 + 10.0, 310.0)
    assert tprof.device_op_table(str(tmp_path)) == [
        (0.06, 2, "packed_moments"), (0.06, 1, "sort"),
        (0.02, 1, "Memcpy HtoD")]
    assert tprof.device_op_table(str(tmp_path / f"b_new{suffix}"),
                                 top=1) == [(0.06, 2, "packed_moments")]
    with pytest.raises(ValueError, match="no device events"):
        tprof.device_track_stats(str(tmp_path / f"a_old{suffix}"))
    with pytest.raises(FileNotFoundError):
        tprof.device_track_stats(str(tmp_path / "empty_dir_missing"))


def test_rate_timer_report_equals_reference(monkeypatch):
    lines = []
    for module in (jprof, tprof):
        ticks = iter([10.0, 12.5, 20.0, 20.5])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = module.RateTimer("extract")
        with timer:
            timer.add_points(1000)
        with timer:
            timer.add_points(500)
        timer.report(lines.append)
    assert lines[0] == lines[1]
    assert json.loads(lines[1]) == {"label": "extract", "points": 1500,
                                    "seconds": 3.0, "points_per_sec": 500.0}
