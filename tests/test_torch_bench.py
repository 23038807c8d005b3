"""
The benchmark of the port (``nimrud_tpu_torch.bench``) and its byte model
(``utils/workload.py``) on the CPU.

* ``_packed_lane_total`` equals the reference's over a hypothesis grid of
  capacities (an int, or rank-bucket caps with their bounds), entry
  capacities and entry chunks; ``roofline_payload`` of the port's bench
  model equals the reference's on the same 6000-point cloud, both fit on
  the CPU (every movement, the candidate and query lanes).
* ``roofline_rates`` reckons the share of peak on the H100 SXM 80GB HBM3
  only: no ``pct_of_peak`` for another card, a TPU's name included.
* ``trace_summary`` on a synthetic chrome trace: window, busy time (the
  union of overlapping kernels), idle share, top kernels.
* The headline stage at 6000 points on the CPU, the bench scene's site
  cut to a fifth in x and y (the plain twin's step on the full 100 m
  site takes about 5 s on one thread, ten times over), ``packed_moments``
  wrapped to count its calls (a CPU tensor takes the plain twin, which
  counts no launch): one JSON line with its keys, zero overflow
  counters, launches a step.
* The orchestrator: a stage that raises makes it print its line and
  exit 1; a stage skipped by its switch leaves it at 0; a stage killed at
  its time limit is harvested from what it printed; a deadline too short
  skips stages; ``--points`` reaches the 1M stages (not the 10M one)
  through ``cli.main(["bench", ...])``.
"""

import json
import subprocess

import pytest
from hypothesis import given, settings, strategies as st

from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import bench, cli
from nimrud_tpu_torch.bench import _stage, headline
from nimrud_tpu_torch.ops.kernels import packed_moments as pm
from nimrud_tpu_torch.utils import workload as twl
from torch_thread_cases import one_torch_thread  # noqa: F401

N = 6000
SKIPS = ("NIMRUD_BENCH_SKIP_DESIGNATED", "NIMRUD_BENCH_SKIP_LARGE",
         "NIMRUD_BENCH_SKIP_RPTE")


@st.composite
def _caps(draw):
    """An int capacity, or (caps, bounds) with increasing bounds."""
    if draw(st.booleans()):
        return draw(st.integers(1, 4096))
    caps = draw(st.lists(st.integers(1, 4096), min_size=1, max_size=5))
    bounds = sorted(draw(st.lists(st.integers(1, 6000), min_size=len(caps)
                                  - 1, max_size=len(caps) - 1, unique=True)))
    return tuple(caps), tuple(bounds)


@settings(max_examples=300, deadline=None)
@given(c_cap=_caps(), e_cap=st.integers(1, 20_000),
       entry_chunk=st.one_of(st.none(), st.integers(1, 8192)))
def test_packed_lane_total_matches_reference(c_cap, e_cap, entry_chunk):
    assert twl._packed_lane_total(c_cap, e_cap, entry_chunk) \
        == jwl._packed_lane_total(c_cap, e_cap, entry_chunk)


def test_roofline_payload_matches_reference():
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    ref = jwl.make_bench_model(cloud)
    ref.fit(cloud, labels, sample=N // 2)
    port = twl.make_bench_model(cloud, device="cpu")
    port.fit(cloud, labels, sample=N // 2)
    want = jwl.roofline_payload(ref, ref.stage(cloud))
    got = twl.roofline_payload(port, port.stage(cloud))
    print(got)
    assert got["candidate_lanes"] > 0 and got["qt_lanes"] > 0
    for key in ("movements_bytes", "candidate_lanes", "qt_lanes",
                "bytes_total", "bytes_per_point"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", None),
    ("NVIDIA A100-SXM4-80GB", None), ("TPU v5 lite", None), ("cpu", None)])
def test_roofline_rates_takes_the_h100_peak_only(name, peak):
    payload = {"bytes_total": 6_700_000_000}
    got = twl.roofline_rates(payload, 4.0, name)
    assert got["achieved_payload_gbps"] == pytest.approx(1675.0)
    assert got["window_ms"] == 4.0 and got["device"] == name
    assert got.get("peak_hbm_gbps") == peak
    if peak is None:
        assert "pct_of_peak" not in got
    else:
        assert got["pct_of_peak"] == pytest.approx(50.0)


def test_trace_summary_reads_the_device_events():
    def kernel(name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [kernel("a", 0.0, 100.0), kernel("b", 50.0, 100.0),
              kernel("a", 400.0, 100.0), kernel("copy", 900.0, 100.0,
                                                "gpu_memcpy"),
              {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0.0,
               "dur": 5000.0}]
    got = _stage.trace_summary(events, 2)
    assert got["window_ms_per_step"] == pytest.approx(0.5)
    assert got["busy_ms_per_step"] == pytest.approx(0.175)
    assert got["idle_share"] == pytest.approx(0.65)
    assert got["device_events"] == 4 and got["traced_steps"] == 2
    assert got["top_ops"][0] == {"name": "a", "total_ms": 0.2, "count": 2}
    with pytest.raises(ValueError, match="no device events"):
        _stage.trace_summary(events[-1:], 1)


@pytest.fixture
def counted(monkeypatch):
    """``packed_moments`` wrapped to count its calls as launches."""
    real = pm.packed_moments

    def counting(*args, **kwargs):
        counting.launches += 1
        return real(*args, **kwargs)
    counting.launches = 0
    monkeypatch.setattr(pm, "packed_moments", counting)
    return counting


@pytest.fixture
def compact(monkeypatch):
    """``make_bench_cloud`` on a fifth of the site in x and y."""
    make = twl.make_bench_cloud

    def compact_cloud(*args, **kwargs):
        cloud, labels = make(*args, **kwargs)
        cloud[:, :2] *= 0.2
        return cloud, labels
    monkeypatch.setattr(twl, "make_bench_cloud", compact_cloud)


def test_headline_stage_prints_one_line(counted, compact, capsys):
    line = headline.main(["--device", "cpu", "--points", str(N)])
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    for key in ("metric", "value", "unit", "vs_baseline", "fit_s",
                "predict_ms", "stage_ms", "step_with_stage_ms",
                "stream_ms_per_cloud", "trace", "launches_per_step",
                "peak_gib", "overflow_counters", "train_accuracy",
                "roofline", "launches_total", "device"):
        assert key in line, key
    assert line["device"] == "cpu" and line["n_points"] == N
    assert line["trace"] is None and line["peak_gib"] is None
    assert line["counters_all_zero"]
    assert all(v == 0 for v in line["overflow_counters"].values())
    assert set(line["launches_per_step"]) == {"packed_moments"}
    assert line["launches_per_step"]["packed_moments"] >= 3
    assert line["launches_total"] == {"packed_moments": counted.launches}
    assert line["predict_ms"]["runs"] == _stage.TIMED_RUNS >= 5
    median = line["predict_ms"]["median_ms"]
    assert line["value"] == pytest.approx(N / (median / 1e3))
    assert line["train_accuracy"] > 0.8
    assert "pct_of_peak" not in line["roofline"]


def _fake_stage(key):
    return {"stage": key, "value": 1000.0, "metric": "fake",
            "counters_all_zero": True}


@pytest.fixture
def fake_run(monkeypatch):
    """``subprocess.run`` of the orchestrator answering each stage with
    a JSON line; the commands are kept."""
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        module = cmd[2].rsplit(".", 1)[1]
        return subprocess.CompletedProcess(
            cmd, 0, json.dumps(_fake_stage(module)) + "\n", "note\n")
    monkeypatch.setattr(bench.subprocess, "run", run)
    return calls


def _printed(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_orchestrator_exits_nonzero_when_a_stage_raises(monkeypatch,
                                                        capsys):
    for env in SKIPS:
        monkeypatch.setenv(env, "1")
    # a device name torch does not know: the stage raises as it starts
    assert bench.main(["--device", "no_such_device"]) == 1
    line = _printed(capsys)
    head = line["detail"]["headline"]
    assert "rc=1" in head["error"] and "no_such_device" in head["error"]
    assert line["value"] is None and line["vs_baseline"] is None
    for key in ("designated_search_stream", "large_scale_10m",
                "rpte_serving"):
        assert line["detail"][key] == {"skipped": "env"}


def test_orchestrator_exits_zero_with_a_stage_skipped(fake_run, monkeypatch,
                                                      capsys):
    monkeypatch.setenv("NIMRUD_BENCH_SKIP_DESIGNATED", "1")
    assert bench.main(["--device", "cpu"]) == 0
    line = _printed(capsys)
    assert line["value"] == 1000.0 and line["metric"] == "fake"
    assert line["vs_baseline"] == pytest.approx(1000.0 / (5000.0 / 3))
    assert line["detail"]["designated_search_stream"] == {"skipped": "env"}
    assert [c[2] for c in fake_run] == [
        "nimrud_tpu_torch.bench.headline", "nimrud_tpu_torch.bench.large",
        "nimrud_tpu_torch.bench.rpte"]
    assert set(line["detail"]["budget"]["stage_walls_sec"]) == {
        "headline", "large_scale_10m", "rpte_serving"}


def test_orchestrator_harvests_a_stage_killed_at_its_limit(monkeypatch,
                                                           capsys):
    for env in SKIPS:
        monkeypatch.setenv(env, "1")

    def hung(cmd, **kwargs):
        raise subprocess.TimeoutExpired(
            cmd, kwargs["timeout"], output=json.dumps(_fake_stage("h"))
            + "\n{\"trunc", stderr=b"hung in teardown")
    monkeypatch.setattr(bench.subprocess, "run", hung)
    assert bench.main([]) == 0
    head = _printed(capsys)["detail"]["headline"]
    assert head["value"] == 1000.0
    assert head["orchestrator_note"].startswith("killed at stage timeout")

    def silent(cmd, **kwargs):
        raise subprocess.TimeoutExpired(cmd, kwargs["timeout"], output=b"")
    monkeypatch.setattr(bench.subprocess, "run", silent)
    assert bench.main([]) == 1
    assert "killed at stage timeout" in \
        _printed(capsys)["detail"]["headline"]["error"]


def test_orchestrator_skips_stages_past_its_deadline(fake_run, monkeypatch,
                                                     capsys):
    monkeypatch.setenv("NIMRUD_BENCH_DEADLINE_SEC", "70")
    assert bench.main([]) == 0
    line = _printed(capsys)
    assert not fake_run and line["value"] is None
    for key, rec in line["detail"].items():
        if key != "budget":
            assert rec["skipped"] == "deadline", key


def test_cli_bench_passes_points_to_the_1m_stages(fake_run, capsys):
    cli.main(["--device", "cpu", "bench", "--points", "5000"])
    assert _printed(capsys)["value"] == 1000.0
    by_stage = {c[2].rsplit(".", 1)[1]: c[3:] for c in fake_run}
    for module in ("headline", "designated", "rpte"):
        assert by_stage[module] == ["--device", "cpu", "--points", "5000"]
    assert by_stage["large"] == ["--device", "cpu"]
    fake_run.clear()
    cli.main(["--device", "cuda:1", "bench"])
    _printed(capsys)
    assert all(c[3:] == ["--device", "cuda:1"] for c in fake_run)


def test_cli_bench_exits_with_the_orchestrator(monkeypatch):
    monkeypatch.setattr(bench, "main", lambda argv: 1)
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench"])
    assert exc.value.code == 1
