"""
The benchmark's variant stages (``nimrud_tpu_torch.bench.kinds``,
``backends`` and ``density``, ports of the reference's
``scripts/bench_kinds.py``, ``bench_backends.py`` and
``bench_density.py``) on the CPU.

* The stages' clouds (``density.make_regime_cloud`` for both regimes,
  ``backends.make_cloud``) are bit-equal to the reference scripts'
  functions, loaded by path (both scripts import jax only in ``main``).
* The density stage's ``cap_buckets_per_band`` and ``plan_occupancy`` on a
  6000-point regime cloud equal what the reference's ``make_bench_model``
  / ``stage`` / ``plan_report`` give on the same cloud: integers equal,
  fills within 1e-6.
* The kinds stage, ``vector`` and ``oriented``, at 3000 points on a fifth
  of the bench site (the plain twin's step takes 2-4 s on one thread
  there, so 1 timed step): one JSON line with its keys, every counter 0,
  ``packed_moments`` wrapped to count its calls by instance family (a CPU
  tensor takes the plain twin, which counts no launch) -- ``vector`` on
  the attribute and chebyshev families only, with the reference script's
  attribute columns in ``fit`` and every ``stage``, ``oriented`` on the
  euclidean family only.
* The backends stage at 2048 points on a tenth of its site, entry
  batches of 16 (the XLA path's entry batches of 128 x 4000 lanes take
  about 2.5 s an extraction there) and one timed run: one JSON line,
  ``xla_highest``'s features equal the reference's
  ``device_grid.fused_extract`` on the same inputs within the XLA path's
  tolerances (``test_torch_kinds_paths._compare``), the XLA variants
  call no moment kernel and ``pallas_spans`` only ``span_moments``;
  ``xla_mixed``'s numbers are copies of ``xla_highest``'s.
* A kind or a regime that is not known raises, and a stage whose model
  raises exits non-zero as a process.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import pipeline
from nimrud_tpu_torch.bench import _stage, backends, density, kinds
from nimrud_tpu_torch.ops import device_grid
from nimrud_tpu_torch.ops.kernels import gather_kernel as gk
from nimrud_tpu_torch.ops.kernels import packed_moments as pm
from nimrud_tpu_torch.utils import workload as twl
from test_torch_kinds_paths import _compare
from torch_thread_cases import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REGIME = 6000
N_KINDS = 3000
N_BACKENDS = 2048


def _script(name):
    """A reference script of ``scripts/``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bit_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("regime", density.REGIMES)
def test_regime_cloud_is_the_reference_scripts(regime):
    ref = _script("bench_density").make_regime_cloud(regime, n=5000)
    got = density.make_regime_cloud(regime, n=5000)
    assert _bit_equal(got[0], ref[0]) and _bit_equal(got[1], ref[1])


def test_backends_cloud_is_the_reference_scripts():
    ref = _script("bench_backends").make_cloud(5000,
                                               np.random.default_rng(0))
    got = backends.make_cloud(5000, np.random.default_rng(0))
    assert _bit_equal(got, ref)


@pytest.mark.parametrize("regime", density.REGIMES)
def test_density_plan_equals_the_reference(regime):
    cloud, labels = density.make_regime_cloud(regime, n=N_REGIME)
    ref = jwl.make_bench_model(cloud, backend="packed")
    ref.fit(cloud, labels, sample=_stage.FIT_SAMPLE)
    port = twl.make_bench_model(cloud, backend="packed", device="cpu")
    port.fit(cloud, labels, sample=_stage.FIT_SAMPLE)
    want = density.cap_buckets([pipeline.BandSpec(*band) for band in
                                ref.stage(cloud)["specs"]])
    got = density.cap_buckets(port.stage(cloud)["specs"])
    print(regime, got)
    assert got == want
    assert any(len(band["caps"]) > 1 for band in got)
    scaleset = [(edge, (radius,)) for edge, radius in
                zip(jwl.BENCH_EDGES, jwl.BENCH_RADII)]
    ref_rows = jms.plan_report(cloud, cloud, scaleset, method="fused",
                               tuning={"backend": "packed"})
    got_rows = density.plan_occupancy(cloud, "cpu")
    assert len(got_rows) == len(ref_rows) == 3
    for row, ref_row in zip(got_rows, ref_rows):
        assert set(row) == set(density.OCCUPANCY_KEYS)
        for key in ("e_cap", "q_cap"):
            assert row[key] == ref_row[key], key
        for key in ("edge", "entry_fill", "q_slot_fill"):
            assert row[key] == pytest.approx(ref_row[key], abs=1e-6), key


@pytest.fixture
def families(monkeypatch):
    """``packed_moments`` wrapped to count its calls as launches by
    instance family (``_stage.launches`` names them)."""
    real = pm.packed_moments

    def counting(*args, n_attr=0, metric="euclidean", **kwargs):
        family = "interp_launches" if metric == "chebyshev" \
            else "attr_launches" if n_attr else "launches"
        setattr(counting, family, getattr(counting, family) + 1)
        return real(*args, n_attr=n_attr, metric=metric, **kwargs)
    for family in ("launches", "attr_launches", "interp_launches"):
        setattr(counting, family, 0)
    monkeypatch.setattr(pm, "packed_moments", counting)
    return counting


@pytest.fixture
def attributes_seen(monkeypatch):
    """The ``attributes`` each ``fit`` and ``stage`` of the model got."""
    seen = []
    for name in ("fit", "stage"):
        real = getattr(pipeline.GeometryClassifier, name)

        def wrapped(self, *args, _real=real, _name=name, **kwargs):
            seen.append((_name, kwargs.get("attributes")))
            return _real(self, *args, **kwargs)
        monkeypatch.setattr(pipeline.GeometryClassifier, name, wrapped)
    return seen


@pytest.fixture
def compact(monkeypatch):
    """``make_bench_cloud`` on a fifth of the site in x and y."""
    make = twl.make_bench_cloud

    def compact_cloud(*args, **kwargs):
        cloud, labels = make(*args, **kwargs)
        cloud[:, :2] *= 0.2
        return cloud, labels
    monkeypatch.setattr(twl, "make_bench_cloud", compact_cloud)


def _one_line(capsys, line):
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    return line


def _reference_attributes(labels):
    """The attribute columns of the reference's ``scripts/bench_kinds.py``
    (``main``, inline there)."""
    rng = np.random.default_rng(3)
    return np.stack(
        [labels + 0.05 * rng.standard_normal(len(labels)),
         rng.random(len(labels))], axis=1).astype(np.float32)


@pytest.mark.parametrize("kind", kinds.KINDS)
def test_kinds_stage_prints_one_line(kind, families, attributes_seen,
                                     compact, capsys, monkeypatch):
    monkeypatch.setattr(_stage, "TIMED_RUNS", 1)
    line = _one_line(capsys, kinds.main([kind, "--device", "cpu",
                                         "--points", str(N_KINDS)]))
    for key in ("mode", "kind", "attr_width", "n_points", "scales",
                "overflow_counters", "counters_all_zero", "train_accuracy",
                "predict_ms", "stage_ms", "step_with_stage_ms", "trace",
                "launches_per_step", "peak_gib", "device", "fit_s",
                "points_per_sec", "launches_total"):
        assert key in line, key
    assert line["mode"] == f"{kind}_serving" and line["kind"] == kind
    assert line["device"] == "cpu" and line["n_points"] == N_KINDS
    assert line["scales"] == 3 and line["trace"] is None
    assert line["counters_all_zero"]
    assert all(v == 0 for v in line["overflow_counters"].values())
    assert line["predict_ms"]["runs"] == 1
    assert line["train_accuracy"] > 0.8
    per_step = line["launches_per_step"]
    _, labels = twl.make_bench_cloud(N_KINDS)
    if kind == "vector":
        assert line["attr_width"] == 2
        assert set(per_step) == {"packed_moments_attr",
                                 "packed_moments_interp"}
        want = _reference_attributes(labels)
        assert [name for name, _ in attributes_seen].count("stage") >= 2
        for name, attrs in attributes_seen:
            assert _bit_equal(attrs, want), name
    else:
        assert line["attr_width"] is None
        assert set(per_step) == {"packed_moments"}
        assert all(attrs is None for _, attrs in attributes_seen)
    assert line["launches_total"] == {
        name: n for name, n in _stage.launches().items() if n}


@pytest.fixture
def spans_counted(monkeypatch):
    """``span_moments`` wrapped to count its calls as launches."""
    real = gk.span_moments

    def counting(*args, **kwargs):
        counting.launches += 1
        return real(*args, **kwargs)
    counting.launches = 0
    counting.excl_launches = 0
    monkeypatch.setattr(gk, "span_moments", counting)
    return counting


def test_backends_stage_matches_the_reference(families, spans_counted,
                                              capsys, monkeypatch):
    make = backends.make_cloud

    def compact_cloud(n, rng):
        cloud = make(n, rng)
        cloud[:, :2] *= 0.1
        return cloud
    monkeypatch.setattr(backends, "make_cloud", compact_cloud)
    monkeypatch.setattr(backends, "RUNS", 1)
    monkeypatch.setattr(device_grid, "make_spec", functools.partial(
        device_grid.make_spec, entry_batch=16))
    outs = {}
    extract = backends.extract

    def keep(variant, *args):
        outs[variant] = extract(variant, *args)
        return outs[variant]
    monkeypatch.setattr(backends, "extract", keep)
    line = _one_line(capsys, backends.main(["--device", "cpu", "--points",
                                            str(N_BACKENDS)]))
    for key in ("device_compute_sec_per_extract", "point_scales_per_sec_M",
                "checks", "launches_per_extract", "n_points", "device"):
        assert key in line, key
    assert set(line["device_compute_sec_per_extract"]) \
        == set(backends.VARIANTS)
    checks = line["checks"]
    assert checks["xla_highest"]["rel_vs_xla_highest"] == 0.0
    times = line["device_compute_sec_per_extract"]
    assert times["xla_mixed"] == times["xla_highest"]
    assert checks["xla_mixed"]["feature_sum"] \
        == checks["xla_highest"]["feature_sum"]
    assert checks["pallas_spans"]["rel_vs_xla_highest"] < 1e-6
    launched = line["launches_per_extract"]
    assert launched["xla_highest"] == launched["xla_mixed"] == {}
    assert launched["pallas_spans"] == {"span_moments": 3}
    assert families.launches == families.attr_launches == 0

    # the reference's XLA extraction on the same cloud and specs
    cloud = compact_cloud(N_BACKENDS, np.random.default_rng(0))
    query = np.asarray(cloud)
    q_valid = np.ones(N_BACKENDS, bool)
    bands = backends.make_bands(cloud, torch.from_numpy(cloud))
    lo = cloud.min(0).astype(np.float64)
    hi = cloud.max(0).astype(np.float64)
    for edge, (centers, mask, spec, radii), got in zip(
            backends.EDGES, bands, outs["xla_highest"]):
        ref_spec = jdg.with_entry_estimate(jdg.make_spec(
            lo, hi, radii[0], n_query=N_BACKENDS, voxel_edge=edge,
            entry_batch=16), cloud)
        assert (ref_spec.e_cap, ref_spec.dims, ref_spec.s_cap) \
            == (spec.e_cap, spec.dims, spec.s_cap)
        ref = np.array(jdg.fused_extract(
            query, q_valid, centers.numpy(), mask.numpy(), ref_spec, radii,
            "minimal", None, "highest", N_BACKENDS))
        _compare("minimal", got.numpy(), ref)


def test_unknown_kind_or_regime_raises():
    with pytest.raises(ValueError, match="unknown regime"):
        density.make_regime_cloud("desert", n=100)
    for stage in (kinds, density):
        with pytest.raises(SystemExit) as exc:
            stage.main(["desert", "--device", "cpu"])
        assert exc.value.code == 2


def test_stage_whose_model_raises_exits_nonzero():
    code = ("import runpy, sys\n"
            "from nimrud_tpu_torch import pipeline\n"
            "def fail(*a, **k):\n"
            "    raise RuntimeError('model failed')\n"
            "pipeline.GeometryClassifier.fit = fail\n"
            "sys.argv = ['density', 'veg', '--device', 'cpu', "
            "'--points', '2000']\n"
            "runpy.run_module('nimrud_tpu_torch.bench.density', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "model failed" in proc.stderr and not proc.stdout.strip()
