"""
The port's host-side copies (NumPy sizing) against the JAX package's
originals: equal outputs, bit for bit.  Also: importing the port loads
no jax, and the kernels' nvcc build helper (driven by a stand-in nvcc)
caches by content and reports failures.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops import packing as jpk
from nimrud_tpu.ops import span_host as jsh
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.ops import device_grid as tdg
from nimrud_tpu_torch.ops import packing as tpk
from nimrud_tpu_torch.ops import span_host as tsh
from nimrud_tpu_torch.ops.kernels import cuda_build
from nimrud_tpu_torch.utils import workload as twl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(n=6000, seed=3):
    return twl.make_bench_cloud(n, seed=seed)[0]


def test_bench_cloud_is_the_reference_scene():
    a, la = twl.make_bench_cloud(4096, seed=2)
    b, lb = jwl.make_bench_cloud(4096, seed=2)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("edge", [0.25, 0.5, 1.0, 0.3])
def test_grid_spec_fit_bounds_equal(edge):
    cloud = _cloud()
    lo, hi = cloud.min(0), cloud.max(0)
    a = tpk.GridSpec.fit_bounds(lo, hi, edge)
    b = jpk.GridSpec.fit_bounds(lo, hi, edge)
    assert (a.origin, a.edge_length, a.widths, a.shifts) \
        == (b.origin, b.edge_length, b.widths, b.shifts)


@pytest.mark.parametrize("tile,edge,q_cap,x_seg", [
    (0.5, 0.25, 512, 32), (1.0, 0.5, 512, 32), (2.0, 1.0, 256, 32),
    (0.8, 0.2, 128, 1)])
def test_make_spec_and_entry_estimate_equal(tile, edge, q_cap, x_seg):
    cloud = _cloud()
    lo, hi = cloud.min(0), cloud.max(0)
    kw = dict(n_query=8192, voxel_edge=edge, q_cap=q_cap, x_seg=x_seg)
    a = tdg.make_spec(lo, hi, tile, **kw)
    b = jdg.make_spec(lo, hi, tile, **kw)
    assert a.__dict__ == b.__dict__
    assert tdg.estimate_entries(cloud, a) == jdg.estimate_entries(cloud, b)
    assert tdg.with_entry_estimate(a, cloud).__dict__ \
        == jdg.with_entry_estimate(b, cloud).__dict__


@pytest.mark.parametrize("edge,fixed", [(0.25, True), (0.5, False),
                                        (1.0, True)])
def test_host_unique_voxels_equal(edge, fixed):
    cloud = _cloud()
    bounds = (cloud.min(0) - 0.5, cloud.max(0) + 0.5) if fixed else None
    np.testing.assert_array_equal(
        tms._host_unique_voxels(cloud, edge, bounds=bounds),
        jms._host_unique_voxels(cloud, edge, bounds=bounds))


def test_pack_plan_and_split_caps_equal():
    # the serving sizing: one shared pack plan on the finest band, and
    # per-band split candidate capacities measured against it
    cloud = _cloud(12000)
    lo, hi = cloud.min(0), cloud.max(0)
    specs = [(tdg.make_spec(lo, hi, r, n_query=16384, voxel_edge=e,
                            q_cap=512, x_seg=32),
              jdg.make_spec(lo, hi, r, n_query=16384, voxel_edge=e,
                            q_cap=512, x_seg=32))
             for e, r in zip(twl.BENCH_EDGES, twl.BENCH_RADII)]
    valid = np.ones(len(cloud), bool)
    tplan = tsh.pack_plan_np(cloud, valid, specs[0][0])
    jplan = jsh.pack_plan_np(cloud, valid, specs[0][1])
    assert tplan.keys() == jplan.keys()
    for key in tplan:
        np.testing.assert_array_equal(tplan[key], jplan[key], err_msg=key)
    for edge, (ts, js) in zip(twl.BENCH_EDGES, specs):
        centers = tms._host_unique_voxels(cloud, edge)
        a = tsh.candidate_caps_split(None, centers, ts, plan=tplan)
        b = jsh.candidate_caps_split(None, centers, js, plan=jplan)
        assert a == b
        # the copy's per-entry-chunk sizing (chunked serving) too
        assert tsh.candidate_caps_split(None, centers, ts, plan=tplan,
                                        entry_chunk=8) \
            == jsh.candidate_caps_split(None, centers, js, plan=jplan,
                                        entry_chunk=8)
        assert tsh.candidate_cap(cloud, centers, ts) \
            == jsh.candidate_cap(cloud, centers, js)


def test_import_loads_no_jax():
    code = ("import sys, nimrud_tpu_torch, nimrud_tpu_torch.pipeline, "
            "nimrud_tpu_torch.utils.workload, nimrud_tpu_torch.ops.grid, "
            "nimrud_tpu_torch.ops.kernels.gather_kernel, "
            "nimrud_tpu_torch.ops.kernels.cuda_build, "
            "nimrud_tpu_torch.learning.persistence, "
            "nimrud_tpu_torch.features.minimal, "
            "nimrud_tpu_torch.features.knn, nimrud_tpu_torch.ops.neighbors, "
            "nimrud_tpu_torch.learning.classifiers, "
            "nimrud_tpu_torch.learning.metrics, nimrud_tpu_torch.archive, "
            "nimrud_tpu_torch.utils.memory, nimrud_tpu_torch.utils.generic, "
            "nimrud_tpu_torch.utils.geometry, "
            "nimrud_tpu_torch.utils.point_clouds, "
            "nimrud_tpu_torch.utils.profiling, nimrud_tpu_torch.cli, "
            "nimrud_tpu_torch.workflows.datasets, "
            "nimrud_tpu_torch.workflows.features, "
            "nimrud_tpu_torch.workflows.train, "
            "nimrud_tpu_torch.workflows.sweep, "
            "nimrud_tpu_torch.workflows.viz, "
            "nimrud_tpu_torch.parallel.mesh, "
            "nimrud_tpu_torch.parallel.tiles, nimrud_tpu_torch.bench, "
            "nimrud_tpu_torch.bench._stage, nimrud_tpu_torch.bench.headline, "
            "nimrud_tpu_torch.bench.designated, "
            "nimrud_tpu_torch.bench.large, nimrud_tpu_torch.bench.rpte, "
            "nimrud_tpu_torch.bench.kinds, nimrud_tpu_torch.bench.backends, "
            "nimrud_tpu_torch.bench.density; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'nimrud_tpu.')) or m == 'nimrud_tpu');"
            " assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_NVCC_OK = """
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo call >> "$(dirname "$0")/calls"
echo library > "$out"
echo "ptxas info    : Used 40 registers, used 1 barriers, 9216 bytes smem" >&2
"""


def _stand_in_nvcc(tmp_path, monkeypatch, body):
    """An nvcc on PATH that runs ``body``; builds go under tmp_path."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    return bin_dir / "calls"


def test_kernel_build_runs_nvcc_once_per_source(tmp_path, monkeypatch):
    calls = _stand_in_nvcc(tmp_path, monkeypatch, _NVCC_OK)
    built = cuda_build.build_all()
    assert sorted(built) == sorted(cuda_build.KERNELS)
    for name, (lib, report) in built.items():
        assert os.path.dirname(lib) == str(tmp_path / "build")
        assert os.path.basename(lib).startswith(name + "-")
        assert os.path.exists(lib)
        assert cuda_build.ptxas_usage(report) == [
            "Used 40 registers, used 1 barriers, 9216 bytes smem"]
    assert len(calls.read_text().split()) == len(cuda_build.KERNELS)
    # an unchanged source is not rebuilt, and its report is kept
    assert cuda_build.build("span_moments") == built["span_moments"]
    assert cuda_build.build_all() == built
    assert len(calls.read_text().split()) == len(cuda_build.KERNELS)


def test_kernel_build_failure_raises_with_nvcc_stderr(tmp_path,
                                                       monkeypatch):
    _stand_in_nvcc(tmp_path, monkeypatch,
                   'echo "error: no such intrinsic" >&2\nexit 2\n')
    with pytest.raises(RuntimeError) as err:
        cuda_build.build_all()
    for name in cuda_build.KERNELS:            # every build was waited for
        assert f"{name}.cu" in str(err.value)
    assert "no such intrinsic" in str(err.value)
    left = os.listdir(tmp_path / "build")
    assert not [f for f in left if f.endswith((".so", ".txt"))]


@pytest.mark.parametrize("kernel", cuda_build.KERNELS)
def test_kernel_build_key_follows_included_headers(tmp_path, monkeypatch,
                                                   kernel):
    # no nvcc runs: the key alone decides whether a library is reused
    port_csrc = cuda_build.CSRC
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint a;\n')
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint b;\n')
    (csrc / "unused.cuh").write_text("int u;\n")
    key = cuda_build.source_key(str(csrc / "k.cu"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    assert os.path.basename(cuda_build._paths("k")[1]) == f"k-{key}.so"
    (csrc / "unused.cuh").write_text("int u2;\n")
    assert cuda_build.source_key(str(csrc / "k.cu")) == key
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint c;\n')
    changed = cuda_build.source_key(str(csrc / "k.cu"))
    assert changed != key
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\nint a2;\n')
    assert cuda_build.source_key(str(csrc / "k.cu")) not in (key, changed)
    # the port's three kernels share one header: an edit there rebuilds
    # each of them
    port = tmp_path / "port"
    shutil.copytree(port_csrc, port)
    source = port / f"{kernel}.cu"
    assert '#include "moment_mma.cuh"' in source.read_text()
    key = cuda_build.source_key(str(source))
    header = port / "moment_mma.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    assert cuda_build.source_key(str(source)) != key


def test_sass_and_ptxas_report_parsers():
    # what chip_smoke.py checks of each build: HMMA per template instance
    # and no spills
    sass = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN12_GLOBAL__N_121packed_moments_kernelILi2EEEvPKf",
        "        /*0100*/   HMMA.16816.F32.BF16 R4, R12, R20, R4 ;",
        "        /*0110*/   HMMA.16816.F32.BF16 R8, R12, R22, R8 ;",
        "\t\tFunction : _ZN12_GLOBAL__N_121packed_moments_kernelILi1EEEvPKf",
        "        /*0100*/   FADD R4, R12, R20 ;  // no HMMAX here",
        "\t\tFunction : plain_c_function",
        "        /*0100*/   HMMA.1688.F32 R4, R12, R20, R4 ;"])
    assert cuda_build.count_sass(sass) == {
        "packed_moments_kernel<2>": 2, "packed_moments_kernel<1>": 0,
        "plain_c_function": 1}
    # a second, bool template argument (the sazo instances) is named too
    sazo = sass.replace("kernelILi2EEEv", "kernelILi2ELb1EEEv").replace(
        "kernelILi1EEEv", "kernelILi1ELb0EEEv")
    assert cuda_build.count_sass(sazo) == {
        "packed_moments_kernel<2, true>": 2,
        "packed_moments_kernel<1, false>": 0, "plain_c_function": 1}
    report = ("ptxas info    : Function properties for k\n"
              "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
              "loads\nptxas info    : Used 80 registers\n"
              "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
              "loads\n")
    assert cuda_build.spill_bytes(report) == 12
    assert cuda_build.spill_bytes(report.split("ptxas info    : Used")[0]) \
        == 0
    assert "Used 80 registers" in cuda_build.ptxas_usage(report)
    # each usage line is led by the kernel ptxas compiled last
    named = ("ptxas info    : Compiling entry function "
             "'_ZN12_GLOBAL__N_121packed_moments_kernelILi4ELb1EEEvPKf' "
             "for 'sm_90a'\n" + report)
    assert cuda_build.ptxas_usage(named)[1] \
        == "packed_moments_kernel<4, true>: Used 80 registers"
