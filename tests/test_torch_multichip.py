"""
Multi-device serving of the port (``GeometryClassifier.predict_multichip``
over ``parallel.mesh.make_fused_predict_2d``) against the JAX package, on
a (2, 2) mesh: the reference on four of the CPU's eight forced host
devices, the port on four entries of ``torch.device("cpu")``.

* Packed backend, the reference's fitted linear classifier carried in
  (``SoftmaxClassifier.from_state``): the segment-wide candidate caps
  equal the reference's, and the labels equal the reference's
  ``predict_multichip`` labels; the second call (cached sizing) serves
  the same labels, and the port's single-device step agrees for
  >= 0.999 of the points, the reference's own bar.
* The same with the reference's device-fitted forest carried in
  (``RPTEnsemble.from_tables``).
* ``_size_multichip_caps`` and ``multiscale._interp_packed_plan(...,
  segment_wide=True)`` equal the reference's on the bench scene.
* The refusals: an unfitted model, an edge-0 band, a CPU model without
  a mesh, a mesh of another shape.
* The other shard branches against the port's single-device serving:
  the span kernel (``backend="pallas"``), the XLA path and ``vector``
  (the packed interp with segment-wide plans, and the gather interp on
  the XLA path).
"""

import numpy as np
import pytest
import torch

from nimrud_tpu import pipeline as jpl
from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.ops import packing as jpk
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.learning.rpt import RPTEnsemble
from nimrud_tpu_torch.ops import packing as tpk
from nimrud_tpu_torch.parallel import mesh as pmesh
from nimrud_tpu_torch.utils import workload as twl
from torch_rpt_cases import numpy_tables
from torch_thread_cases import one_torch_thread  # noqa: F401

SCALESET = [(0.2, (0.8, 0.4))]
MESH = (2, 2)
MIN_AGREE = 0.999


def _scene(per, seed):
    """The reference pipeline tests' scene: a sheet, a vertical line and
    a blob (labels 0 / 1 / 2)."""
    rng = np.random.default_rng(seed)
    sheet = rng.random((per, 3)) * [8, 8, 0.02]
    line = rng.random((per, 3)) * [0.02, 0.02, 8] + [10, 4, 0]
    blob = rng.normal([16, 4, 4], 1.0, (per, 3))
    cloud = np.vstack([sheet, line, blob]).astype(np.float32)
    return cloud, np.repeat([0, 1, 2], per)


BOUNDS = (np.float32([-1, -1, -1]), np.float32([21, 9, 9]))


def _cpu_mesh():
    return pmesh.make_mesh_2d(MESH, devices=[torch.device("cpu")] * 4)


@pytest.fixture(scope="module")
def scene():
    cloud, labels = _scene(500, 0)
    other, other_labels = _scene(500, 1)
    return cloud, labels, other, other_labels


def _models(cloud, labels, classifier, **kw):
    """The reference fitted on ``cloud`` and the port with its
    classifier carried in."""
    kwargs = {"epochs": 25} if classifier == "linear" \
        else {"n_estimators": 4, "seed": 0}
    ref = jpl.GeometryClassifier(SCALESET, classifier=classifier,
                                 classifier_kwargs=kwargs, bounds=BOUNDS,
                                 backend="packed", **kw)
    ref.fit(cloud, labels)
    clf = ref.classifier
    if classifier == "linear":
        carried = SoftmaxClassifier.from_state(
            np.asarray(clf.params["w"]), np.asarray(clf.params["b"]),
            np.asarray(clf.mean_), np.asarray(clf.scale_), device="cpu")
    else:
        carried = RPTEnsemble.from_tables(numpy_tables(clf._tables),
                                          clf.max_depth_, clf.d_func, "cpu")
    port = tpl.GeometryClassifier(SCALESET, bounds=BOUNDS, backend="packed",
                                  device="cpu", **kw)
    port.install_classifier(carried, cloud)
    return ref, port


@pytest.mark.parametrize("classifier", ["linear", "rpte"])
def test_packed_multichip_matches_reference(scene, classifier):
    cloud, labels, other, truth = scene
    ref, port = _models(cloud, labels, classifier)
    j_labels = np.asarray(ref.predict_multichip(other, mesh_shape=MESH))
    mesh = _cpu_mesh()
    t_labels = port.predict_multichip(other, MESH, mesh=mesh)
    assert t_labels.dtype == np.int32 and t_labels.shape == (len(other),)
    # the capacities the shard programs were built with
    assert port._multichip_caps_cache == ref._multichip_caps_cache
    differ = np.nonzero(t_labels != j_labels)[0]
    print(f"{len(differ)} of {len(other)} labels differ: {differ[:20]}")
    assert len(differ) == 0
    single = port.predict(other)
    assert (single == t_labels).mean() >= MIN_AGREE
    if classifier == "linear":
        assert (t_labels == truth).mean() > 0.85
        # the cached sizing serves the same labels
        np.testing.assert_array_equal(
            port.predict_multichip(other, MESH, mesh=mesh), t_labels)


def test_multichip_sizing_matches_reference():
    cloud, _ = twl.make_bench_cloud(20_000, seed=0)
    lo, hi = (np.asarray(b, np.float64) for b in (cloud.min(0),
                                                  cloud.max(0)))
    ref = jwl.make_bench_model(cloud)
    port = twl.make_bench_model(cloud, device="cpu")
    rows = 5000
    assert port._size_multichip_caps(cloud, lo, hi, rows) \
        == ref._size_multichip_caps(cloud, lo, hi, rows)
    for edge in twl.BENCH_EDGES:
        t_spec, t_cap = tms._interp_packed_plan(
            cloud, tpk.GridSpec.fit_bounds(lo, hi, edge), lo, hi, (lo, hi),
            3, segment_wide=True)
        j_spec, j_cap = jms._interp_packed_plan(
            cloud, jpk.GridSpec.fit_bounds(lo, hi, edge), lo, hi, (lo, hi),
            3, segment_wide=True)
        assert t_spec.__dict__ == j_spec.__dict__
        assert isinstance(t_cap, int) and t_cap == j_cap


def test_multichip_refusals(scene):
    cloud, labels, _, _ = scene
    mesh = _cpu_mesh()
    unfit = tpl.GeometryClassifier(SCALESET, device="cpu")
    with pytest.raises(ValueError, match="fitted"):
        unfit.predict_multichip(cloud, MESH, mesh=mesh)
    dense_band = tpl.GeometryClassifier(
        [(0.0, (0.5,))], classifier_kwargs={"epochs": 2}, device="cpu")
    dense_band.fit(cloud, labels)
    with pytest.raises(ValueError, match="voxelized"):
        dense_band.predict_multichip(cloud, MESH, mesh=mesh)
    model = tpl.GeometryClassifier(SCALESET, classifier_kwargs={"epochs": 2},
                                   device="cpu")
    model.fit(cloud, labels)
    with pytest.raises(ValueError, match="explicit mesh"):
        model.predict_multichip(cloud, MESH)
    with pytest.raises(ValueError, match="needs 4 devices"):
        pmesh.make_mesh_2d(MESH, devices=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="mesh of shape"):
        model.predict_multichip(cloud, (4, 1), mesh=mesh)


def _small_scene(seed):
    """A compact scene for the XLA-bound branches (their tile specs plan
    every coarse tile of the site on each shard)."""
    rng = np.random.default_rng(seed)
    per = 250
    sheet = rng.random((per, 3)) * [4, 3.4, 0.02]
    line = rng.random((per, 3)) * [0.02, 0.02, 3] + [4.5, 1.5, 0]
    blob = np.clip(rng.normal([6, 1.7, 1.7], 0.6, (per, 3)), 0,
                   [6.9, 3.4, 3.4])
    cloud = np.vstack([sheet, line, blob]).astype(np.float32)
    attrs = np.stack([cloud[:, 2], np.sin(cloud[:, 0])],
                     axis=1).astype(np.float32)
    return cloud, np.repeat([0, 1, 2], per), attrs


@pytest.mark.parametrize("backend,kind", [("pallas", "minimal"),
                                          ("xla", "minimal"),
                                          ("packed", "vector"),
                                          ("xla", "vector")])
def test_other_branches_match_single_device(backend, kind):
    cloud, labels, attrs = _small_scene(0)
    other, _, attrs_other = _small_scene(1)
    if kind != "vector":
        attrs = attrs_other = None
    model = tpl.GeometryClassifier(
        [(0.5, (0.5,))], kind=kind, backend=backend,
        bounds=(np.float32([-0.5, -0.5, -0.5]), np.float32([7, 3.5, 3.5])),
        classifier_kwargs={"epochs": 25, "seed": 0}, vector_s_cap=64,
        device="cpu")
    model.fit(cloud, labels, attributes=attrs)
    multi = model.predict_multichip(other, MESH, mesh=_cpu_mesh(),
                                    attributes=attrs_other)
    single = model.predict(other, attributes=attrs_other)
    agree = (multi == single).mean()
    print(f"{backend} {kind}: agreement {agree}")
    assert agree >= MIN_AGREE
    if kind == "vector" and backend == "packed":
        # the packed interp ran on the segment-wide plans
        assert any(k[-1] == "interp" for k in model._multichip_caps_cache)
