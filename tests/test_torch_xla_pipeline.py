"""
``GeometryClassifier`` on the XLA path end to end against the JAX
package, on a small scene (the bench scene scaled to a 10 m site, two
bands, ``tile_m`` 1 so the XLA candidate tables stay small):

* ``backend="xla"`` for ``minimal``, ``sazo`` and ``vector`` (2 and 9
  attribute columns: the gather and the matmul interp), and the bands
  no kernel carries -- ``sazo`` and ``vector`` under ``"pallas"``,
  ``vector`` past 6 columns under ``"packed"``: the reference's fitted
  classifier installed into the port, the serving specs field by field,
  every overflow counter and the labels (except at reference near-ties)
  equal to the reference's staged step, probabilities within 1e-3
  (``tests/test_torch_pipeline.py``'s ``_serve_both``); no kernel runs;
* an ``xla`` model's fit features are its served features (the
  reference's ``tests/test_pipeline.py`` contract);
* a model with a band of voxel edge 0 extracts and classifies: its
  ``predict`` equals the reference's, ``stage`` raises naming
  ``predict_device``;
* R2: ``method=`` / ``chunk_size=``: ``method="auto"`` below 16384 search
  points extracts as the reference does (its dense method), and
  ``load_pipeline`` round-trips ``method="dense"``;
* the port's own fit of an ``xla`` model: held-out accuracy > 0.8.
"""

import numpy as np
import pytest
import torch

from nimrud_tpu import pipeline as jpl
from nimrud_tpu.learning import persistence as jper

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.learning import persistence as tper
from nimrud_tpu_torch.ops.kernels import gather_kernel as tgk
from nimrud_tpu_torch.ops.kernels import packed_moments as tpm
from nimrud_tpu_torch.pipeline import COUNTERS
from nimrud_tpu_torch.utils import workload as twl
from test_torch_pipeline import _carried, _serve_both

from torch_thread_cases import one_torch_thread  # noqa: F401

N = 3000
N_VECTOR = 1500
SITE = np.float32([0.1, 0.1, 0.3])
SCALESET = [(0.5, (0.5,)), (1.0, (1.0,))]


def _scene(n, seed):
    cloud, labels = twl.make_bench_cloud(n, seed=seed)
    return cloud * SITE, labels


def _vector_scene(n, width, seed):
    """A uniform 10 x 10 x 3 m cloud (no tile of the interps' grids past
    ``vector_s_cap`` points), three height classes, and ``width``
    attribute columns: the label with 0.05 noise, then noise."""
    rng = np.random.default_rng(seed)
    cloud = (rng.random((n, 3)) * (10, 10, 3)).astype(np.float32)
    labels = np.digitize(cloud[:, 2], (1.0, 2.0)).astype(np.int32)
    cols = rng.random((n, width)).astype(np.float32)
    cols[:, 0] = labels + 0.05 * rng.standard_normal(n)
    return cloud, labels, cols


def _models(cloud, labels, kind, backend, attrs, **extra):
    kw = dict(kind=kind, classifier="linear",
              classifier_kwargs={"epochs": 10, "seed": 0},
              transfer_dtype="uint16", backend=backend, tile_m=1,
              bounds=(cloud.min(0), cloud.max(0)), trim_entries=True,
              vector_s_cap=16, **extra)
    ref = jpl.GeometryClassifier(SCALESET, **kw)
    ref.fit(cloud, labels, sample=len(cloud) // 2, attributes=attrs)
    port = tpl.GeometryClassifier(SCALESET, device="cpu", **kw)
    port.install_classifier(_carried(ref.classifier), cloud,
                            attributes=attrs)
    return ref, port


def _no_kernel(monkeypatch):
    calls = []
    for module, name in ((tpm, "packed_moments"),
                         (tpm, "packed_moments_plain"),
                         (tgk, "span_moments")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, **k: (
            calls.append(1), _r(*a, **k))[1])
    return calls


@pytest.mark.parametrize("kind,backend,width", [
    ("minimal", "xla", 0), ("sazo", "xla", 0), ("vector", "xla", 2),
    ("vector", "xla", 9), ("sazo", "pallas", 0), ("vector", "pallas", 2),
    ("vector", "packed", 7)])
def test_xla_bands_serve_the_reference_labels(kind, backend, width,
                                              monkeypatch):
    if width:
        cloud, labels, attrs = _vector_scene(N_VECTOR, width, seed=0)
    else:
        (cloud, labels), attrs = _scene(N, seed=0), None
    ref, port = _models(cloud, labels, kind, backend, attrs)
    (_, jspecs), (_, tspecs) = ref._spec_cache, port._spec_cache
    for j, t in zip(jspecs, tspecs):
        assert t[0].__dict__ == j[0].__dict__
        assert t[1].__dict__ == j[1].__dict__
        assert t[1].q_cap == 128 and t[1].x_seg == 1
        assert (t[2], t[4], t[5]) == (j[2], j[4], j[5])
        assert (t[3] is None) == (j[3] is None)
        if t[3] is not None:
            assert t[3].__dict__ == j[3].__dict__
    calls = _no_kernel(monkeypatch)
    if kind == "vector":
        # the search attributes ride the staged step
        other = cloud
        j_out = ref.predict_staged(ref.stage(other, attributes=attrs),
                                   with_proba=True, with_diag=True)
        t_out = port.predict_staged(port.stage(other, attributes=attrs),
                                    with_proba=True, with_diag=True)
        for key in COUNTERS:
            assert int(t_out[2][key]) == int(j_out[2][key]) == 0, key
        j_labels, t_labels = np.asarray(j_out[0]), t_out[0].numpy()
        j_probs = np.asarray(j_out[1])
        top2 = np.sort(j_probs, axis=1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
        assert not np.any((t_labels != j_labels) & ~near_tie)
        np.testing.assert_allclose(t_out[1].numpy(), j_probs, atol=1e-3)
    else:
        other, _ = _scene(N, seed=1)
        t_diag = _serve_both(ref, port, other)
        assert not any(int(t_diag[key]) for key in COUNTERS)
    assert not calls


def test_xla_fit_features_are_served_features():
    # float32 uploads: the fused fit extraction and the staged step run
    # the same XLA bands on the same grids, so the labels are equal
    cloud, labels = _scene(N, seed=2)
    kw = dict(kind="minimal", classifier_kwargs={"epochs": 10, "seed": 0},
              backend="xla", tile_m=1, bounds=(cloud.min(0), cloud.max(0)),
              method="fused")
    model = tpl.GeometryClassifier(SCALESET, device="cpu", **kw)
    model.fit(cloud, labels, sample=N // 2)
    from_fit = model.classifier.proba_device(
        model.extract_device(cloud)).argmax(1).numpy()
    served = model.predict_staged(model.stage(cloud)).numpy()
    np.testing.assert_array_equal(served, from_fit)
    # its held-out accuracy is the reference xla model's, within
    # tests/test_torch_pipeline.py's margin
    ref = jpl.GeometryClassifier(SCALESET, **kw)
    ref.fit(cloud, labels, sample=N // 2)
    held = np.ones(N, bool)
    held[np.random.RandomState(0).permutation(N)[:N // 2]] = False
    acc = float((served[held] == labels[held]).mean())
    acc_ref = float((np.asarray(ref.predict(cloud))[held]
                     == labels[held]).mean())
    print(f"held-out accuracy of the xla model: port {acc:.4f}, reference "
          f"{acc_ref:.4f}")
    assert acc > 0.7 and abs(acc - acc_ref) <= 0.03


def test_edge0_model_extracts_then_classifies(monkeypatch):
    cloud, labels = _scene(N, seed=0)
    scaleset = [(0.0, (0.4,)), (0.5, (1.0,))]
    kw = dict(kind="minimal", classifier="linear",
              classifier_kwargs={"epochs": 10, "seed": 0})
    ref = jpl.GeometryClassifier(scaleset, **kw)
    ref.fit(cloud, labels, sample=N // 2)
    port = tpl.GeometryClassifier(scaleset, device="cpu", **kw)
    port.install_classifier(_carried(ref.classifier), cloud)
    assert port._spec_cache is None
    other, truth = _scene(N, seed=1)
    j_probs = np.asarray(ref.predict_proba(other))
    with pytest.raises(ValueError, match="predict_device"):
        port.stage(other)
    monkeypatch.setattr(port, "stage", None)     # predict never stages
    t_labels = port.predict(other)
    top2 = np.sort(j_probs, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < 1e-4
    j_labels = np.asarray(ref.predict(other))
    assert not np.any((t_labels != j_labels) & ~near_tie)
    np.testing.assert_allclose(port.predict_proba(other), j_probs,
                               atol=1e-3)
    labels_dev, diag = port.predict_device(other, with_diag=True)
    np.testing.assert_array_equal(labels_dev.numpy(), t_labels)
    assert {k: int(v) for k, v in diag.items()} == dict.fromkeys(COUNTERS,
                                                                  0)
    assert float((t_labels == truth).mean()) > 0.8


def test_method_option_and_its_persistence(tmp_path):
    cloud, labels = _scene(N, seed=4)
    kw = dict(kind="geometric", classifier_kwargs={"epochs": 10, "seed": 0})
    # R2: "auto" below 16384 search points is the reference's dense method
    ref = jpl.GeometryClassifier(SCALESET, **kw)
    port = tpl.GeometryClassifier(SCALESET, device="cpu", **kw)
    got = port.extract(cloud)
    np.testing.assert_array_equal(got, tpl.GeometryClassifier(
        SCALESET, method="dense", device="cpu", **kw).extract(cloud))
    np.testing.assert_allclose(got, np.asarray(ref.extract_device(cloud)),
                               atol=1e-3, rtol=1e-5)
    # the chunk size moves the dense method's frames, so its rounding
    dense = tpl.GeometryClassifier(SCALESET, method="dense", chunk_size=256,
                                   device="cpu", **kw)
    np.testing.assert_allclose(dense.extract(cloud), got, atol=1e-3,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="method"):
        tpl.GeometryClassifier(SCALESET, method="knn", device="cpu")

    # a saved method and chunk size load in either package
    dense.fit(cloud, labels, sample=N // 2)
    path = tper.save_pipeline(dense, tmp_path / "dense")
    back = tper.load_pipeline(path, device="cpu")
    assert (back.method, back.chunk_size) == ("dense", 256)
    np.testing.assert_array_equal(back.predict(cloud), dense.predict(cloud))
    jback = jper.load_pipeline(path)
    assert (jback.method, jback.chunk_size) == ("dense", 256)
    ref.method, ref.chunk_size = "tiled", 512
    ref.fit(cloud, labels, sample=N // 2)
    ref.classifier.params = {k: np.asarray(v, np.float32)
                             for k, v in ref.classifier.params.items()}
    path = jper.save_pipeline(ref, str(tmp_path / "tiled"))
    back = tper.load_pipeline(path, device="cpu")
    assert (back.method, back.chunk_size) == ("tiled", 512)
    assert isinstance(back.extract_device(cloud), torch.Tensor)
