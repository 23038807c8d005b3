"""
``learning/persistence.py`` against the JAX package's: a model or a
pipeline saved by either package loads in the other, with the same
arrays, the same fields and the same probabilities on the feature rows
of ``torch_rpt_cases.py`` -- a linear model, a host-fitted forest
(sparse tables) and a device-fitted one (dense tables; the reference
writes no derived ``dense_blk*`` tables and rebuilds them on load).
"""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu import pipeline as jpl
from nimrud_tpu.learning import linear as jlin
from nimrud_tpu.learning import persistence as jper
from nimrud_tpu.learning import rpt as jrpt

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.learning import persistence as tper
from nimrud_tpu_torch.learning import rpt as trpt
from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from torch_rpt_cases import forest_data, numpy_tables
from torch_thread_cases import one_torch_thread  # noqa: F401

BOUNDS = (np.float32([0.0, 0.0, 0.0]), np.float32([10.0, 12.0, 3.0]))
SCALESET = [(0.25, (0.5,)), (0.5, (1.0, 1.5))]


@pytest.fixture(scope="module")
def data():
    return forest_data(3000, 0), forest_data(500, 1)[0]


def _reference_linear(x, y):
    """A fitted reference linear model's state, float32 as its fits give
    it outside the test suite (whose x64 mode makes them float64)."""
    rng = np.random.default_rng(5)
    clf = jlin.SoftmaxClassifier(standardize=False)
    clf.params = {"w": jnp.asarray(rng.normal(size=(x.shape[1], 3)),
                                   jnp.float32),
                  "b": jnp.asarray(rng.normal(size=3), jnp.float32)}
    clf.mean_ = jnp.asarray(x.mean(0), jnp.float32)
    clf.scale_ = jnp.asarray(x.std(0) + 1e-6, jnp.float32)
    clf.n_classes_ = 3
    return clf


def _reference_forest(kind, x, y):
    clf = jrpt.RPTEnsemble(n_estimators=4, seed=0)
    if kind == "host":
        return clf.fit(x, y)
    return clf.fit_device(jnp.asarray(x), y, n_classes=3, depth=8)


def _port_copy(kind, ref):
    """The port's copy of a reference classifier (through its state)."""
    if kind == "linear":
        port = SoftmaxClassifier.from_state(
            np.asarray(ref.params["w"]), np.asarray(ref.params["b"]),
            np.asarray(ref.mean_), np.asarray(ref.scale_), device="cpu")
        port.standardize = ref.standardize
        return port
    port = trpt.RPTEnsemble.from_tables(
        numpy_tables(ref._tables), ref.max_depth_, ref.d_func, "cpu",
        n_estimators=ref.n_estimators, onepass=ref.onepass)
    port.numlabs, port.dim = ref.numlabs, ref.dim
    return port


def _reference_model(kind, data):
    (x, y), _ = data
    return _reference_linear(x, y) if kind == "linear" \
        else _reference_forest(kind, x, y)


def _same_probabilities(port, ref, x):
    got = port.predict_proba(x) if isinstance(port, trpt.RPTEnsemble) \
        else port.proba_device(torch.from_numpy(x)).numpy()
    want = ref.predict_proba(x) if isinstance(ref, jrpt.RPTEnsemble) \
        else np.asarray(ref.proba_device(jnp.asarray(x)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("kind", ["linear", "host", "device"])
def test_reference_files_load_in_the_port(tmp_path, data, kind):
    ref = _reference_model(kind, data)
    path = jper.save_model(ref, tmp_path / "model")
    port = tper.load_model(path, device="cpu")
    assert type(port) is (SoftmaxClassifier if kind == "linear"
                          else trpt.RPTEnsemble)
    if kind != "linear":
        assert "dense_blk" not in port._tables
        assert (port.max_depth_, port.numlabs, port.dim, port.n_estimators,
                port.onepass) == (ref.max_depth_, ref.numlabs, ref.dim,
                                  ref.n_estimators, ref.onepass)
    else:
        assert port.standardize is False and port.n_classes_ == 3
    _same_probabilities(port, ref, data[1])


@pytest.mark.parametrize("kind", ["linear", "host", "device"])
def test_port_files_load_in_the_reference(tmp_path, data, kind):
    ref = _reference_model(kind, data)
    port = _port_copy(kind, ref)
    path = tper.save_model(port, tmp_path / "model.npz")
    assert path == str(tmp_path / "model.npz")
    with open(path + ".json") as handle:
        meta = json.load(handle)
    with open(jper.save_model(ref, tmp_path / "ref") + ".json") as handle:
        assert meta == json.load(handle)
    with np.load(path) as mine, np.load(tmp_path / "ref.npz") as theirs:
        assert set(mine.files) == set(theirs.files)
        for key in mine.files:
            np.testing.assert_array_equal(mine[key], theirs[key])
    loaded = jper.load_model(path)
    _same_probabilities(port, loaded, data[1])


@pytest.mark.parametrize("direction", ["to_port", "to_reference"])
def test_pipelines_load_across(tmp_path, data, direction):
    ref_clf = _reference_forest("device", *data[0])
    kw = dict(kind="minimal", transfer_dtype="uint16", bounds=BOUNDS,
              trim_entries=True)
    if direction == "to_port":
        src = jpl.GeometryClassifier(SCALESET, classifier=ref_clf, **kw)
        path = jper.save_pipeline(src, tmp_path / "pipe")
        got = tper.load_pipeline(path, device="cpu")
        assert isinstance(got, tpl.GeometryClassifier)
        assert got.device == torch.device("cpu")
    else:
        src = tpl.GeometryClassifier(
            SCALESET, classifier=_port_copy("device", ref_clf),
            device="cpu", **kw)
        path = tper.save_pipeline(src, tmp_path / "pipe")
        got = jper.load_pipeline(path)
        assert isinstance(got, jpl.GeometryClassifier)
    for field in ("scaleset", "kind", "exclude_radius", "transfer_dtype",
                  "vector_s_cap", "trim_entries"):
        assert getattr(got, field) == getattr(src, field), field
    # the reference's extractor options: the port writes its defaults
    with open(path + ".json") as handle:
        cfg = json.load(handle)["pipeline"]
    assert (cfg["method"], cfg["chunk_size"]) == ("auto", 1024)
    for a, b in zip(got.bounds, src.bounds):
        np.testing.assert_array_equal(a, b)
    _same_probabilities(*((got.classifier, ref_clf)
                          if direction == "to_port"
                          else (src.classifier, got.classifier)), data[1])


def test_persistence_refuses_what_it_cannot_carry(tmp_path):
    with pytest.raises(ValueError, match="not fitted"):
        tper.save_model(SoftmaxClassifier(), tmp_path / "a")
    with pytest.raises(ValueError, match="not fitted"):
        tper.save_model(trpt.RPTEnsemble(device="cpu"), tmp_path / "b")
    with pytest.raises(ValueError, match="cannot persist"):
        tper.save_model(object(), tmp_path / "c")
    clf = SoftmaxClassifier.from_state(np.zeros((2, 2)), np.zeros(2),
                                       np.zeros(2), np.ones(2), "cpu")
    path = tper.save_model(clf, tmp_path / "d")
    with pytest.raises(ValueError, match="save_pipeline"):
        tper.load_pipeline(path, device="cpu")
    # a pipeline of another extraction method loads with it (the port
    # carries the reference's dense and tiled methods)
    path = tper.save_pipeline(
        tpl.GeometryClassifier(SCALESET, classifier=clf, device="cpu"),
        tmp_path / "e")
    with open(path + ".json") as handle:
        meta = json.load(handle)
    meta["pipeline"]["method"] = "dense"
    with open(path + ".json", "w") as handle:
        json.dump(meta, handle)
    assert tper.load_pipeline(path, device="cpu").method == "dense"
