"""
The host classifiers of the port against the JAX package, on the CPU:

* ``param_classifier``: every kind of ``CLASSIFIER_KINDS`` builds, fits
  and predicts (``test_param_classifier_all_kinds`` ported), the six
  sklearn kinds with the reference's defaults (``get_params()`` equal);
  without sklearn they raise its ``ImportError``.
* The host-classifier route of ``GeometryClassifier``: an sklearn model
  fits on the host from the extracted rows and serves by extracting,
  then classifying (``test_sklearn_classifier_falls_back`` and the erf
  half of ``test_staged_and_stream_match_predict`` ported, with the
  port's ``stage`` raising); the reference's fitted estimator installed
  in the port gives the labels of the float32 cast of its
  ``predict_proba`` on the reference's features bit for bit (the
  reference casts with x64 off, its default) and the reference's labels
  end to end for >= 99.5% of points; ``svm`` and ``sgd`` raise
  ``AttributeError`` at ``predict`` in both packages;
  ``predict_proba_device`` is float32 on the model's device; an sklearn
  estimator cannot be persisted.
* ``SoftmaxClassifier``'s host API: the fit's accuracy and batch order
  (one ``RandomState(seed).permutation`` an epoch, the tail dropped),
  ``predict_proba`` from a reference fit's state within 1e-6, and
  ``train_step`` within 1e-6 of optax's Adam from the same parameters
  and batches.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from nimrud_tpu.learning import classifiers as jcl
from nimrud_tpu.learning import linear as jlin
from nimrud_tpu.pipeline import GeometryClassifier as JModel

from nimrud_tpu_torch.learning import classifiers as tcl
from nimrud_tpu_torch.learning import linear as tlin
from nimrud_tpu_torch.learning import persistence
from nimrud_tpu_torch.pipeline import GeometryClassifier as TModel
from nimrud_tpu_torch.utils.checks import NearestMean
from torch_thread_cases import one_torch_thread  # noqa: F401

SKLEARN_KINDS = ("svm", "rf", "erf", "nb", "knn", "sgd")
KIND_KWARGS = {"svm": {}, "rf": {"n_estimators": 10},
               "erf": {"n_estimators": 10}, "nb": {},
               "knn": {"n_neighbors": 3}, "sgd": {},
               "rpte": {"n_estimators": 3, "seed": 0, "device": "cpu"},
               "linear": {"epochs": 10, "device": "cpu"}}


@pytest.fixture
def sklearn():
    return pytest.importorskip("sklearn")


def _blobs(n_per_class=100, n_classes=3, dim=6, spread=0.8, seed=10):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, dim)) * 4
    data = np.concatenate([rng.normal(centers[c], spread, (n_per_class, dim))
                           for c in range(n_classes)])
    return data, np.repeat(np.arange(n_classes), n_per_class)


def _scene(per, seed=10):
    rng = np.random.default_rng(seed)
    sheet = rng.random((per, 3)) * [8, 8, 0.02]
    line = rng.random((per, 3)) * [0.02, 0.02, 8] + [10, 4, 0]
    blob = rng.normal([16, 4, 4], 1.0, (per, 3))
    cloud = np.vstack([sheet, line, blob]).astype(np.float32)
    return cloud, np.repeat([0, 1, 2], per)


# -- the factory ---------------------------------------------------------------

@pytest.mark.parametrize("kind", tcl.CLASSIFIER_KINDS)
def test_param_classifier_all_kinds(kind):
    if kind in SKLEARN_KINDS:
        pytest.importorskip("sklearn")
    data, labels = _blobs()
    clf = tcl.param_classifier(kind, **KIND_KWARGS[kind])
    clf.fit(data, labels)
    accuracy = (np.asarray(clf.predict(data)) == labels).mean()
    assert accuracy > 0.8, f"{kind}: accuracy {accuracy}"
    if kind in SKLEARN_KINDS:
        ref = jcl.param_classifier(kind, **KIND_KWARGS[kind])
        assert type(clf) is type(ref)
        assert clf.get_params() == ref.get_params()


def test_param_classifier_defaults_and_unknown_kind(sklearn):
    assert tcl.CLASSIFIER_KINDS == jcl.CLASSIFIER_KINDS
    for kind in SKLEARN_KINDS:
        assert tcl.param_classifier(kind).get_params() \
            == jcl.param_classifier(kind).get_params(), kind
    assert tcl.param_classifier("rf").n_jobs == 6
    assert tcl.param_classifier("erf").n_jobs == 6
    assert tcl.param_classifier("sgd").n_jobs == 6
    assert tcl.param_classifier("sgd").loss == "hinge"
    assert tcl.param_classifier("knn").algorithm == "ball_tree"
    assert tcl.param_classifier("rf", n_jobs=2).n_jobs == 2
    with pytest.raises(ValueError):
        tcl.param_classifier("bogus")


def test_sklearn_kinds_raise_without_sklearn(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    for kind in SKLEARN_KINDS:
        with pytest.raises(ImportError):
            tcl.param_classifier(kind)
    assert isinstance(tcl.param_classifier("linear"), tlin.SoftmaxClassifier)


# -- the host-classifier route ---------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    pytest.importorskip("sklearn")
    cloud, labels = _scene(per=400)
    ref = JModel([(0.2, (0.6,))], kind="minimal", classifier="erf",
                 classifier_kwargs={"n_estimators": 10})
    ref.fit(cloud, labels)
    port = TModel([(0.2, (0.6,))], kind="minimal", classifier="erf",
                  classifier_kwargs={"n_estimators": 10}, device="cpu")
    port.fit(cloud, labels)
    return cloud, labels, ref, port


def test_sklearn_classifier_falls_back(fitted):
    cloud, labels, ref, port = fitted
    assert ref._fused_band_specs(cloud, cloud) is None
    assert port._extract_then_classify
    with pytest.raises(ValueError, match="host classifier"):
        port.stage(cloud)
    predicted = port.predict(cloud)
    assert predicted.dtype == np.int32
    assert (predicted == labels).mean() > 0.8
    probs = port.predict_proba_device(cloud)
    assert probs.dtype == torch.float32
    assert probs.device == port.device
    assert tuple(probs.shape) == (len(cloud), 3)


def test_installed_reference_estimator_serves_its_labels(fitted):
    cloud, labels, ref, _ = fitted
    port = TModel([(0.2, (0.6,))], kind="minimal", device="cpu")
    port.install_classifier(ref.classifier, cloud)
    assert port._spec_cache is None           # no staged step to size
    ref_feats = np.array(ref.extract(cloud))
    want = np.asarray(ref.classifier.predict_proba(ref_feats),
                      np.float32).argmax(1)
    got = torch.argmax(port._classify(torch.as_tensor(ref_feats)), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    agree = (port.predict(cloud) == np.asarray(ref.predict(cloud))).mean()
    assert agree >= 0.995, agree


def test_staged_and_stream_serve_through_predict_device(fitted):
    cloud, _, _, port = fitted
    direct = port.predict(cloud)
    shifted = cloud + np.float32([0.5, 0, 0])
    streamed = [out.numpy() for out in port.predict_stream([cloud, shifted])]
    np.testing.assert_array_equal(streamed[0], direct)
    np.testing.assert_array_equal(streamed[1], port.predict(shifted))
    with pytest.raises(ValueError, match="host classifier"):
        list(port.predict_stream([cloud], staged_search={}))


def test_sample_rows_are_the_reference_rows(fitted, monkeypatch):
    cloud, labels, _, port = fitted
    seen = {}
    monkeypatch.setattr(port.classifier, "fit",
                        lambda f, l: seen.update(feats=f, labels=l))
    port.fit(cloud, labels, sample=500, seed=3)
    rows = np.random.RandomState(3).permutation(len(labels))[:500]
    np.testing.assert_array_equal(seen["labels"], labels[rows])
    np.testing.assert_array_equal(seen["feats"], port.extract(cloud)[rows])


def test_numpy_host_classifier_in_both():
    # any classifier without fit_device / proba_device takes the host
    # route in both packages: the same labels on the reference's rows
    cloud, labels = _scene(per=300, seed=7)
    ref = JModel([(0.2, (0.8, 0.4))], kind="minimal",
                 classifier=NearestMean())
    ref.fit(cloud, labels, sample=600)
    port = TModel([(0.2, (0.8, 0.4))], kind="minimal",
                  classifier=NearestMean(), device="cpu")
    port.fit(cloud, labels, sample=600)
    assert (port.predict(cloud) == labels).mean() > 0.8
    port.install_classifier(ref.classifier, cloud)
    ref_feats = np.array(ref.extract(cloud))
    want = np.asarray(ref.classifier.predict_proba(ref_feats),
                      np.float32).argmax(1)
    np.testing.assert_array_equal(
        port._classify(torch.as_tensor(ref_feats)).argmax(1).numpy(), want)
    agree = (port.predict(cloud) == np.asarray(ref.predict(cloud))).mean()
    assert agree >= 0.995, agree
    with pytest.raises(ValueError, match="host classifier"):
        port.stage(cloud)


@pytest.mark.parametrize("kind", ["svm", "sgd"])
def test_margin_kinds_raise_at_predict_in_both(kind, sklearn):
    cloud, labels = _scene(per=150, seed=4)
    ref = JModel([(0.2, (0.6,))], kind="minimal", classifier=kind)
    ref.fit(cloud, labels)
    port = TModel([(0.2, (0.6,))], kind="minimal", classifier=kind,
                  device="cpu")
    port.fit(cloud, labels)
    with pytest.raises(AttributeError):
        ref.predict(cloud)
    with pytest.raises(AttributeError):
        port.predict(cloud)


def test_sklearn_estimator_cannot_be_persisted(fitted, tmp_path):
    _, _, _, port = fitted
    with pytest.raises(ValueError, match="cannot persist"):
        persistence.save_model(port.classifier, tmp_path / "m")
    with pytest.raises(ValueError, match="cannot persist"):
        persistence.save_pipeline(port, tmp_path / "p")


# -- the linear model's host API -----------------------------------------------

def test_softmax_host_fit():
    data, labels = _blobs(n_per_class=400)
    clf = tlin.SoftmaxClassifier(epochs=30, seed=0, device="cpu")
    clf.fit(data, labels)
    proba = clf.predict_proba(data)
    assert proba.shape == (len(data), 3) and proba.dtype == np.float32
    assert np.allclose(proba.sum(1), 1.0, atol=1e-5)
    assert (clf.predict(data) == labels).mean() > 0.95


def test_softmax_host_fit_batch_order(monkeypatch):
    data, labels = _blobs(n_per_class=50)           # 150 rows
    clf = tlin.SoftmaxClassifier(epochs=2, batch_size=64, seed=5,
                                 standardize=False, device="cpu")
    batches = []
    step = tlin.train_step
    monkeypatch.setattr(tlin, "train_step", lambda p, o, d, l, w: (
        batches.append(l.numpy().copy()), step(p, o, d, l, w))[1])
    clf.fit(data, labels)
    rng = np.random.RandomState(5)
    want = []
    for _ in range(2):
        order = rng.permutation(150)
        want += [labels[order[s:s + 64]] for s in range(0, 150 - 64 + 1, 64)]
    assert len(batches) == len(want) == 4
    for got, exp in zip(batches, want):
        np.testing.assert_array_equal(got, exp)


def test_softmax_predict_proba_from_reference_state():
    data, labels = _blobs(n_per_class=200)
    ref = jlin.SoftmaxClassifier(epochs=5, seed=0).fit(data, labels)
    port = tlin.SoftmaxClassifier.from_state(
        ref.params["w"], ref.params["b"], ref.mean_, ref.scale_,
        device="cpu")
    np.testing.assert_allclose(port.predict_proba(data),
                               np.asarray(ref.predict_proba(data)),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.predict(data),
                                  np.asarray(ref.predict(data)))


def test_train_step_matches_optax_adam():
    rng = np.random.default_rng(6)
    w = (rng.normal(size=(6, 3)) / np.sqrt(6)).astype(np.float32)
    b = (rng.normal(size=3) * 0.1).astype(np.float32)
    batches = [(rng.normal(size=(64, 6)).astype(np.float32),
                rng.integers(0, 3, 64).astype(np.int32)) for _ in range(3)]
    lr, wd = 0.05, 1e-3
    optimizer = optax.adam(lr)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    opt_state = optimizer.init(params)
    t_params = tlin.LinearParams(torch.tensor(w), torch.tensor(b))
    t_opt = tlin.make_optimizer(t_params, lr)
    for data, labels in batches:
        params, opt_state, loss = jlin.train_step(
            params, opt_state, jnp.asarray(data), jnp.asarray(labels),
            optimizer, wd)
        t_loss = tlin.train_step(t_params, t_opt, torch.tensor(data),
                                 torch.tensor(labels, dtype=torch.int64), wd)
        assert abs(float(t_loss) - float(loss)) <= 1e-6
        np.testing.assert_allclose(t_params.w.detach().numpy(),
                                   np.asarray(params["w"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(t_params.b.detach().numpy(),
                                   np.asarray(params["b"]), rtol=0,
                                   atol=1e-6)
