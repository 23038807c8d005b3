"""
The ``rpte`` serving step (``make_bench_model(classifier="rpte")``, the
reference's ``scripts/bench_rpte.py`` model) on a scaled-down bench
scene against the JAX package.

* Carried across: the reference's device-fitted forest
  (``RPTEnsemble.from_tables`` of its tables) in the port's packed model
  serves a second cloud.  The serving specs and all five counters equal
  the reference's, and the labels too, except where a label is
  witnessed: the port's served feature rows lie within the reference
  tests' feature tolerance of the reference's rows (counts equal, the
  rest within 1e-3), and the port's label is the reference forest's
  label of the port's rows (the JAX walk of them), or the float64 walk
  witness (``checks.walk_witness``) holds the row.  At most 0.5%
  of labels.
* The same forest on the span path (``backend="pallas"``) and the
  exclusion path (``exclude_radius``, ``predict`` /
  ``predict_proba``): the port's labels equal the reference forest's
  walk (JAX) of the port's own feature rows on that path, except where
  the walk witness holds the row.  Those paths' feature rows are held
  against the reference by ``test_torch_span_pipeline.py`` and
  ``test_torch_exclude_pipeline.py``.
* Fitted by the port itself (``fit`` -> ``fit_device`` on the device
  features): held-out accuracy within 0.03 of the reference's fit on the
  same split.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.learning import rpt as jrpt
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch.utils import checks
from nimrud_tpu_torch.learning.rpt import RPTEnsemble
from nimrud_tpu_torch.pipeline import COUNTERS
from nimrud_tpu_torch.utils import workload as twl
from test_torch_kinds_packed import (_port_served_features,
                                     _reference_served_features)
from test_torch_pipeline import _held_out
from torch_rpt_cases import numpy_tables
from torch_thread_cases import one_torch_thread  # noqa: F401

N = 6000
SAMPLE = 3000
MAX_WITNESSED = 0.005


@pytest.fixture(scope="module")
def fitted():
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    ref = jwl.make_bench_model(cloud, classifier="rpte")
    ref.fit(cloud, labels, sample=SAMPLE)
    return cloud, labels, ref


def _forest(ref):
    clf = ref.classifier
    return RPTEnsemble.from_tables(numpy_tables(clf._tables),
                                   clf.max_depth_, clf.d_func, "cpu")


def _reference_walk(ref, feats):
    """The reference forest's labels of feature rows, by its own walk."""
    clf = ref.classifier
    return np.asarray(jrpt._ensemble_proba(
        clf._tables, jnp.asarray(feats), clf.max_depth_, clf.d_func)
        ).argmax(1)


def _walked(ref, forest, feats, labels):
    """Rows whose ``labels`` are not the reference walk's of ``feats``
    and not held by the float64 walk witness."""
    off = np.nonzero(_reference_walk(ref, feats) != labels)[0]
    held = checks.walk_witness(forest._tables, torch.from_numpy(feats),
                                    forest.max_depth_,
                                    torch.from_numpy(off)).numpy()
    return off[~held]


def test_carried_forest_serves_the_reference_labels(fitted):
    cloud, _, ref = fitted
    forest = _forest(ref)
    port = twl.make_bench_model(cloud, device="cpu")
    port.install_classifier(forest, cloud)
    (_, jspecs), (_, tspecs) = ref._spec_cache, port._spec_cache
    for j, t in zip(jspecs, tspecs):
        assert t[1].__dict__ == j[1].__dict__
        assert (t[2], t[4], t[5]) == (j[2], j[4], j[5])

    other, _ = twl.make_bench_cloud(N, seed=1)
    j_staged, t_staged = ref.stage(other), port.stage(other)
    j_labels, j_diag = ref.predict_staged(j_staged, with_diag=True)
    t_labels, t_probs, t_diag = port.predict_staged(
        t_staged, with_proba=True, with_diag=True)
    for key in COUNTERS:
        assert int(t_diag[key]) == int(j_diag[key]) == 0, key
    j_labels, t_labels = np.asarray(j_labels), t_labels.numpy()
    np.testing.assert_allclose(t_probs.sum(1).numpy(), 1.0, atol=1e-5)
    differ = np.nonzero(t_labels != j_labels)[0]
    print(f"{len(differ)} of {N} labels differ from the reference's")
    assert len(differ) <= MAX_WITNESSED * N
    if len(differ):
        t_feats = _port_served_features(port, t_staged)[:N]
        j_feats = _reference_served_features(ref, j_staged)
        np.testing.assert_array_equal(t_feats[:, 0::4], j_feats[:, 0::4])
        np.testing.assert_allclose(t_feats, j_feats, atol=1e-3, rtol=1e-5)
        assert len(_walked(ref, forest, t_feats[differ],
                           t_labels[differ])) == 0


@pytest.mark.parametrize("path", ["span", "exclusion"])
def test_carried_forest_serves_the_other_paths(fitted, path):
    cloud, _, ref = fitted
    forest = _forest(ref)
    other, _ = twl.make_bench_cloud(N, seed=1)
    if path == "span":
        port = twl.make_bench_model(cloud, backend="pallas", device="cpu")
        port.install_classifier(forest, cloud)
        staged = port.stage(other)
        labels, diag = port.predict_staged(staged, with_diag=True)
        feats = _port_served_features(port, staged)[:N]
        probs = port.predict_staged(staged, with_proba=True)[1].numpy()
    else:
        port = twl.make_bench_model(cloud, exclude_radius=0.1, device="cpu")
        port.install_classifier(forest, cloud)
        labels, diag = port.predict_device(other, with_diag=True)
        feats = port.extract(other)
        probs = port.predict_proba(other)
    assert not any(int(diag[key]) for key in COUNTERS)
    labels = labels.numpy()
    np.testing.assert_array_equal(labels, probs.argmax(1))
    assert len(_walked(ref, forest, feats, labels)) == 0


def test_port_fit_accuracy_matches_reference_fit(fitted):
    cloud, labels, ref = fitted
    port = twl.make_bench_model(cloud, classifier="rpte", device="cpu")
    port.fit(cloud, labels, sample=SAMPLE)
    assert isinstance(port.classifier, RPTEnsemble)
    assert port.classifier.max_depth_ == 14
    staged = port.stage(cloud)
    acc_port = _held_out(labels, port.predict_staged(staged).numpy())
    acc_ref = _held_out(labels, np.asarray(
        ref.predict_staged(ref.stage(cloud))))
    print(f"held-out accuracy: port {acc_port:.4f}, reference "
          f"{acc_ref:.4f}")
    assert acc_port > 0.8
    assert abs(acc_port - acc_ref) <= 0.03
