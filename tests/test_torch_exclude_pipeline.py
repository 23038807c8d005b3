"""
``GeometryClassifier(exclude_radius=e)`` end to end against the JAX
package, on a scaled-down bench scene (one reference fit a kind, shared
by the module's tests):

* ``minimal``: the reference's fitted classifier, carried across,
  serves a second cloud through the port's ``predict`` (the per-band
  extraction with the exclusion instances, ``proba_device``, argmax).
  The labels equal the reference's as its TPU path computes them: its
  ``extract_scaleset_fused(tuning={"backend": "packed"},
  exclude_radius=e)`` (interpret mode), its classifier's
  ``proba_device``, argmax (on the CPU its own ``extract_device`` takes
  the XLA backend; ROADMAP.md, Decisions).  Below ``TILED_THRESHOLD``
  points ``method="auto"`` takes the dense method in both packages, so
  the port's model names ``method="fused"`` to serve this path.
  Probabilities within 1e-3, as ``tests/test_torch_pipeline.py`` holds
  them.
* ``vector`` (the reference model passes ``backend="packed"`` and so
  serves through that path itself): the port's labels equal the
  reference's ``predict`` except at reference near-ties (top-two gap <
  1e-4), probabilities within 1e-3.
* Fitted by the port itself: held-out accuracy within 0.03 of the
  reference fit's on the same split (``tests/test_torch_pipeline.py``'s
  margin).
* The model has no staged step: ``stage`` raises and names
  ``predict_device``, ``predict_device`` and ``predict`` never stage,
  ``fit`` leaves no serving spec cache; the extraction's overflow
  counters come back with the labels.
"""

import warnings

import numpy as np
import pytest

from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch.pipeline import COUNTERS
from nimrud_tpu_torch.utils import workload as twl
from test_torch_pipeline import _carried

N = 4000
N_VECTOR = 3000
E = 0.1
TIE_GAP = 1e-4


@pytest.fixture(scope="module")
def fitted():
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    ref = jwl.make_bench_model(cloud, exclude_radius=E)
    ref.fit(cloud, labels, sample=N // 2)
    return cloud, labels, ref


@pytest.fixture(scope="module")
def fitted_vector():
    cloud, labels = twl.make_bench_cloud(N_VECTOR, seed=0)
    attrs = twl.make_bench_attributes(labels)
    ref = jwl.make_bench_model(cloud, kind="vector", exclude_radius=E)
    ref.fit(cloud, labels, sample=N_VECTOR // 2, attributes=attrs)
    return cloud, labels, attrs, ref


def _held_out(labels, predicted):
    """Accuracy on the points the fits leave out (``fit(sample=n // 2)``
    trains on the first half of this permutation)."""
    rows = np.random.RandomState(0).permutation(len(labels))
    held = rows[len(labels) // 2:]
    return float((predicted[held] == labels[held]).mean())


def _predict(port, cloud, attributes=None):
    """The port's ``predict``, which must raise no overflow warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return port.predict(cloud, attributes=attributes)


def test_served_labels_match_reference_packed_path(fitted, monkeypatch):
    cloud, _, ref = fitted
    port = twl.make_bench_model(cloud, device="cpu", exclude_radius=E,
                                method="fused")
    port.install_classifier(_carried(ref.classifier), cloud)
    assert port._spec_cache is None
    other, truth = twl.make_bench_cloud(N, seed=1)
    feats = jms.extract_scaleset_fused(
        other, other, ref.scaleset, "minimal", exclude_radius=E,
        tuning={"backend": "packed"}, bounds=ref.bounds)
    j_probs = np.asarray(ref.classifier.proba_device(feats))
    j_labels = np.argmax(j_probs, axis=1)
    # neither serving entry point stages
    monkeypatch.setattr(port, "stage", None)
    t_labels = _predict(port, other)
    assert t_labels.dtype == np.int32
    np.testing.assert_array_equal(t_labels, j_labels)
    assert float((t_labels == truth).mean()) > 0.8
    labels, diag = port.predict_device(other, with_diag=True)
    np.testing.assert_array_equal(labels.numpy(), t_labels)
    assert {k: int(v) for k, v in diag.items()} == dict.fromkeys(COUNTERS,
                                                                  0)
    np.testing.assert_allclose(port.predict_proba(other), j_probs,
                               atol=1e-3)
    np.testing.assert_array_equal(port.extract(other),
                                  port.extract_device(other).numpy())


def test_port_fit_accuracy_matches_reference_fit(fitted):
    cloud, labels, ref = fitted
    port = twl.make_bench_model(cloud, device="cpu", exclude_radius=E)
    port.fit(cloud, labels, sample=N // 2)
    assert port._spec_cache is None and port._stage_spec_cache == {}
    acc_port = _held_out(labels, _predict(port, cloud))
    acc_ref = _held_out(labels, ref.predict(cloud))
    print(f"exclude_radius {E} held-out accuracy: port {acc_port:.4f}, "
          f"reference {acc_ref:.4f}")
    assert acc_port > 0.8
    assert abs(acc_port - acc_ref) <= 0.03


def test_stage_raises_for_an_exclusion_model(fitted):
    cloud, _, ref = fitted
    port = twl.make_bench_model(cloud, device="cpu", exclude_radius=E)
    port.install_classifier(_carried(ref.classifier), cloud)
    with pytest.raises(ValueError, match="predict_device"):
        port.stage(cloud)
    # exclude_radius=0.0 is not None: it takes the exclusion path too,
    # with the features of no exclusion
    zero = twl.make_bench_model(cloud, device="cpu", exclude_radius=0.0)
    zero.install_classifier(_carried(ref.classifier), cloud)
    with pytest.raises(ValueError, match="predict_device"):
        zero.stage(cloud)
    plain = twl.make_bench_model(cloud, device="cpu")
    np.testing.assert_array_equal(zero.extract(cloud), plain.extract(cloud))


def test_vector_labels_match_reference(fitted_vector):
    cloud, labels, attrs, ref = fitted_vector
    port = twl.make_bench_model(cloud, kind="vector", device="cpu",
                                exclude_radius=E)
    port.install_classifier(_carried(ref.classifier), cloud,
                            attributes=attrs)
    j_probs = np.asarray(ref.predict_proba_device(cloud, attributes=attrs))
    j_labels = np.argmax(j_probs, axis=1)
    t_labels = _predict(port, cloud, attributes=attrs)
    top2 = np.sort(j_probs, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < TIE_GAP
    differ = t_labels != j_labels
    print(f"vector: {int(differ.sum())} labels differ, "
          f"{int(near_tie.sum())} near-ties of {len(cloud)}")
    assert not np.any(differ & ~near_tie)
    np.testing.assert_allclose(port.predict_proba(cloud, attributes=attrs),
                               j_probs, atol=1e-3)
    # fitted by the port: held-out accuracy as the reference fit's
    fit = twl.make_bench_model(cloud, kind="vector", device="cpu",
                               exclude_radius=E)
    fit.fit(cloud, labels, sample=N_VECTOR // 2, attributes=attrs)
    acc_port = _held_out(labels, _predict(fit, cloud, attributes=attrs))
    acc_ref = _held_out(labels, j_labels)
    print(f"vector exclude_radius {E} held-out accuracy: port "
          f"{acc_port:.4f}, reference {acc_ref:.4f}")
    assert acc_port > 0.8
    assert abs(acc_port - acc_ref) <= 0.03
