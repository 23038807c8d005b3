"""
``GeometryClassifier(kind="vector")`` (V_MSO on the packed backend) end
to end against the JAX package, on a scaled-down bench scene with the
reference benchmark's two attribute columns (``scripts/bench_kinds.py``):

* Served with the reference's fitted classifier carried across: the
  serving specs (the interp's tile spec and capacity in place of the
  voxel cap), all five overflow counters (0, ``interp_dropped``
  included) and the labels equal the reference's, except at reference
  near-ties (top-two probability gap < 1e-4).
* Fit against serve on the port (``tests/test_drive_matrix.py``'s
  contract): the labels the fit features give equal the served labels
  under float32 uploads, and agree for at least 99.5% of points under
  uint16 uploads.
* Fitted by the port itself: held-out accuracy within 0.03 of the JAX
  fit's on the same split.
* Past 6 attribute columns, and on the span backend, the model takes
  the XLA bands (``tests/test_torch_xla_pipeline.py`` serves them);
  bad arguments raise.
"""

import numpy as np
import pytest

from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.pipeline import COUNTERS
from nimrud_tpu_torch.utils import workload as twl
from test_torch_kinds_packed import _drive_scene
from test_torch_pipeline import _carried, _held_out

N = 6000
SAMPLE = 3000
TIE_GAP = 1e-4


@pytest.fixture(scope="module")
def fitted():
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    attrs = twl.make_bench_attributes(labels)
    ref = jwl.make_bench_model(cloud, kind="vector")
    ref.fit(cloud, labels, sample=SAMPLE, attributes=attrs)
    return cloud, labels, attrs, ref


def serve_both(ref, port, cloud, attrs):
    """Serve ``cloud`` through both models: counters equal (and 0),
    labels equal except at reference near-ties.  Returns the port's
    labels."""
    j_labels, j_probs, j_diag = ref.predict_staged(
        ref.stage(cloud, attributes=attrs), with_proba=True, with_diag=True)
    t_labels, t_diag = port.predict_staged(
        port.stage(cloud, attributes=attrs), with_diag=True)
    for key in COUNTERS:
        assert int(t_diag[key]) == int(j_diag[key]) == 0, key
    j_labels, j_probs = np.asarray(j_labels), np.asarray(j_probs)
    t_labels = t_labels.numpy()
    top2 = np.sort(j_probs, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < TIE_GAP
    differ = t_labels != j_labels
    print(f"vector: {int(differ.sum())} labels differ, "
          f"{int(near_tie.sum())} near-ties of {len(cloud)}")
    assert not np.any(differ & ~near_tie)
    return t_labels


def test_served_labels_match_reference_classifier(fitted):
    cloud, labels, attrs, ref = fitted
    port = twl.make_bench_model(cloud, kind="vector", device="cpu")
    port.install_classifier(_carried(ref.classifier), cloud,
                            attributes=attrs)
    (_, jspecs), (_, tspecs) = ref._spec_cache, port._spec_cache
    for j, t in zip(jspecs, tspecs):
        assert t[0].__dict__ == j[0].__dict__
        assert t[1].__dict__ == j[1].__dict__
        assert t[3].__dict__ == j[3].__dict__ and t[3].q_cap == 128
        assert (t[2], t[4], t[5]) == (j[2], j[4], j[5])
    other, truth = twl.make_bench_cloud(N, seed=1)
    other_attrs = twl.make_bench_attributes(truth, seed=4)
    served = serve_both(ref, port, other, other_attrs)
    assert float((served == truth).mean()) > 0.8


def test_port_fit_accuracy_matches_reference_fit(fitted):
    cloud, labels, attrs, ref = fitted
    port = twl.make_bench_model(cloud, kind="vector", device="cpu")
    port.fit(cloud, labels, sample=SAMPLE, attributes=attrs)
    acc_port = _held_out(labels, port.predict(cloud, attributes=attrs))
    acc_ref = _held_out(labels, ref.predict(cloud, attributes=attrs))
    print(f"vector held-out accuracy: port {acc_port:.4f}, reference "
          f"{acc_ref:.4f}")
    assert acc_port > 0.8
    assert abs(acc_port - acc_ref) <= 0.03


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint16"])
def test_vector_fit_matches_serve(transfer_dtype):
    cloud, labels = _drive_scene()
    rng = np.random.default_rng(21)
    attrs = np.stack([labels + 0.05 * rng.standard_normal(len(labels)),
                      rng.random(len(labels))], axis=1).astype(np.float32)
    lo, hi = cloud.min(0) - 0.37, cloud.max(0) + 0.53
    model = tpl.GeometryClassifier(
        [(0.2, (0.8, 0.4))], kind="vector", classifier="linear",
        classifier_kwargs={"epochs": 10, "seed": 0},
        transfer_dtype=transfer_dtype, backend="packed", bounds=(lo, hi),
        trim_entries=True, device="cpu")
    model.fit(cloud, labels, attributes=attrs)
    feats = model.extract_device(cloud, attributes=attrs)
    assert feats.shape == (len(cloud), 2 * 2)
    from_fit = model.classifier.proba_device(feats).argmax(1).numpy()
    served, diag = model.predict_staged(
        model.stage(cloud, attributes=attrs), with_diag=True)
    assert all(int(v) == 0 for v in diag.values()), diag
    served = served.numpy()
    agree = float((from_fit == served).mean())
    print(f"vector fit vs serve, {transfer_dtype}: agreement {agree}")
    if transfer_dtype == "uint16":
        assert agree >= 0.995
    else:
        np.testing.assert_array_equal(from_fit, served)


def test_vector_raises_where_the_port_has_no_path():
    cloud, labels = twl.make_bench_cloud(2000, seed=0)
    attrs = twl.make_bench_attributes(labels)
    model = twl.make_bench_model(cloud, kind="vector", device="cpu")
    with pytest.raises(ValueError, match="attributes"):
        model.fit(cloud, labels)
    # past the packed kernel's 6 attribute rows the model fits and sizes
    # the reference's per-band XLA serving (no candidate capacity)
    model.fit(cloud, labels, attributes=np.ones((2000, 7), np.float32))
    assert all(band[5] is None and band[3] is not None
               for band in model._spec_cache[1])
    with pytest.raises(ValueError, match="attributes must be"):
        model.fit(cloud, labels, attributes=attrs[:100])
    minimal = twl.make_bench_model(cloud, device="cpu")
    with pytest.raises(ValueError, match="attributes"):
        minimal.stage(cloud, attributes=attrs)
    # vector on the span backend serves on XLA bands (ported)
    assert twl.make_bench_model(cloud, kind="vector", backend="pallas",
                                device="cpu").backend == "pallas"
    with pytest.raises(ValueError, match="named explicitly"):
        tpl.GeometryClassifier([(0.5, (1.0,))], precision="bf16x2",
                               device="cpu")
    with pytest.raises(ValueError, match="precision"):
        tpl.GeometryClassifier([(0.5, (1.0,))], precision="bf16",
                               backend="packed", device="cpu")
