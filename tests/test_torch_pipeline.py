"""
The slice end to end: the bench workload (``make_bench_model`` on a
scaled-down ``make_bench_cloud``) served by the port against the JAX
package.

* Carried across: the reference's fitted classifier, installed into the
  port, serves a second cloud of the fit size and a denser one that
  overflows the fit-sized capacities; the serving specs, all five
  overflow counters and the labels (except at reference near-ties)
  equal the reference's.
* The same carried-over classifier behind float32 uploads, bounds
  taken from each cloud and untrimmed specs: labels and counters equal
  the reference's.
* Fitted by the port itself: held-out accuracy within 0.03 of the JAX
  fit on the same split (Adam, PRNG and feature sums differ in bits).
* Self-search spelled out (``search=cloud``) is one quantized upload,
  and a model whose entry slots exceed ``_CHUNK_SLOTS`` serves in entry
  chunks with the un-chunked labels.  (A separate search cloud serves:
  tests/test_torch_designated.py; entry chunks against the reference:
  tests/test_torch_chunked.py.)
"""

import numpy as np
import pytest
import torch

from nimrud_tpu import pipeline as jpl
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.pipeline import COUNTERS
from nimrud_tpu_torch.utils import workload as twl

N = 6000          # fit size; the 8192-row bucket also serves 8192 points
SAMPLE = 3000
TIE_GAP = 1e-4


@pytest.fixture(scope="module")
def fitted():
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    ref = jwl.make_bench_model(cloud)
    ref.fit(cloud, labels, sample=SAMPLE)
    return cloud, labels, ref


def _carried(clf):
    return SoftmaxClassifier.from_state(
        np.asarray(clf.params["w"]), np.asarray(clf.params["b"]),
        np.asarray(clf.mean_), np.asarray(clf.scale_), device="cpu")


def _serve_both(ref, port, cloud):
    """Serve ``cloud`` through both models: the port's counters equal
    the reference's, and its labels too except at reference near-ties.
    Returns the port's counters."""
    j_labels, j_probs, j_diag = ref.predict_staged(
        ref.stage(cloud), with_proba=True, with_diag=True)
    t_labels, t_probs, t_diag = port.predict_staged(
        port.stage(cloud), with_proba=True, with_diag=True)
    print({key: int(t_diag[key]) for key in COUNTERS})
    for key in COUNTERS:
        assert int(t_diag[key]) == int(j_diag[key]), key

    j_labels, j_probs = np.asarray(j_labels), np.asarray(j_probs)
    t_labels = t_labels.numpy()
    top2 = np.sort(j_probs, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < TIE_GAP
    differ = t_labels != j_labels
    print(f"near-ties (gap < {TIE_GAP}): {int(near_tie.sum())} of "
          f"{len(cloud)}; differing labels: {int(differ.sum())}")
    assert not np.any(differ & ~near_tie)
    assert differ.sum() <= 0.001 * len(cloud)
    np.testing.assert_allclose(t_probs.numpy(), j_probs, atol=1e-3)
    return t_diag


def _held_out(labels, predicted):
    rows = np.random.RandomState(0).permutation(len(labels))[:SAMPLE]
    held = np.ones(len(labels), bool)
    held[rows] = False
    return float((predicted[held] == labels[held]).mean())


@pytest.mark.parametrize("n_served,overflows", [(N, False), (8192, True)])
def test_served_labels_match_reference_classifier(fitted, n_served,
                                                  overflows):
    cloud, _, ref = fitted
    port = twl.make_bench_model(cloud, device="cpu")
    port.install_classifier(_carried(ref.classifier), cloud)

    # the host sizing of the serving program is the reference's
    (_, jspecs), (_, tspecs) = ref._spec_cache, port._spec_cache
    for j, t in zip(jspecs, tspecs):
        assert t[0].__dict__ == j[0].__dict__
        assert t[1].__dict__ == j[1].__dict__
        assert (t[2], t[4], t[5]) == (j[2], j[4], j[5])

    other, _ = twl.make_bench_cloud(n_served, seed=1)
    t_diag = _serve_both(ref, port, other)
    assert any(int(t_diag[key]) for key in COUNTERS) == overflows


def test_unbounded_float32_serving_matches_reference(fitted):
    _, _, fit_ref = fitted
    scaleset = [(e, (r,)) for e, r in zip(twl.BENCH_EDGES, twl.BENCH_RADII)]
    ref = jpl.GeometryClassifier(scaleset, kind="minimal",
                                 transfer_dtype="float32", backend="packed")
    ref.classifier = fit_ref.classifier
    port = tpl.GeometryClassifier(scaleset, kind="minimal",
                                  transfer_dtype="float32", device="cpu")
    port.classifier = _carried(fit_ref.classifier)
    other, _ = twl.make_bench_cloud(N, seed=2)
    staged = port.stage(other)
    assert staged["dequant"] is None
    assert staged["query"].dtype == torch.float32
    t_diag = _serve_both(ref, port, other)
    assert not any(int(t_diag[key]) for key in COUNTERS)


def test_self_search_and_entry_chunks_serve(fitted, monkeypatch):
    cloud, labels, ref = fitted
    port = twl.make_bench_model(cloud, device="cpu")
    port.install_classifier(_carried(ref.classifier), cloud)
    # self-search spelled out is self-search: one quantized upload
    staged = port.stage(cloud, search=cloud)
    assert staged["search"] is staged["query"]
    assert staged["dequant"] is not None
    whole = port.predict_staged(staged)
    # entry chunks, which the port once refused, serve the same labels
    monkeypatch.setattr(tpl, "_CHUNK_SLOTS", 1024)
    fresh = twl.make_bench_model(cloud, device="cpu")
    fresh.install_classifier(_carried(ref.classifier), cloud)
    spec = fresh._spec_cache[1][0][1]
    assert tpl._serving_entry_chunk(spec.e_cap, spec.q_cap, None) \
        == 256 < spec.e_cap
    chunked, diag = fresh.predict_staged(fresh.stage(cloud), with_diag=True)
    assert not any(int(diag[key]) for key in COUNTERS)
    assert torch.equal(chunked, whole)


def test_port_fit_accuracy_matches_reference_fit(fitted):
    cloud, labels, ref = fitted
    port = twl.make_bench_model(cloud, device="cpu")
    port.fit(cloud, labels, sample=SAMPLE)
    acc_port = _held_out(labels, port.predict(cloud))
    acc_ref = _held_out(labels, ref.predict(cloud))
    print(f"held-out accuracy: port {acc_port:.4f}, reference "
          f"{acc_ref:.4f}")
    assert acc_port > 0.8
    assert abs(acc_port - acc_ref) <= 0.03
