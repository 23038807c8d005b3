"""
The geometry kinds on the port's packed path against the JAX package:
``make_bench_model(kind=...)`` on a scaled-down bench scene, the
reference's fitted classifier carried across (one reference fit a kind).

* Served: the serving specs, all five overflow counters and the labels
  equal the reference's, except at reference near-ties (top-two
  probability gap < 1e-4) and at points whose feature rows differ only
  where the layout leaves them to rounding or to an arbitrary sign
  (``layouts.reconcile``): the port's rows, reconciled with the
  reference's served rows, must lie within the cross-backend feature
  tolerance of them and classify to the reference's labels.  Here:
  ``geometric``, ``covariance`` and ``sazo`` (the kernel's sazo rows);
  ``oriented`` and ``eigen`` in ``test_torch_kinds_eigen.py``.
* ``sazo`` fit against serve on the port (the reference's
  ``tests/test_drive_matrix.py`` contract): the labels the fit features
  give equal the served labels under float32 uploads, and agree for at
  least 99.5% of points under uint16 uploads.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.ops import device_grid as jdg
from nimrud_tpu.ops import unique as juq
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.features import layouts
from nimrud_tpu_torch.pipeline import COUNTERS
from nimrud_tpu_torch.utils import workload as twl
from test_torch_pipeline import _carried

N = 6000          # fit and serving size
SAMPLE = 3000
TIE_GAP = 1e-4
FEATURE_ATOL = 1e-3   # tests/test_pallas_kernel.py's cross-backend
                      # feature tolerance
VECTOR_ATOL = 1e-2    # eigenvector components where the eigenvalue gap
                      # is at least layouts.RECONCILE_GAP


def _reference_served_features(ref, staged):
    """The feature rows the reference's packed serving step classifies,
    in caller order: its serving program's band prep and
    ``fused_extract_packed_multi`` without the classifier."""
    specs = staged["specs"]
    n = staged["n_query"]
    dq = staged["dequant"]
    query = jnp.asarray(staged["query"]).astype(jnp.float32) * dq[3] + dq[:3]
    valid = jnp.arange(staged["q_bucket"]) < n
    searches, masks = [], []
    for band in specs:
        centers, _, mask = juq.unique_voxels(query, band[0], valid=valid,
                                             tile_spec=band[1])
        if band[4] is not None and band[4] < centers.shape[0]:
            centers, mask = centers[:band[4]], mask[:band[4]]
        searches.append(centers)
        masks.append(mask)
    pack = min((b[1] for b in specs), key=lambda s: s.tile_edge)
    return np.asarray(jdg.fused_extract_packed_multi(
        query, valid, tuple(searches), tuple(masks), pack,
        tuple(b[1] for b in specs), tuple(b[2] for b in specs), ref.kind,
        None, n, tuple(b[5] for b in specs), interpret=True,
        presorted=True))


def _port_served_features(port, staged):
    """The feature rows the port's serving step classifies, in caller
    order: the step run with ``classify_features`` as the identity."""
    classify = tpl.classify_features
    tpl.classify_features = lambda params, features: features
    try:
        return port.predict_staged(staged, with_proba=True)[1].numpy()
    finally:
        tpl.classify_features = classify


def check_kind_serving(kind):
    """Fit the reference on the bench scene, serve another cloud through
    it and through the port with its classifier; hold specs, counters
    and labels (module docstring).  Returns the report dict."""
    cloud, labels = twl.make_bench_cloud(N, seed=0)
    ref = jwl.make_bench_model(cloud, kind=kind)
    ref.fit(cloud, labels, sample=SAMPLE)
    port = twl.make_bench_model(cloud, kind=kind, device="cpu")
    assert port.kind == kind
    port.install_classifier(_carried(ref.classifier), cloud)
    (_, jspecs), (_, tspecs) = ref._spec_cache, port._spec_cache
    for j, t in zip(jspecs, tspecs):
        assert t[0].__dict__ == j[0].__dict__
        assert t[1].__dict__ == j[1].__dict__
        assert (t[2], t[4], t[5]) == (j[2], j[4], j[5])

    other, truth = twl.make_bench_cloud(N, seed=1)
    j_staged, t_staged = ref.stage(other), port.stage(other)
    j_labels, j_probs, j_diag = ref.predict_staged(
        j_staged, with_proba=True, with_diag=True)
    t_labels, t_diag = port.predict_staged(t_staged, with_diag=True)
    for key in COUNTERS:
        assert int(t_diag[key]) == int(j_diag[key]) == 0, key
    j_labels, j_probs = np.asarray(j_labels), np.asarray(j_probs)
    t_labels = t_labels.numpy()
    top2 = np.sort(j_probs, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < TIE_GAP
    differ = t_labels != j_labels
    report = {"kind": kind, "differ": int(differ.sum()),
              "near_ties": int(near_tie.sum()),
              "accuracy": float((t_labels == truth).mean())}
    assert report["accuracy"] > 0.6
    if np.any(differ & ~near_tie):
        # the witness: the port's served rows, reconciled with the
        # reference's, lie within the feature tolerance and give its
        # labels
        j_feats = _reference_served_features(ref, j_staged)
        t_feats = _port_served_features(port, t_staged)[:N]
        rec, flipped, taken = layouts.reconcile(
            kind, torch.from_numpy(t_feats), torch.from_numpy(j_feats))
        rec = rec.numpy()
        width = layouts.LAYOUT_WIDTHS[kind]
        # density: the same division, which XLA may turn into a product
        # with the reciprocal (one ulp)
        np.testing.assert_allclose(rec[:, 0::width], j_feats[:, 0::width],
                                   rtol=2.0 ** -22)
        vec = np.zeros(rec.shape[1], bool)
        if kind == "oriented":
            for base in range(0, rec.shape[1], width):
                vec[base + 4:base + 8] = True
        np.testing.assert_allclose(rec[:, ~vec], j_feats[:, ~vec],
                                   atol=FEATURE_ATOL, rtol=1e-5)
        np.testing.assert_allclose(rec[:, vec], j_feats[:, vec],
                                   atol=VECTOR_ATOL)
        rec_labels = port.classifier.proba_device(
            torch.from_numpy(rec)).argmax(1).numpy()
        assert not np.any((rec_labels != j_labels) & ~near_tie)
        report.update({"sign_flipped_rows": int(flipped.sum()),
                       "rounding_bound_rows": int(taken.sum()),
                       "differ_witnessed": int((differ & ~near_tie).sum())})
    print(report)
    return report


@pytest.mark.parametrize("kind", ["geometric", "covariance", "sazo"])
def test_served_labels_match_reference_classifier(kind):
    report = check_kind_serving(kind)
    assert report["differ"] <= 0.001 * N


def _drive_scene(per=400, seed=21):
    """tests/test_drive_matrix.py's scene: a sheet, a line, a blob."""
    rng = np.random.default_rng(seed)
    sheet = rng.random((per, 3)) * [8, 8, 0.02]
    line = rng.random((per, 3)) * [0.02, 0.02, 8] + [10, 4, 0]
    blob = rng.normal([16, 4, 4], 1.0, (per, 3))
    cloud = np.vstack([sheet, line, blob]).astype(np.float32)
    return cloud, np.repeat([0, 1, 2], per).astype(np.int32)


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint16"])
def test_sazo_fit_matches_serve(transfer_dtype):
    cloud, labels = _drive_scene()
    # bounds padding not a multiple of the voxel edge (the reference's
    # anchor-skew regime)
    lo, hi = cloud.min(0) - 0.37, cloud.max(0) + 0.53
    model = tpl.GeometryClassifier(
        [(0.2, (0.8, 0.4))], kind="sazo", classifier="linear",
        classifier_kwargs={"epochs": 10, "seed": 0},
        transfer_dtype=transfer_dtype, backend="packed", bounds=(lo, hi),
        trim_entries=True, device="cpu")
    model.fit(cloud, labels)
    feats = model.extract_device(cloud)
    assert feats.shape == (len(cloud), 2 * 5)
    from_fit = model.classifier.proba_device(feats).argmax(1).numpy()
    served, diag = model.predict_staged(model.stage(cloud), with_diag=True)
    assert all(int(v) == 0 for v in diag.values()), diag
    served = served.numpy()
    agree = float((from_fit == served).mean())
    print(f"sazo fit vs serve, {transfer_dtype}: agreement {agree}")
    if transfer_dtype == "uint16":
        assert agree >= 0.995
    else:
        np.testing.assert_array_equal(from_fit, served)
