"""
Designated-search serving of the port against the reference: the drive
matrix's designated cells (``tests/test_drive_matrix.py``: ``minimal``
under uint16 and float32 uploads, ``vector``, ``sazo``) on its scene,
with a jittered copy of the cloud as the search map.

* Fit against the map, then serve: the fit features' labels equal the
  labels served through a ``stage_search`` handle, and those equal the
  per-cloud ``stage(cloud, search=map)`` labels bit for bit; the
  handle's and the step's counters are 0.
* The reference's fitted classifier, installed into the port
  (``install_classifier(..., search=map)``) and served against the
  port's handle, gives the reference's handle-served labels (except at
  reference near-ties).
* ``predict_stream`` equals the sequential ``predict_staged`` loop with
  and without a handle.
* The cases without a staged search path raise with their messages.
"""

import numpy as np
import pytest
import torch

from nimrud_tpu.pipeline import GeometryClassifier as RefClassifier

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.pipeline import COUNTERS

SCALESET = [(0.2, (0.8, 0.4))]
CELLS = [("minimal", "uint16"), ("minimal", "float32"),
         ("vector", "uint16"), ("sazo", "float32")]
TIE_GAP = 1e-4


def _scene(per=400, seed=21):
    """The drive matrix's scene (a sheet, a line, a blob), its designated
    map (the cloud jittered by 2 cm) and, for ``vector``, the map's two
    attribute columns (a class-correlated one and noise)."""
    rng = np.random.default_rng(seed)
    sheet = rng.random((per, 3)) * [8, 8, 0.02]
    line = rng.random((per, 3)) * [0.02, 0.02, 8] + [10, 4, 0]
    blob = rng.normal([16, 4, 4], 1.0, (per, 3))
    cloud = np.vstack([sheet, line, blob]).astype(np.float32)
    labels = np.repeat([0, 1, 2], per).astype(np.int32)
    search = (cloud + rng.normal(0, 0.02, cloud.shape)).astype(np.float32)
    attrs = np.stack([labels + 0.05 * rng.standard_normal(len(labels)),
                      rng.random(len(labels))], axis=1).astype(np.float32)
    return cloud, labels, search, attrs


def _config(kind, dtype, cloud, search):
    # bounds padding no multiple of the 0.2 m voxel edge
    lo = np.minimum(cloud.min(0), search.min(0)) - 0.37
    hi = np.maximum(cloud.max(0), search.max(0)) + 0.53
    return dict(kind=kind, classifier="linear",
                classifier_kwargs={"epochs": 10, "seed": 0},
                transfer_dtype=dtype, backend="packed", bounds=(lo, hi),
                trim_entries=True)


def _model(kind="minimal", dtype="float32", **overrides):
    cloud, labels, search, attrs = _scene()
    config = {**_config(kind, dtype, cloud, search), **overrides}
    model = tpl.GeometryClassifier(SCALESET, device="cpu", **config)
    return model, cloud, labels, search, attrs if kind == "vector" else None


def _zero(diag):
    return {key: int(value) for key, value in diag.items()} \
        == dict.fromkeys(diag, 0)


@pytest.mark.parametrize("kind,dtype", CELLS)
def test_designated_fit_serve_and_staged_equal_distinct(kind, dtype):
    model, cloud, labels, search, attrs = _model(kind, dtype)
    model.fit(cloud, labels, search=search, attributes=attrs)
    feats = model.extract_device(cloud, search, attrs)
    from_fit = model.classifier.proba_device(feats).argmax(1)

    handle = model.stage_search(search, attributes=attrs)
    assert model.search_overflow(handle) == {"vox_dropped": 0,
                                             "interp_dropped": 0}
    staged = model.stage(cloud, staged_search=handle)
    # the query uploads as float32 under either transfer dtype
    assert staged["dequant"] is None
    assert staged["query"].dtype == torch.float32
    served, diag = model.predict_staged(staged, with_diag=True)
    assert set(diag) == set(COUNTERS) and _zero(diag), diag

    distinct = model.stage(cloud, search=search, attributes=attrs)
    assert distinct["dequant"] is None
    assert distinct["search"] is not distinct["query"]
    labels_d, diag_d = model.predict_staged(distinct, with_diag=True)
    assert _zero(diag_d), diag_d
    assert torch.equal(served, labels_d)
    assert torch.equal(served.to(torch.int64), from_fit)
    assert torch.equal(model.predict_device(cloud, search, attrs), served)


def _carried(ref_classifier):
    return SoftmaxClassifier.from_state(
        np.asarray(ref_classifier.params["w"]),
        np.asarray(ref_classifier.params["b"]),
        np.asarray(ref_classifier.mean_),
        np.asarray(ref_classifier.scale_), device="cpu")


@pytest.mark.parametrize("kind,dtype", CELLS)
def test_designated_labels_match_reference_classifier(kind, dtype):
    cloud, labels, search, attrs = _scene()
    attrs = attrs if kind == "vector" else None
    config = _config(kind, dtype, cloud, search)
    ref = RefClassifier(SCALESET, **config)
    ref.fit(cloud, labels, search=search, attributes=attrs)
    ref_handle = ref.stage_search(search, attributes=attrs)
    ref_labels, ref_probs = ref.predict_staged(
        ref.stage(cloud, staged_search=ref_handle), with_proba=True)
    ref_labels, ref_probs = np.asarray(ref_labels), np.asarray(ref_probs)

    port = tpl.GeometryClassifier(SCALESET, device="cpu", **config)
    port.install_classifier(_carried(ref.classifier), cloud,
                            attributes=attrs, search=search)
    # the serving specs are the reference's
    (_, ref_specs), (_, port_specs) = ref._spec_cache, port._spec_cache
    for j, t in zip(ref_specs, port_specs):
        assert (t[2], t[4], t[5]) == (j[2], j[4], j[5])
    handle = port.stage_search(search, attributes=attrs)
    got = port.predict_staged(port.stage(cloud, staged_search=handle))
    top2 = np.sort(ref_probs, axis=1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < TIE_GAP
    differ = got.numpy() != ref_labels
    print(f"{kind} {dtype}: {int(differ.sum())} labels differ, "
          f"{int(near_tie.sum())} reference near-ties")
    assert not np.any(differ & ~near_tie)


def test_predict_stream_equals_sequential_steps():
    model, cloud, labels, search, _ = _model("minimal", "uint16")
    model.fit(cloud, labels, search=search)
    rng = np.random.default_rng(7)
    clouds = [cloud] + [(cloud + rng.normal(0, 0.01, cloud.shape))
                        .astype(np.float32) for _ in range(2)]
    handle = model.stage_search(search)
    streamed = list(model.predict_stream(clouds, staged_search=handle))
    assert len(streamed) == 3
    for c, got in zip(clouds, streamed):
        want = model.predict_staged(model.stage(c, staged_search=handle))
        assert torch.equal(got, want)
        assert torch.equal(got, model.predict_staged(
            model.stage(c, search=search)))
    # without a handle each cloud is served against itself
    for c, got in zip(clouds, model.predict_stream(iter(clouds))):
        assert torch.equal(got, model.predict_staged(model.stage(c)))


def test_designated_paths_raise_where_there_is_none():
    model, cloud, labels, search, _ = _model()
    handle = model.stage_search(search)
    other, *_ = _model(tile_m=2)
    with pytest.raises(ValueError, match="different model configuration"):
        other.stage(cloud, staged_search=handle)
    with pytest.raises(ValueError, match="come from the stage_search"):
        model.stage(cloud, search=search, staged_search=handle)
    unbounded, *_ = _model(bounds=None)
    with pytest.raises(ValueError, match="fixed bounds"):
        unbounded.stage_search(search)
    span, *_ = _model(backend="pallas")
    with pytest.raises(ValueError, match="packed backend only"):
        span.stage_search(search)
    excl, *_ = _model(exclude_radius=0.1)
    with pytest.raises(ValueError, match="exclude_radius"):
        excl.stage_search(search)
    with pytest.raises(ValueError, match="exclude_radius"):
        next(excl.predict_stream([cloud], staged_search=handle))
    vector, *_ = _model("vector")
    with pytest.raises(ValueError, match="at most 6 attribute columns"):
        vector.stage_search(search, attributes=np.ones((len(search), 7),
                                                       np.float32))
    with pytest.raises(ValueError, match="attributes"):
        vector.stage_search(search)
