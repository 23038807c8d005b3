"""
The span serving backend end to end (``backend="pallas"``): the bench
model served by the port against the JAX package.

The scene is the bench scene drawn on a 20 m square site (x and y of
``make_bench_cloud`` scaled by 0.2): the bands, the layout, the uint16
uploads, the fixed bounds and the trimmed specs are the bench model's,
and the reference's interpret-mode span program compiles in seconds.

* Carried across: the reference's fitted span model's classifier,
  installed into the port's span model; the serving specs, all five
  overflow counters and the labels (except at reference near-ties)
  equal the reference's.
* Voxel overflow: a model trimmed on a cloud packed into a corner of a
  fixed site serves a cloud spread over the site; the reference and the
  port count the same dropped voxels.
* Fitted by the port itself: held-out accuracy > 0.8.
"""

import numpy as np
import pytest

from nimrud_tpu import pipeline as jpl
from nimrud_tpu.utils import workload as jwl

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.pipeline import COUNTERS
from nimrud_tpu_torch.utils import workload as twl

from test_torch_pipeline import _carried, _held_out, _serve_both

N = 6000
SAMPLE = 3000
SITE = np.float32([0.2, 0.2, 1.0])


def _scene(n, seed):
    cloud, labels = twl.make_bench_cloud(n, seed=seed)
    return cloud * SITE, labels


@pytest.fixture(scope="module")
def fitted():
    cloud, labels = _scene(N, seed=0)
    ref = jwl.make_bench_model(cloud, backend="pallas")
    ref.fit(cloud, labels, sample=SAMPLE)
    return cloud, labels, ref


def test_make_bench_model_takes_the_backend():
    cloud, _ = _scene(2000, seed=0)
    assert twl.make_bench_model(cloud, device="cpu").backend == "packed"
    model = twl.make_bench_model(cloud, backend="pallas", device="cpu")
    assert model.backend == "pallas"
    assert model.transfer_dtype == "uint16" and model.trim_entries
    xla = twl.make_bench_model(cloud, backend="xla", device="cpu")
    assert xla.backend == "xla" and xla.transfer_dtype == "uint16"
    with pytest.raises(ValueError):
        twl.make_bench_model(cloud, backend="ragged", device="cpu")


def test_served_labels_match_reference_classifier(fitted):
    cloud, _, ref = fitted
    port = twl.make_bench_model(cloud, backend="pallas", device="cpu")
    port.install_classifier(_carried(ref.classifier), cloud)

    # the host sizing of the span serving program is the reference's
    (_, jspecs), (_, tspecs) = ref._spec_cache, port._spec_cache
    for j, t in zip(jspecs, tspecs):
        assert t[0].__dict__ == j[0].__dict__
        assert t[1].__dict__ == j[1].__dict__
        assert (t[2], t[3], t[4], t[5]) == (j[2], j[3], j[4], j[5])
        assert t[1].q_cap == 256 and t[4] is not None and t[5] is None

    other, _ = _scene(N, seed=1)
    t_diag = _serve_both(ref, port, other)
    assert not any(int(t_diag[key]) for key in COUNTERS)


def test_voxel_overflow_is_counted_like_reference():
    # fit cloud: points packed into a 1 m corner of a 12 m site (few
    # voxels -> the smallest v_cap); serving cloud: as many points
    # spread over the site (more voxels than v_cap, same size bucket)
    rng = np.random.default_rng(7)
    n = 24000
    corner = (rng.random((n, 3)) * [1, 1, 3]).astype(np.float32)
    labels = (corner[:, 2] > 1.5).astype(np.int32)
    bounds = (np.zeros(3, np.float32), np.float32([12, 12, 3]))
    kw = dict(kind="minimal", classifier="linear",
              classifier_kwargs={"epochs": 2, "seed": 0}, bounds=bounds,
              trim_entries=True, backend="pallas")
    ref = jpl.GeometryClassifier([(0.25, (0.5,))], **kw)
    ref.fit(corner, labels, sample=2000)
    port = tpl.GeometryClassifier([(0.25, (0.5,))], device="cpu", **kw)
    port.install_classifier(_carried(ref.classifier), corner)
    assert port._spec_cache[1][0][4] == ref._spec_cache[1][0][4] == 16384

    spread = (rng.random((n, 3)) * [12, 12, 3]).astype(np.float32)
    t_diag = _serve_both(ref, port, spread)
    assert int(t_diag["vox_dropped"]) > 0


def test_port_fit_accuracy(fitted):
    cloud, labels, _ = fitted
    port = twl.make_bench_model(cloud, backend="pallas", device="cpu")
    port.fit(cloud, labels, sample=SAMPLE)
    acc = _held_out(labels, port.predict(cloud))
    print(f"held-out accuracy of the port's span model: {acc:.4f}")
    assert acc > 0.8
