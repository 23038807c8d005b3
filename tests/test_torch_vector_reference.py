"""
The port's ``vector`` serving path against the benchmark's plain
reference (``perfbench/reference``: ``layouts/vector.py`` and
``linear.py``, plain torch in float64, no JAX and no kernel of the
port), at A = 1, 4 and 6 attribute columns, on a small site on the CPU.

The port serves as the benchmark's ``site_vector`` deployment does:
``site_linear``'s three bands, the ``vector`` layout, the uint16 upload
against fixed site bounds, the packed backend, ``install_classifier``
with a seeded random linear state, ``stage(cloud, attributes=...)`` and
``predict_staged``.  The reference recomputes the class probabilities
at sampled points (``perfbench.core.compare.point_gaps``: the larger of
the probability difference and the served label's shortfall, the radius
ties enumerated).  Rows whose neighbourhood holds a voxel centre with
an interp tie (the reference's ``tied_rows`` test) are left out, as
the harness counts them apart.

The tolerances: the program sums in float32 where the reference sums in
float64.  A centre's interp mean and a query's mean of those centres
each round by a few float32 ulps of values under 1 (under 1e-6), and
the standardized features divide that by the state's scale (0.02 or
more here), so a logit moves by under 1e-4 and a probability by less:
the program reads at most 2.6e-6, median under 7e-8.  The TF32 control
(the reference with its sums rounded to TF32, 10 mantissa bits) reads
a largest gap of 4e-4 or more and a median of 1e-5 or more, and fails
both.
"""

import numpy as np
import pytest
import torch

from perfbench.core import compare, scene
from perfbench.generators import rescan_attributed
from perfbench.reference import features as rfeat
from perfbench.reference import linear as rlinear
from perfbench.reference.layouts import vector

from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.pipeline import GeometryClassifier

from torch_thread_cases import one_torch_thread  # noqa: F401

LO = np.zeros(3, np.float32)
HI = np.array([20.0, 20.4, 9.0], np.float32)      # site_vector's, x 0.2
BANDS = [(0.25, 0.5), (0.5, 1.0), (1.0, 2.0)]
N, ROWS = 12000, 1024
GAP_MAX, GAP_MEDIAN = 1e-5, 1e-6


def _tied(sc, rows):
    """The reference's ``tied_rows`` test as a mask of ``rows``."""
    q = sc.query[rows]
    touched = torch.zeros(q.shape[0], dtype=torch.bool)
    for interp, grid, (_, r) in zip(vector.interps(sc, "float64"),
                                    sc.grids, sc.bands):
        _, _, inside, amb, cells = rfeat.neighbourhood(grid, q, r)
        touched |= ((inside | amb) & interp.tied[interp.rows(cells)]).any(1)
    return touched


def _served(cloud, attrs, state):
    model = GeometryClassifier(
        [(e, (r,)) for e, r in BANDS], kind="vector",
        transfer_dtype="uint16", backend="packed", precision="highest",
        bounds=(LO, HI), trim_entries=True, device="cpu")
    clf = SoftmaxClassifier.from_state(state["w"], state["b"],
                                       state["mean"], state["scale"], "cpu")
    model.install_classifier(clf, cloud, attributes=attrs)
    staged = model.stage(cloud, attributes=attrs)
    labels, proba, diag = model.predict_staged(staged, with_proba=True,
                                               with_diag=True)
    assert all(int(v) == 0 for v in diag.values()), diag
    return labels, proba


@pytest.mark.parametrize("n_attr", [1, 4, 6])
def test_vector_serving_matches_the_plain_reference(n_attr):
    cloud, labels = scene.bench_cloud(N, 5, 0.2)
    attrs = rescan_attributed.columns(labels, n_attr,
                                      np.random.default_rng(n_attr))
    sc = rfeat.Scene(torch.from_numpy(cloud), None, BANDS, LO, HI, True,
                     kind="vector", attributes=torch.from_numpy(attrs))
    rows = torch.from_numpy(np.sort(np.random.default_rng(7).choice(
        N, ROWS, replace=False)))
    feats, owner = sc.features(rows)
    own = feats[:ROWS]
    assert own.shape[1] == len(BANDS) * n_attr
    rng = np.random.default_rng(11)
    state = {"w": rng.standard_normal((own.shape[1], 3)),
             "b": rng.standard_normal(3),
             "mean": own.mean(0).numpy(),
             "scale": (own.std(0) + 1e-6).numpy()}
    state = {k: np.asarray(v, np.float32) for k, v in state.items()}
    ref = rlinear.proba(state, feats)
    served_labels, served = _served(cloud, attrs, state)
    keep = ~_tied(sc, rows)
    assert int(keep.sum()) > 0.9 * ROWS
    gaps = compare.point_gaps(served[rows], served_labels[rows], ref, owner,
                              ROWS)[keep]
    assert float(gaps.max()) <= GAP_MAX
    assert float(gaps.median()) <= GAP_MEDIAN
    low = rlinear.proba(state, sc.features(rows, "tf32")[0][:ROWS], "tf32")
    control = compare.point_gaps(low, low.argmax(1), ref, owner, ROWS)[keep]
    assert float(control.max()) > GAP_MAX
    assert float(control.median()) > GAP_MEDIAN
