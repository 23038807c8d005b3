"""The reference's layouts, found by the configuration's ``kind``
(``reference/layouts/<kind>.py``): ``minimal`` through the lookup gives
the features of its moment block called band by band, bit for bit, in
float64 and in the TF32 control; a kind without a file raises, naming
the files there; the ``vector`` layout on a hand-made scene gives the
hand-computed means, with an empty neighbourhood, a radius tie and an
interp tie."""

import numpy as np
import pytest
import torch

from perfbench.core import scene
from perfbench.reference import features as rfeat
from perfbench.reference.layouts import minimal, vector

LO = np.zeros(3, np.float32)
HI = np.array([20.0, 20.4, 9.0], np.float32)
BANDS = [(0.25, 0.5), (0.5, 1.0), (1.0, 2.0)]


@pytest.mark.parametrize("precision", ["float64", "tf32"])
def test_minimal_by_the_lookup_is_its_moment_block(precision):
    cloud = torch.from_numpy(scene.bench_cloud(6000, 11, 0.2)[0])
    sc = rfeat.Scene(cloud, None, BANDS, LO, HI, True, kind="minimal")
    assert sc.layout is minimal
    rows = torch.arange(0, 6000, 23)
    feats, owner = sc.features(rows, precision)
    q = sc.query[rows]
    parts = [rfeat.neighbourhood(g, q, r)
             for g, (_, r) in zip(sc.grids, sc.bands)]
    # the rows without a radius tie: their feature row is their own
    plain = ~torch.stack([p[3].any(1) for p in parts]).any(0)
    assert int(plain.sum()) > 200
    frame = sc._frames(q) if precision != "float64" else None
    old = torch.cat([minimal.moments_block(c, q, inside, precision, frame)
                     for c, _, inside, _, _ in parts], 1)
    assert torch.equal(feats[:len(rows)][plain], old[plain])
    assert torch.equal(owner[:len(rows)], torch.arange(len(rows)))


def test_a_kind_without_a_reference_file_raises():
    cloud = torch.from_numpy(scene.bench_cloud(2000, 1, 0.2)[0])
    with pytest.raises(ValueError, match="no layout 'not_a_layout'") as err:
        rfeat.Scene(cloud, None, BANDS, LO, HI, True, kind="not_a_layout")
    assert "minimal.py" in str(err.value) and "vector.py" in str(err.value)


# one band of edge 1 m and radius 1 m on a site from 0 to 8 m: the
# voxel centres sit at whole metres.  Search points and their two
# columns: voxel A (2, 2, 2) holds p0-p2; B (3, 2, 2) p3; C (6, 6, 6)
# p4-p6; D (6, 2, 2) p7 and p8.
SEARCH = [(1.9, 2.0, 2.0), (2.25, 2.0, 2.0), (3.0, 2.0, 2.0),
          (6.0, 6.0, 6.0), (6.2, 6.0, 6.0), (5.6, 6.0, 6.0),
          (6.0, 2.0, 2.4), (6.3, 2.0, 2.0)]
COLUMNS = [(1, 10), (3, 30), (5, 50), (7, 70), (9, 90), (2, 20), (4, 40),
           (10, 100)]
QUERIES = [(1.9, 2.0, 2.0), (2.25, 2.0, 2.0), (3.0, 2.0, 2.0),
           (6.0, 6.0, 6.0), (0.0, 6.0, 0.0), (6.1, 2.0, 2.0)]


def _hand_scene():
    return rfeat.Scene(torch.tensor(QUERIES, dtype=torch.float32),
                       torch.tensor(SEARCH, dtype=torch.float32),
                       [(1.0, 1.0)], np.zeros(3, np.float32),
                       np.full(3, 8.0, np.float32), False, kind="vector",
                       attributes=torch.tensor(COLUMNS, dtype=torch.float32))


def test_vector_by_hand():
    sc = _hand_scene()
    assert sc.layout is vector and sc.voxel_counts == [4]
    # the interp: A's ball holds p0, p1 and p2 (p2 at exactly 1 m: a
    # tie, decided in by the float64 test), B's p1 and p2, C's p4-p6,
    # D's p7 and p8
    a, b, c, d = (3.0, 30.0), (4.0, 40.0), (6.0, 60.0), (7.0, 70.0)
    feats, owner = sc.features(torch.arange(len(QUERIES)))
    got = {}
    for row, f in zip(owner.tolist(), feats.tolist()):
        got.setdefault(row, []).append(tuple(f))
    assert got[0] == [a]                      # A alone (B at 1.1 m)
    assert got[1] == [((a[0] + b[0]) / 2, (a[1] + b[1]) / 2)]
    # q2 sits at exactly 1 m from A: a radius tie, both ways enumerated
    assert sorted(got[2]) == sorted([b, ((a[0] + b[0]) / 2,
                                         (a[1] + b[1]) / 2)])
    assert got[3] == [c]
    assert got[4] == [(0.0, 0.0)]             # an empty neighbourhood
    assert got[5] == [d]
    assert sc.layout_work() == {"interp_pairs": [10],
                                "interp_ambiguous": [1], "attr_cols": [2]}
    # the centre with the tie, A, lies in q0's, q1's and q2's
    # neighbourhoods
    assert sc.tied_rows(torch.arange(len(QUERIES))) == 3
    assert sc.tied_rows(torch.tensor([3, 4, 5])) == 0


def test_vector_control_rounds_the_columns_to_tf32():
    sc = _hand_scene()
    rows = torch.arange(len(QUERIES))
    exact, _ = sc.features(rows)
    low, _ = sc.features(rows, "tf32")
    assert low.dtype == torch.float32
    assert torch.allclose(low.double(), exact, rtol=2 ** -10, atol=0)
    # a column TF32 cannot hold: 1 + 2**-12 rounds to 1
    fine = rfeat.Scene(torch.tensor(QUERIES[:1]), torch.tensor(SEARCH[:1]),
                       [(1.0, 1.0)], np.zeros(3, np.float32),
                       np.full(3, 8.0, np.float32), False, kind="vector",
                       attributes=torch.tensor([[1 + 2 ** -12]]))
    one = torch.tensor([0])
    assert float(fine.features(one)[0][0, 0]) == 1 + 2 ** -12
    assert float(fine.features(one, "tf32")[0][0, 0]) == 1.0


def test_vector_needs_attributes():
    sc = rfeat.Scene(torch.tensor(QUERIES), torch.tensor(SEARCH),
                     [(1.0, 1.0)], np.zeros(3, np.float32),
                     np.full(3, 8.0, np.float32), False, kind="vector")
    with pytest.raises(ValueError, match="attribute columns"):
        sc.features(torch.arange(2))
