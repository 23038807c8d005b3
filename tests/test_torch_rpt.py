"""
The random-projection-tree ensemble (``learning/rpt.py``) against the
JAX package, on the Gaussian feature rows of ``torch_rpt_cases.py``.

* Host fit: the flattened tables equal the reference's bit for bit (3
  seeds, ``wmax``, a tuple ``impurity``, ``prune_chains=False``); these
  fits reach the depth cap through jitter chains, so they carry the
  sparse tables only.  The dense packing of ``_flatten`` on the same
  rule dicts cut to depth 5 (single-child branches, so dead branches to
  fill) equals the reference's.
* The walks on the reference's tables (the sparse ``tags`` walk on a
  host fit, the dense walk on a device fit): probabilities within 1e-6
  of the reference's, and labels equal, except at rows witnessed by
  ``checks.walk_witness`` (a node of the row's float64 path within
  the f32 rounding bound of a 12-term projection of its split) or
  whose top-two probability gap is at most 1e-6.  The per-tree dense
  walk equals the forest walk bit for bit.
* Device fit: held-out accuracy within 0.03 of the reference's device
  fit on the same features (the draws differ: ``torch.Generator``
  against ``jax.random``), on rows of half the noise: on the module's
  overlapping classes one fit's accuracy moves by 0.03 from seed to
  seed (20 seeds: port 0.779 +- 0.033, reference 0.791 +- 0.032), at
  half the noise by 0.02 about 0.94 (10 seeds, both).  Dead branches
  filled from the parent, the depth cap's leaves ``inf``, a refit
  bit-equal.
* Device fit on small subsets (2000 rows and 8 trees, 3000 rows and 10
  trees, depth 10, the module's full noise): over five seeds (data and
  fit), the port's mean held-out accuracy lies within the seeds' spread
  (the larger standard deviation of the two packages) of the
  reference's.  The two grow trees by the same rules; only the draws
  differ (over 24 fit seeds on one draw at 3000 rows: port 0.760 +-
  0.041, reference 0.768 +- 0.039).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from nimrud_tpu.learning import rpt as jrpt

from nimrud_tpu_torch.utils import checks
from nimrud_tpu_torch.learning import rpt as trpt
from nimrud_tpu_torch.ops.kernels import forest_walk
from nimrud_tpu_torch.learning.classifiers import param_classifier
from torch_rpt_cases import forest_data, numpy_tables
from torch_thread_cases import one_torch_thread  # noqa: F401

N_TRAIN = 3000
N_TEST = 4000
GAP = 1e-6


@pytest.fixture(scope="module")
def data():
    return forest_data(N_TRAIN, 0), forest_data(N_TEST, 1)


@pytest.mark.parametrize("kwargs", [
    {"seed": 0}, {"seed": 1}, {"seed": 2}, {"seed": 0, "d_func": "wmax"},
    {"seed": 3, "impurity": (0.1, 0.3)}, {"seed": 0, "prune_chains": False}])
def test_host_fit_tables_equal_reference(data, kwargs):
    (x, y), _ = data
    ref = jrpt.RPTEnsemble(**kwargs).fit(x, y)
    port = trpt.RPTEnsemble(device="cpu", **kwargs).fit(x, y)
    want = numpy_tables(ref._tables)
    got = {k: v.numpy() for k, v in port._tables.items()}
    assert set(got) == set(want) == set(trpt.SPARSE_KEYS)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert port.max_depth_ == ref.max_depth_ > 14
    assert (port.numlabs, port.dim) == (ref.numlabs, ref.dim)


def test_dense_packing_equals_reference(data):
    (x, y), _ = data
    ref = jrpt.RPTEnsemble(seed=0, prune_chains=False).fit(x, y)
    cut = []
    for rules in ref.trees_:
        kept = {c: r for c, r in rules.items() if c.bit_length() <= 6}
        for c in kept:
            if c.bit_length() == 6:
                kept[c] = (jrpt._LEAF,) + kept[c][1:]
        cut.append(kept)
    assert any(len([c for c in (2 * k, 2 * k + 1) if c in rules]) == 1
               for rules in cut for k in rules)      # dead branches
    port = trpt.RPTEnsemble(device="cpu")
    port.dim, port.numlabs = ref.dim, ref.numlabs
    got = port._flatten(cut)
    want = numpy_tables(ref._flatten(cut))
    assert port.max_depth_ == ref.max_depth_ == 5
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _check_walk(tables, max_depth, d_func, x):
    """The port's walk on ``tables`` (NumPy) against the reference's
    ``_ensemble_proba`` (module docstring)."""
    want = np.asarray(jrpt._ensemble_proba(
        jrpt.add_blocked_tables({k: jnp.asarray(v)
                                 for k, v in tables.items()}),
        jnp.asarray(x), max_depth, d_func))
    got = trpt.ensemble_proba({k: torch.from_numpy(v)
                               for k, v in tables.items()},
                              torch.from_numpy(x), max_depth, d_func).numpy()
    assert got.shape == want.shape
    top2 = np.sort(want, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= GAP
    off = np.abs(got - want).max(1) > GAP
    differ = got.argmax(1) != want.argmax(1)
    rows = np.nonzero(off | differ)[0]
    witnessed = np.zeros(len(x), bool)
    witnessed[rows] = checks.walk_witness(
        {k: torch.from_numpy(v) for k, v in tables.items()},
        torch.from_numpy(x), max_depth, torch.from_numpy(rows)).numpy()
    print(f"{len(rows)} rows off by more than {GAP} or relabeled, "
          f"{int(witnessed.sum())} witnessed, {int(differ.sum())} labels "
          "differ")
    assert not np.any(off & ~witnessed)
    assert not np.any(differ & ~witnessed & ~tie)
    assert differ.sum() <= 0.001 * len(x)
    return got


@pytest.mark.parametrize("d_func", ["wmean", "wmax"])
def test_sparse_walk_matches_reference(data, d_func):
    (x, y), (xt, _) = data
    ref = jrpt.RPTEnsemble(seed=0, d_func=d_func).fit(x, y)
    assert "dense_splits" not in ref._tables
    _check_walk(numpy_tables(ref._tables), ref.max_depth_, d_func, xt)


@pytest.fixture(scope="module")
def device_fit(data):
    (x, y), _ = data
    ref = jrpt.RPTEnsemble(seed=0)
    ref.fit_device(jnp.asarray(x), y, n_classes=3)
    return ref


def test_dense_walks_match_reference(data, device_fit):
    _, (xt, _) = data
    tables = numpy_tables(device_fit._tables)
    assert set(tables) == set(trpt.DENSE_KEYS)
    _check_walk(tables, device_fit.max_depth_, "wmean", xt)
    # the per-tree walk is the forest walk's per-tree form
    t = {k: torch.from_numpy(v) for k, v in tables.items()}
    gini, props = forest_walk.walk_dense_plain(t, torch.from_numpy(xt), 14)
    for tree in range(gini.shape[0]):
        g, p = trpt._walk_one_tree_dense(
            *(t[k][tree] for k in trpt.DENSE_KEYS), torch.from_numpy(xt), 14)
        assert torch.equal(g, gini[tree]) and torch.equal(p, props[tree])


def test_walk_witness_holds_only_rows_near_a_split(data, device_fit):
    _, (xt, _) = data
    t = {k: torch.from_numpy(v)
         for k, v in numpy_tables(device_fit._tables).items()}
    x = torch.from_numpy(xt[:200])
    far = checks.walk_witness(t, x, 14, torch.arange(200))
    assert far.sum() <= 2
    # a row on the root's split plane of tree 0: its projection is the
    # split within the f32 rounding bound
    vec, split = t["dense_vecs"][0, 1], t["dense_splits"][0, 1]
    on = (x[0] + (split - x[0] @ vec) * vec)[None]
    assert bool(checks.walk_witness(t, on, 14, torch.arange(1))[0])


def test_device_fit_accuracy_matches_reference():
    (x, y), (xt, yt) = forest_data(N_TRAIN, 0, 0.5), \
        forest_data(N_TEST, 1, 0.5)
    port = param_classifier("rpte", seed=0)
    port.fit_device(torch.from_numpy(x), y, n_classes=3)
    assert port.device == torch.device("cpu")
    ref = jrpt.RPTEnsemble(seed=0)
    ref.fit_device(jnp.asarray(x), y, n_classes=3)
    acc_port = float((port.predict(xt) == yt).mean())
    acc_ref = float((ref.predict(xt) == yt).mean())
    print(f"held-out accuracy: port {acc_port:.4f}, reference {acc_ref:.4f}")
    assert acc_port > 0.9
    assert abs(acc_port - acc_ref) <= 0.03

    t = port._tables
    size = 1 << 16
    assert port.max_depth_ == 14 and t["dense_splits"].shape == (10, size)
    # every code's statistics filled (dead branches from the parent),
    # the depth cap's nodes and the code space past it leaves
    level = torch.floor(torch.log2(torch.arange(1, size).double()))
    np.testing.assert_allclose(t["dense_props"][:, 1:].sum(-1).numpy(), 1.0,
                               atol=1e-6)
    assert torch.isinf(t["dense_splits"][:, 1:][:, level >= 14]).all()
    assert torch.isfinite(t["dense_splits"][:, 1]).all()
    assert ((t["dense_ginis"] >= 0) & (t["dense_ginis"] <= 1)).all()
    again = param_classifier("rpte", seed=0)
    again.fit_device(torch.from_numpy(x), y, n_classes=3)
    for key in trpt.DENSE_KEYS:
        assert torch.equal(again._tables[key], t[key]), key


@pytest.mark.parametrize("n_rows,n_trees", [(2000, 8), (3000, 10)])
def test_device_fit_gap_on_small_subsets_is_the_draws(n_rows, n_trees):
    port_acc, ref_acc = [], []
    for seed in range(5):
        (x, y), (xt, yt) = forest_data(n_rows, seed), \
            forest_data(N_TEST // 2, 100 + seed)
        port = trpt.RPTEnsemble(n_estimators=n_trees, seed=seed,
                                device="cpu")
        port.fit_device(torch.from_numpy(x), y, n_classes=3, depth=10)
        ref = jrpt.RPTEnsemble(n_estimators=n_trees, seed=seed)
        ref.fit_device(jnp.asarray(x), y, n_classes=3, depth=10)
        port_acc.append(float((port.predict(xt) == yt).mean()))
        ref_acc.append(float((ref.predict(xt) == yt).mean()))
    gap = np.mean(ref_acc) - np.mean(port_acc)
    spread = max(np.std(port_acc), np.std(ref_acc))
    print(f"held-out accuracy over 5 seeds: port {np.mean(port_acc):.4f} "
          f"+- {np.std(port_acc):.4f}, reference {np.mean(ref_acc):.4f} +- "
          f"{np.std(ref_acc):.4f}")
    assert min(port_acc) > 0.6
    assert abs(gap) <= spread


def test_from_tables_carries_the_reference_forest(data, device_fit):
    _, (xt, _) = data
    port = trpt.RPTEnsemble.from_tables(
        numpy_tables(device_fit._tables), device_fit.max_depth_, "wmean",
        "cpu")
    assert (port.n_estimators, port.numlabs, port.dim) == (10, 3, 12)
    assert "dense_blk" not in port._tables
    # the walk stops one past the deepest split, with the full walk's
    # results
    assert port.walk_depth_ < port.max_depth_ == 14
    x = torch.from_numpy(xt)
    assert torch.equal(
        trpt.ensemble_proba(port._tables, x, port.walk_depth_, "wmean"),
        trpt.ensemble_proba(port._tables, x, port.max_depth_, "wmean"))
    np.testing.assert_allclose(port.predict_proba(xt),
                               np.asarray(device_fit.predict_proba(xt)),
                               atol=GAP)
    with pytest.raises(ValueError, match="no forest tables"):
        trpt.RPTEnsemble.from_tables({"dense_blk": np.zeros(3)}, 1,
                                     "wmean", "cpu")


def test_rpt_checks_its_inputs(data):
    (x, y), _ = data
    with pytest.raises(ValueError, match="cannot build"):
        trpt.RPTEnsemble(n_estimators=5000, device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="do not match"):
        trpt.RPTEnsemble(device="cpu").fit(x, y[:-1])
    clf = trpt.RPTEnsemble(device="cpu", n_estimators=3, seed=0).fit(x, y)
    with pytest.raises(ValueError, match="dimensions"):
        clf.predict_proba(x[:, :5])
    with pytest.raises(ValueError, match="decision function"):
        trpt.ensemble_proba(clf._tables, torch.from_numpy(x), clf.max_depth_,
                            "mean")
    clf.set_params(d_func="wmax", onepass=7, bogus=1)
    assert clf.d_func == "wmax" and clf.onepass == 7
    labels, proba = clf.predict_and_proba(x[:20])
    np.testing.assert_array_equal(labels, proba.argmax(1))
