"""
The port's archive workflows (``nimrud_tpu_torch.workflows``) against
the JAX package's on the same inputs, on the CPU: the cases of
``tests/test_workflows.py``, each run through both packages on an
archive a package built from the same cloud.

* Features: names, indices and ``meta`` equal; densities equal and the
  other columns within the cross-backend feature tolerance
  (``test_torch_kinds_paths._compare``); the fused case (the port's
  packed twin against the reference's XLA bands) populations equal up to
  the candidates within the f32 rounding bound of r^2.
* Training on one feature asset stored in both archives: ``rpte`` (seed
  0) labels, confusions and resampler statistics equal; ``linear`` held
  by accuracy; the sklearn-backed options (seeded) equal.
* Datasets and exports: equal assets, ``meta`` and arrays.
"""

import os

import numpy as np
import pytest
import torch

from nimrud_tpu.archive import io as jio
from nimrud_tpu.archive.store import CloudArchive as JArchive
from nimrud_tpu.features import multiscale as jms
from nimrud_tpu.utils import memory as jmem
from nimrud_tpu.workflows import datasets as jds
from nimrud_tpu.workflows import features as jwf
from nimrud_tpu.workflows import train as jtr
from nimrud_tpu.workflows import viz as jviz

from nimrud_tpu_torch.archive import io as tio
from nimrud_tpu_torch.archive.store import NULL_LABEL
from nimrud_tpu_torch.archive.store import CloudArchive as TArchive
from nimrud_tpu_torch.features import multiscale as tms
from nimrud_tpu_torch.learning import rpt as trpt
from nimrud_tpu_torch.utils import memory as tmem
from nimrud_tpu_torch.workflows import datasets as tds
from nimrud_tpu_torch.workflows import features as twf
from nimrud_tpu_torch.workflows import train as ttr
from nimrud_tpu_torch.workflows import viz as tviz
from test_torch_kinds_paths import _compare
from torch_rpt_cases import numpy_tables
from torch_thread_cases import one_torch_thread  # noqa: F401

EPS32 = 2.0 ** -24
RPTE = {"seed": 0}


def _scene(n_per=400, with_nulls=False, seed=10):
    """Three geometrically distinct classes (the reference test's)."""
    rng = np.random.default_rng(seed)
    sheet = rng.random((n_per, 3)) * [6, 6, 0.02]
    line = rng.random((n_per, 3)) * [0.02, 0.02, 6] + [8, 3, 0]
    blob = rng.normal([14, 3, 3], 0.8, (n_per, 3))
    cloud = np.vstack([sheet, line, blob]).astype(np.float32)
    labels = np.repeat([0, 1, 2], n_per).astype(np.int32)
    if with_nulls:
        labels[rng.permutation(len(labels))[:len(labels) // 2]] = NULL_LABEL
    return cloud, labels


def _archives(tmp_path, cloud, labels):
    """The same labelled archive built by each package: (ref, port)."""
    out = []
    for cls, name in ((JArchive, "ref"), (TArchive, "port")):
        archive = cls.create(tmp_path / name, cloud)
        archive.add_asset("labels", labels, np.arange(len(labels)))
        out.append(archive)
    return out


def _both_features(ref, port, scaleset, kind, **kwargs):
    """``extract_features`` through both packages: the stored assets
    (data, index, meta) of each, names equal."""
    a = jwf.extract_features(ref, scaleset, kind, **kwargs)
    b = twf.extract_features(port, scaleset, kind, device="cpu", **kwargs)
    assert a == b
    got, want = port.get_asset(b), ref.get_asset(a)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    return got, want


def _same_asset(ref, port, name):
    for a, b in zip(ref.get_asset(name), port.get_asset(name)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a


def _shared(tmp_path, n_per=250, scaleset=((0.3, (1.0, 0.5)),)):
    """Both archives holding the reference's ``minimal`` features as the
    asset "f" (so fits see the same rows)."""
    cloud, labels = _scene(n_per)
    ref, port = _archives(tmp_path, cloud, labels)
    jwf.extract_features(ref, list(scaleset), "minimal", feature_name="f")
    data, index, meta = ref.get_asset("f")
    port.add_asset("f", data, index, meta=meta)
    return ref, port, cloud, labels


# -- features ----------------------------------------------------------------


def test_geometric_features_match_reference(tmp_path):
    cloud, labels = _scene()
    ref, port = _archives(tmp_path, cloud, labels)
    (got, index, meta), (want, _, _) = _both_features(
        ref, port, [(0.3, (1.0, 0.5))], "geometric")
    assert got.shape == (len(cloud), 8) and meta["kind"] == "geometric"
    _compare("geometric", got, want)


def test_vector_features_with_search_asset(tmp_path):
    cloud, labels = _scene()
    ref, port = _archives(tmp_path, cloud, labels)
    rng = np.random.default_rng(4)
    attrs = rng.random((len(cloud), 2)).astype(np.float32)
    subset = np.sort(rng.permutation(len(cloud))[:len(cloud) // 2])
    for archive in (ref, port):
        archive.add_asset("attrs", attrs, np.arange(len(cloud)))
        archive.add_asset("subset", np.zeros((subset.size, 1), np.float32),
                          subset)
        archive.add_asset("partial_attrs", attrs[:len(cloud) // 4],
                          np.arange(len(cloud) // 4))
    (got, _, meta), (want, _, _) = _both_features(
        ref, port, [(0.3, (1.0,))], "vector", attributes_asset="attrs",
        search_asset="subset")
    assert got.shape == (len(cloud), 2) and meta["kind"] == "vector"
    np.testing.assert_allclose(got, want, atol=2e-5)
    direct = tms.extract_scaleset(cloud, cloud[subset], [(0.3, (1.0,))],
                                  "vector", attributes=attrs[subset],
                                  device="cpu")
    np.testing.assert_array_equal(got, direct)
    with pytest.raises(ValueError, match="designated search space"):
        twf.extract_features(port, [(0.3, (1.0,))], "vector",
                             attributes_asset="partial_attrs",
                             search_asset="subset", overwrite=True,
                             device="cpu")


def test_skip_sampling_selects_the_reference_index(tmp_path):
    cloud, labels = _scene(with_nulls=True)
    ref, port = _archives(tmp_path, cloud, labels)
    (got, index, _), (want, _, _) = _both_features(
        ref, port, [(0.3, (0.5,))], "minimal", label_asset="labels",
        unlabeled_fraction=0.1, seed=0)
    labeled = np.nonzero(labels != NULL_LABEL)[0]
    assert len(labeled) < len(index) < len(cloud)
    assert np.isin(labeled, index).all()
    _compare("minimal", got, want)


def test_partitioned_run_matches_reference(tmp_path):
    cloud, labels = _scene(n_per=250)
    ref, port = _archives(tmp_path, cloud, labels)
    (got, _, _), (want, _, _) = _both_features(
        ref, port, [(0.3, (0.5,))], "minimal", feature_name="parts",
        partition_max_population=400)
    _compare("minimal", got, want)
    whole = tms.extract_scaleset(port.take(original_coordinates=False),
                                 port.take(original_coordinates=False),
                                 [(0.3, (0.5,))], "minimal", device="cpu")
    assert (whole[:, 0] == got[:, 0]).mean() > 0.99


def test_automatic_out_of_core_matches_reference(tmp_path):
    cloud, labels = _scene()
    ref, port = _archives(tmp_path, cloud, labels)
    scaleset = [(0.3, (1.0, 0.5))]
    budget = 32 * 1024 ** 2
    span = cloud.max(0) - cloud.min(0)
    population = tmem.auto_partition_population(
        len(cloud), len(cloud), scaleset, budget=budget, bounds_span=span,
        device="cpu")
    assert population is not None and population == \
        jmem.auto_partition_population(len(cloud), len(cloud), scaleset,
                                       budget=budget, bounds_span=span)
    (got, _, _), (want, _, _) = _both_features(
        ref, port, scaleset, "geometric", feature_name="auto_ooc",
        hbm_budget_bytes=budget)
    _compare("geometric", got, want)
    assert tmem.auto_partition_population(
        len(cloud), len(cloud), scaleset, budget=64 * 1024 ** 3,
        device="cpu") is None


def _fused_population_bounds(query, search, edge, radius):
    """Fewest and most voxel neighbors of each query that an f32
    evaluation of ``d2 <= f32(r^2)`` can count: candidates whose float64
    d2 lies within the rounding bound of r^2 may go either way."""
    centers = tms._host_unique_voxels(search, edge).astype(np.float64)
    q = query.astype(np.float64)
    d2 = ((q[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    scale = (np.abs(q[:, None, :]) + np.abs(centers[None, :, :])).max(-1)
    slack = 16 * EPS32 * (radius * radius + scale * scale)
    r2 = float(np.float32(radius * radius))
    return (d2 <= r2 - slack).sum(1), (d2 <= r2 + slack).sum(1)


def test_fused_features_match_reference(tmp_path):
    # method="fused": the port's packed_moments twin against the
    # reference's XLA bands (off a TPU it takes those)
    cloud, labels = _scene(n_per=300)
    ref, port = _archives(tmp_path, cloud, labels)
    scaleset = [(0.25, (0.5,)), (0.5, (1.0,))]
    (got, _, _), (want, _, _) = _both_features(
        ref, port, scaleset, "minimal", method="fused")
    points = port.take(original_coordinates=False).astype(np.float32)
    agree = np.ones(len(points), bool)
    for band, (edge, (radius,)) in enumerate(scaleset):
        lo, hi = _fused_population_bounds(points, points, edge, radius)
        for pops in (got[:, 4 * band], want[:, 4 * band]):
            assert np.all((lo <= pops) & (pops <= hi))
        agree &= got[:, 4 * band] == want[:, 4 * band]
    assert agree.mean() > 0.99
    _compare("minimal", got[agree], want[agree])


# -- training ----------------------------------------------------------------


def _cfg(module, **kwargs):
    if module is ttr:
        kwargs["device"] = "cpu"
    return module.TrainConfig(**kwargs)


def test_multiclass_rpte_equals_reference(tmp_path):
    ref, port, cloud, _ = _shared(tmp_path, n_per=400)
    reports = [module.multiclass_train(
        archive, ["f"], "labels",
        _cfg(module, classifier="rpte", classifier_kwargs=dict(RPTE)))
        for module, archive in ((jtr, ref), (ttr, port))]
    want, got = reports
    assert got["validation_accuracy"] == want["validation_accuracy"] > 0.8
    for key in ("confusion", "user_accuracy", "producer_accuracy"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["result_asset"] == want["result_asset"] == "predicted_rpte"
    _same_asset(ref, port, "predicted_rpte")
    np.testing.assert_allclose(port.get_asset("predicted_rpte_proba")[0],
                               ref.get_asset("predicted_rpte_proba")[0],
                               atol=1e-6)


def test_balance_resampler_rpte_equals_reference(tmp_path):
    ref, port, _, _ = _shared(tmp_path)
    want = jtr.balance_resampler(
        ref, ["f"], "labels", _cfg(jtr, classifier="rpte",
                                   classifier_kwargs=dict(RPTE)), repeats=2)
    got = ttr.balance_resampler(
        port, ["f"], "labels", _cfg(ttr, classifier="rpte",
                                    classifier_kwargs=dict(RPTE)), repeats=2)
    assert got["mean_confusion"].shape == (3, 3)
    for key in ("mean_confusion", "std_confusion"):
        np.testing.assert_array_equal(got[key], want[key])


def test_linear_fit_is_held_by_accuracy(tmp_path):
    ref, port, cloud, _ = _shared(tmp_path, n_per=400)
    accs = []
    for module, archive in ((jtr, ref), (ttr, port)):
        report = module.multiclass_train(
            archive, ["f"], "labels",
            _cfg(module, classifier="linear",
                 classifier_kwargs={"epochs": 25}))
        accs.append(report["validation_accuracy"])
        proba, _, _ = archive.get_asset("predicted_linear_proba")
        assert proba.shape == (len(cloud), 3)
        np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-3)
    assert accs[1] > 0.8 and abs(accs[1] - accs[0]) <= 0.05, accs


@pytest.mark.parametrize("options", [
    {"prune_with_forest": True}, {"kernel_approx": "nystroem"},
    {"kernel_approx": "rbf", "kernel_components": 40}])
def test_pruning_and_kernel_maps_equal_reference(tmp_path, options):
    ref, port, _, _ = _shared(tmp_path)
    want, got = [module.multiclass_train(
        archive, ["f"], "labels",
        _cfg(module, classifier="rpte", classifier_kwargs=dict(RPTE),
             **options)) for module, archive in ((jtr, ref), (ttr, port))]
    if options.get("prune_with_forest"):
        assert len(got["columns"]) == 4
        np.testing.assert_array_equal(got["columns"], want["columns"])
    else:
        assert got["kernel_map"] is not None
    assert got["validation_accuracy"] == want["validation_accuracy"]
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    _same_asset(ref, port, "predicted_rpte")


@pytest.mark.parametrize("embedding", [False, True])
def test_binary_train_equals_reference(tmp_path, embedding):
    ref, port, _, _ = _shared(tmp_path, n_per=200)
    want, got = [module.binary_train(
        archive, ["f"], "labels", positive_class=2,
        config=_cfg(module, classifier="rpte", classifier_kwargs=dict(RPTE),
                    trees_embedding=embedding))
        for module, archive in ((jtr, ref), (ttr, port))]
    keys = [k for k in want if k != "classifier"]
    assert keys == [k for k in got if k != "classifier"]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["b_completeness"] > 60
    _same_asset(ref, port, "binary_2_rpte")


def test_factor_analysis_equals_reference(tmp_path):
    ref, port, _, _ = _shared(tmp_path)
    assert jtr.factor_analysis(ref, ["f"], 3) \
        == ttr.factor_analysis(port, ["f"], 3) == "fa_3"
    _same_asset(ref, port, "fa_3")
    assert port.get_asset("fa_3")[0].shape[1] == 3


def test_apply_classifier_with_the_reference_forest(tmp_path):
    ref, port, _, _ = _shared(tmp_path)
    report = jtr.multiclass_train(
        ref, ["f"], "labels",
        _cfg(jtr, classifier="rpte", classifier_kwargs=dict(RPTE)))
    forest = report["classifier"]
    carried = trpt.RPTEnsemble.from_tables(
        numpy_tables(forest._tables), forest.max_depth_, forest.d_func,
        "cpu")
    for module, archive, clf in ((jtr, ref, forest), (ttr, port, carried)):
        assert module.apply_classifier(archive, clf, ["f"],
                                       result_asset="applied") == "applied"
    _same_asset(ref, port, "applied")
    np.testing.assert_array_equal(port.get_asset("applied")[0],
                                  ref.get_asset("predicted_rpte")[0])


def test_train_config_takes_the_device():
    config = ttr.TrainConfig(classifier="linear")
    assert config.device == "cuda"
    assert ttr._make_classifier(config).device == torch.device("cuda")
    config = ttr.TrainConfig(classifier="rpte", device="cpu")
    assert ttr._make_classifier(config).device == torch.device("cpu")


# -- datasets ----------------------------------------------------------------


def test_dataset_tools_equal_reference(tmp_path):
    rng = np.random.default_rng(12)
    sheet = rng.random((200, 3)) * [4, 4, 0.02]
    blob = rng.normal([8, 2, 2], 0.5, (200, 3))
    extra = rng.random((100, 3)) * 4 + [12, 0, 0]
    f1 = rng.random((300, 2)).astype(np.float32)
    f2 = rng.random((400, 3)).astype(np.float32)
    archives = []
    for module, name in ((jds, "ref"), (tds, "port")):
        archive = module.build_from_class_files(
            tmp_path / name / "arc", [(0, sheet), (1, blob)],
            search_sources=[extra],
            voxel=0.05)
        archive.add_asset("f1", f1, np.arange(300))
        archive.add_asset("f2", f2, np.arange(400) + 50)
        assert module.merge_assets(archive, ["f1", "f2"], "joined") \
            == "joined"
        assert module.chop_asset(archive, "joined", [0, 2, 4]) \
            == "joined_chop"
        assert module.snip_asset(archive, "joined", np.arange(100)) \
            == "joined_snip"
        assert module.collapse_labels(archive, "labels", {1: 0}) \
            == "labels_collapsed"
        archives.append(archive)
    ref, port = archives
    assert port.manifest == ref.manifest
    np.testing.assert_array_equal(port.points, ref.points)
    for name in ref.list_assets():
        _same_asset(ref, port, name)
    labels, _, meta = port.get_asset("labels")
    assert meta["classes"] == [0, 1] and (labels == NULL_LABEL).sum() > 0
    assert port.get_asset("joined_chop")[0].shape[1] == 3
    assert (port.get_asset("labels_collapsed")[0] == 1).sum() == 0


# -- visualization -----------------------------------------------------------


def _labelled(tmp_path):
    ref, port, cloud, labels = _shared(tmp_path, n_per=150)
    for module, archive in ((jtr, ref), (ttr, port)):
        module.multiclass_train(archive, ["f"], "labels",
                                _cfg(module, classifier="rpte",
                                     classifier_kwargs=dict(RPTE)))
    _same_asset(ref, port, "predicted_rpte")
    # the walks' probabilities differ in the last bits; the exports are
    # compared on the same ones
    proba, index, meta = ref.get_asset("predicted_rpte_proba")
    np.testing.assert_allclose(port.get_asset("predicted_rpte_proba")[0],
                               proba, atol=1e-6)
    port.add_asset("predicted_rpte_proba", proba, index, meta=meta,
                   overwrite=True)
    return ref, port, cloud


@pytest.mark.parametrize("suffix,proba", [(".csv", True), (".csv", False),
                                          (".ply", True), (".las", False)])
def test_exports_equal_reference(tmp_path, suffix, proba):
    ref, port, cloud = _labelled(tmp_path)
    kwargs = {"proba_asset": "predicted_rpte_proba"} if proba else {}
    paths = [module.export_classified_cloud(
        archive, "predicted_rpte", str(tmp_path / f"{name}{suffix}"),
        **kwargs) for module, archive, name in (
            (jviz, ref, "ref"), (tviz, port, "port"))]
    assert paths[1] == str(tmp_path / f"port{suffix}")
    for io in (jio, tio):
        if suffix == ".ply":
            want, got = (io.load_ply(p) for p in paths)
        elif suffix == ".las":
            (want, want_cls), (got, got_cls) = (
                io.load_las(p, with_classification=True) for p in paths)
            np.testing.assert_array_equal(got_cls, want_cls)
            np.testing.assert_array_equal(
                got_cls, port.get_asset("predicted_rpte")[0])
        else:
            want, got = (np.loadtxt(p, delimiter=",") for p in paths)
        assert got.shape[0] == len(cloud)
        np.testing.assert_array_equal(got, want)


def test_voxel_population_curve_equals_reference():
    cloud, _ = _scene()
    edges = [0.25, 0.5, 1.0]
    got = tviz.voxel_population_curve(cloud, edges)
    want = jviz.voxel_population_curve(cloud, edges)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (np.diff(got[1]) <= 0).all()


def test_plots_write_files(tmp_path):
    pytest.importorskip("matplotlib")
    ref, port, cloud = _labelled(tmp_path)
    confusion = port.get_asset("predicted_rpte")[2]["confusion"]
    paths = [tviz.confusion_plot(confusion, tmp_path / "conf.png"),
             tviz.voxel_population_plot(cloud, [0.25, 0.5, 1.0],
                                        tmp_path / "vox.png"),
             tviz.embedding_plot(port.get_asset("f")[0],
                                 port.get_asset("labels")[0],
                                 tmp_path / "emb.png", sample=200)]
    for path in paths:
        assert os.path.getsize(path) > 0


def test_scaleset_backend_in_tuning_takes_xla_bands(monkeypatch):
    # tuning["backend"] takes precedence over the argument, as in the
    # reference: "xla" never reaches the packed kernel's wrapper
    rng = np.random.default_rng(3)
    cloud = (rng.random((1500, 3)) * [4, 4, 1.5]).astype(np.float32)
    scaleset = [(0.25, (0.5,)), (0.5, (1.0, 0.6))]
    by_argument = tms.extract_scaleset(cloud, cloud, scaleset, "minimal",
                                       method="fused", backend="xla",
                                       device="cpu")
    from nimrud_tpu_torch.ops.kernels import packed_moments as tpm

    def refuse(*args, **kwargs):
        raise AssertionError("the packed kernel's wrapper was called")

    monkeypatch.setattr(tpm, "packed_moments", refuse)
    got = tms.extract_scaleset(cloud, cloud, scaleset, "minimal",
                               method="fused", tuning={"backend": "xla"},
                               device="cpu")
    np.testing.assert_array_equal(got, by_argument)
    want = jms.extract_scaleset(cloud, cloud, scaleset, "minimal",
                                method="fused", tuning={"backend": "xla"})
    _compare("minimal", got, np.array(want))
    with pytest.raises(ValueError, match="unknown backend"):
        tms.extract_scaleset(cloud, cloud, scaleset, "minimal",
                             method="fused", tuning={"backend": "ragged"},
                             device="cpu")
