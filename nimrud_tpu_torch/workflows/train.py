"""
Training / evaluation / application workflows over an archive.

Non-interactive equivalents of the reference's prompt-driven flows
(reference: nimrud/prototypes/apc.py multiclass_self:807,
multiclass_blind:1055, binary_self:1241, balance_resampler:1576,
apc_factor_analysis:1641, apply_clf_APC:1687), including balanced
sampling, optional kernel approximation (Nystroem / RBFSampler), optional
random-forest feature pruning, and the one-vs-rest binary flow (port of
``nimrud_tpu/workflows/train.py``).  ``"rpte"`` and ``"linear"`` classify
on ``TrainConfig.device`` (the card unless the caller asks for the CPU);
the sklearn kinds, the kernel maps, the pruning forest and the factor
analysis run on the host, and without sklearn they raise its
``ImportError``.
"""

from dataclasses import dataclass, field

import numpy as np

from nimrud_tpu_torch.archive.store import NULL_LABEL
from nimrud_tpu_torch.learning import metrics
from nimrud_tpu_torch.learning.classifiers import param_classifier


@dataclass
class TrainConfig:
    """Declarative replacement for the reference's input() prompts."""
    classifier: str = "rpte"
    classifier_kwargs: dict = field(default_factory=dict)
    samples_per_class: int | None = None     # None = balanced to smallest
    validation_fraction: float = 0.3
    kernel_approx: str | None = None          # None | nystroem | rbf
    kernel_components: int = 100
    trees_embedding: bool = False              # RandomTreesEmbedding map
                                               # (reference apc.py:1382-1390)
    prune_with_forest: bool = False           # RF importance pruning
    prune_keep_fraction: float = 0.5
    seed: int = 0
    device: str = "cuda"                       # rpte / linear classify here


def _make_classifier(config):
    """``param_classifier`` of the config; the device classifiers
    (``rpte``, ``linear``) on ``config.device``."""
    kwargs = dict(config.classifier_kwargs)
    if config.classifier in ("rpte", "linear"):
        kwargs.setdefault("device", config.device)
    return param_classifier(config.classifier, **kwargs)


def _gather_training_data(archive, feature_assets, label_asset):
    """Intersect the feature assets with the labels, drop null labels."""
    names = list(feature_assets) + [label_asset]
    index, block = archive.intersection(names)
    features, labels = block[:, :-1], block[:, -1].astype(np.int64)
    keep = labels != NULL_LABEL
    return index[keep], np.nan_to_num(features[keep]), labels[keep]


def _balanced_split(labels, per_class, validation_fraction, rng):
    """Balanced train rows + the rest for validation."""
    classes = np.unique(labels)
    smallest = min((labels == c).sum() for c in classes)
    if per_class is None:
        per_class = int(smallest * (1 - validation_fraction))
    per_class = min(per_class, smallest - 1)
    if per_class < 1:
        raise ValueError("not enough samples for a balanced split")
    train_rows = []
    for c in classes:
        rows = np.nonzero(labels == c)[0]
        rng.shuffle(rows)
        train_rows.append(rows[:per_class])
    train_rows = np.concatenate(train_rows)
    mask = np.ones(labels.size, dtype=bool)
    mask[train_rows] = False
    return train_rows, np.nonzero(mask)[0]


def _maybe_kernel_map(config, train_feats, rng):
    if config.kernel_approx is None:
        return None
    if config.kernel_approx == "nystroem":
        from sklearn.kernel_approximation import Nystroem
        mapper = Nystroem(n_components=config.kernel_components,
                          random_state=config.seed)
    elif config.kernel_approx == "rbf":
        from sklearn.kernel_approximation import RBFSampler
        mapper = RBFSampler(n_components=config.kernel_components,
                            random_state=config.seed)
    else:
        raise ValueError(f"unknown kernel approx {config.kernel_approx!r}")
    mapper.fit(train_feats)
    return mapper


def _maybe_prune(config, train_feats, train_labels):
    """RF-importance feature pruning (reference apc.py:972-1001)."""
    if not config.prune_with_forest:
        return None
    from sklearn.ensemble import RandomForestClassifier
    forest = RandomForestClassifier(
        n_estimators=50, n_jobs=6, random_state=config.seed)
    forest.fit(train_feats, train_labels)
    keep = int(train_feats.shape[1] * config.prune_keep_fraction)
    return np.sort(np.argsort(forest.feature_importances_)[::-1][:keep])


def multiclass_train(archive, feature_assets, label_asset="labels",
                     config=None, *, result_asset=None, overwrite=False):
    """
    Balanced multiclass training + validation + full-cloud application.
    Stores predicted labels and probabilities; returns a report dict.
    """
    config = config or TrainConfig()
    rng = np.random.RandomState(config.seed)
    index, features, labels = _gather_training_data(
        archive, feature_assets, label_asset)

    train_rows, val_rows = _balanced_split(
        labels, config.samples_per_class, config.validation_fraction, rng)
    train_feats, train_labels = features[train_rows], labels[train_rows]

    columns = _maybe_prune(config, train_feats, train_labels)
    if columns is not None:
        features = features[:, columns]
        train_feats = train_feats[:, columns]
    mapper = _maybe_kernel_map(config, train_feats, rng)
    if mapper is not None:
        features = mapper.transform(features)
        train_feats = mapper.transform(train_feats)

    clf = _make_classifier(config)
    clf.fit(train_feats, train_labels)

    predicted = np.asarray(clf.predict(features[val_rows]))
    conf = metrics.mc_confusion(predicted, labels[val_rows])
    user, producer = metrics.user_producer(conf)

    all_predicted = np.asarray(clf.predict(features))
    if hasattr(clf, "predict_proba"):
        probabilities = np.asarray(clf.predict_proba(features))
    else:
        probabilities = None

    if result_asset is None:
        result_asset = f"predicted_{config.classifier}"
    archive.add_asset(
        result_asset, all_predicted.astype(np.int32), index,
        meta={"classifier": config.classifier,
              "features": list(feature_assets),
              "confusion": conf.tolist()},
        overwrite=overwrite)
    if probabilities is not None:
        archive.add_asset(
            result_asset + "_proba", probabilities.astype(np.float32),
            index, meta={"classifier": config.classifier},
            overwrite=overwrite)

    return {
        "classifier": clf,
        "result_asset": result_asset,
        "confusion": conf,
        "user_accuracy": user,
        "producer_accuracy": producer,
        "validation_accuracy":
            float((predicted == labels[val_rows]).mean()),
        "columns": columns,
        "kernel_map": mapper,
    }


def binary_train(archive, feature_assets, label_asset="labels",
                 positive_class=1, config=None, *, result_asset=None,
                 overwrite=False):
    """
    One-vs-rest binary flow (reference binary_self): relabel to {0, 1},
    train, report completeness/correctness/quality.
    """
    config = config or TrainConfig()
    rng = np.random.RandomState(config.seed)
    index, features, labels = _gather_training_data(
        archive, feature_assets, label_asset)
    binary = (labels == positive_class).astype(np.int64)

    if config.trees_embedding:
        from sklearn.ensemble import RandomTreesEmbedding
        embedder = RandomTreesEmbedding(
            n_estimators=20, random_state=config.seed, sparse_output=False)
        features = embedder.fit_transform(features).astype(np.float32)

    train_rows, val_rows = _balanced_split(
        binary, config.samples_per_class, config.validation_fraction, rng)
    clf = _make_classifier(config)
    clf.fit(features[train_rows], binary[train_rows])

    predicted = np.asarray(clf.predict(features[val_rows]))
    scores = metrics.confusion(
        predicted.astype(float), binary[val_rows].astype(float))

    all_predicted = np.asarray(clf.predict(features)).astype(np.int32)
    if result_asset is None:
        result_asset = f"binary_{positive_class}_{config.classifier}"
    archive.add_asset(
        result_asset, all_predicted, index,
        meta={"positive_class": int(positive_class),
              "classifier": config.classifier},
        overwrite=overwrite)

    keys = ("a_completeness", "a_correctness", "a_quality",
            "b_completeness", "b_correctness", "b_quality")
    return {"classifier": clf, "result_asset": result_asset,
            **dict(zip(keys, scores))}


def balance_resampler(archive, feature_assets, label_asset="labels",
                      config=None, repeats=5):
    """
    Repeated balanced validation -> mean/std confusion matrices
    (reference: apc.py:1576-1637).
    """
    config = config or TrainConfig()
    index, features, labels = _gather_training_data(
        archive, feature_assets, label_asset)
    confusions = []
    for repeat in range(repeats):
        rng = np.random.RandomState(config.seed + repeat)
        train_rows, val_rows = _balanced_split(
            labels, config.samples_per_class,
            config.validation_fraction, rng)
        clf = _make_classifier(config)
        clf.fit(features[train_rows], labels[train_rows])
        predicted = np.asarray(clf.predict(features[val_rows]))
        confusions.append(metrics.mc_confusion(predicted, labels[val_rows]))
    stack = np.stack(confusions)
    return {"mean_confusion": stack.mean(0), "std_confusion": stack.std(0)}


def factor_analysis(archive, feature_assets, n_components, *,
                    result_asset=None, seed=0, overwrite=False):
    """FactorAnalysis dimensionality reduction (reference apc.py:1641)."""
    from sklearn.decomposition import FactorAnalysis
    index, block = archive.intersection(list(feature_assets))
    model = FactorAnalysis(n_components=n_components, random_state=seed)
    reduced = model.fit_transform(np.nan_to_num(block))
    if result_asset is None:
        result_asset = f"fa_{n_components}"
    archive.add_asset(
        result_asset, reduced.astype(np.float32), index,
        meta={"n_components": n_components,
              "source": list(feature_assets)},
        overwrite=overwrite)
    return result_asset


def apply_classifier(archive, classifier, feature_assets, *,
                     result_asset, overwrite=False):
    """
    Apply a fitted classifier to stored features (reference
    apply_clf_APC): store labels (+ probabilities when available).
    """
    index, features = archive.intersection(list(feature_assets))
    features = np.nan_to_num(features)
    predicted = np.asarray(classifier.predict(features)).astype(np.int32)
    archive.add_asset(
        result_asset, predicted, index,
        meta={"features": list(feature_assets)}, overwrite=overwrite)
    if hasattr(classifier, "predict_proba"):
        probabilities = np.asarray(classifier.predict_proba(features))
        archive.add_asset(
            result_asset + "_proba", probabilities.astype(np.float32),
            index, meta={"features": list(feature_assets)},
            overwrite=overwrite)
    return result_asset
