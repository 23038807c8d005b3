"""
Classifier factory (port of ``nimrud_tpu/learning/classifiers.py``): the
reference's parameterized classifier menu as a non-interactive API.

``"linear"`` (the softmax model) and ``"rpte"`` (the random-projection-
tree ensemble) fit and classify on the device.  The sklearn-backed
baselines (``"svm"``, ``"rf"``, ``"erf"``, ``"nb"``, ``"knn"``,
``"sgd"``) run on the host, as in the reference; each is imported when
it is asked for, so without sklearn those kinds raise its
``ImportError`` and nothing stands in for them.  A ``GeometryClassifier``
serves them through its host-classifier route (extract on the device,
classify on the host).
"""

from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.learning.rpt import RPTEnsemble

CLASSIFIER_KINDS = ("svm", "rf", "erf", "nb", "knn", "sgd", "rpte", "linear")


def param_classifier(kind, **kwargs):
    """
    Build a classifier by abbreviated name.

    kind:
      svm    -- linear SVC (sklearn)
      rf     -- random forest; kwargs: n_estimators=100, criterion='gini',
                bootstrap=True, n_jobs=6
      erf    -- extra trees; same kwargs as rf
      nb     -- Bernoulli naive Bayes (sklearn)
      knn    -- k nearest neighbors (ball tree); kwargs: n_neighbors=5,
                leaf_size=30
      sgd    -- hinge-loss SGD linear model (sklearn); kwargs: penalty='l2',
                fit_intercept=True, n_jobs=6
      rpte   -- random-projection-tree ensemble (device inference); kwargs:
                n_estimators=10, d_func='wmean', impurity=0.2, seed, ...
      linear -- softmax model trained on the device; kwargs:
                learning_rate, epochs, batch_size, ...
    """
    if kind == "rpte":
        return RPTEnsemble(**kwargs)
    if kind == "linear":
        return SoftmaxClassifier(**kwargs)

    if kind == "svm":
        from sklearn.svm import LinearSVC
        return LinearSVC(**kwargs)
    if kind == "rf":
        from sklearn.ensemble import RandomForestClassifier
        kwargs.setdefault("n_jobs", 6)
        return RandomForestClassifier(**kwargs)
    if kind == "erf":
        from sklearn.ensemble import ExtraTreesClassifier
        kwargs.setdefault("n_jobs", 6)
        return ExtraTreesClassifier(**kwargs)
    if kind == "nb":
        from sklearn.naive_bayes import BernoulliNB
        return BernoulliNB(**kwargs)
    if kind == "knn":
        from sklearn.neighbors import KNeighborsClassifier
        kwargs.setdefault("algorithm", "ball_tree")
        return KNeighborsClassifier(**kwargs)
    if kind == "sgd":
        from sklearn.linear_model import SGDClassifier
        kwargs.setdefault("loss", "hinge")
        kwargs.setdefault("n_jobs", 6)
        return SGDClassifier(**kwargs)

    raise ValueError(
        f"unknown classifier {kind!r}; choose from {CLASSIFIER_KINDS}")
