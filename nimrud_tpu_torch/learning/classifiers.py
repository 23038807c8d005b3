"""
Classifier factory (port of ``nimrud_tpu/learning/classifiers.py``).
``"linear"`` and ``"rpte"`` are ported; the sklearn-backed kinds raise
``NotImplementedError`` (ROADMAP.md Queue A #6b, the sklearn
classifiers, still open).
"""

from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
from nimrud_tpu_torch.learning.rpt import RPTEnsemble

CLASSIFIER_KINDS = ("svm", "rf", "erf", "nb", "knn", "sgd", "rpte", "linear")


def param_classifier(kind, **kwargs):
    """Build a classifier by abbreviated name: ``"linear"``, the softmax
    model trained on the device (kwargs learning_rate, epochs, ...), or
    ``"rpte"``, the random-projection-tree ensemble (kwargs
    n_estimators=10, d_func="wmean", impurity=0.2, seed, ...)."""
    if kind == "linear":
        return SoftmaxClassifier(**kwargs)
    if kind == "rpte":
        return RPTEnsemble(**kwargs)
    if kind in CLASSIFIER_KINDS:
        raise NotImplementedError(
            f"classifier {kind!r} is not ported yet (ROADMAP.md Queue A "
            "#6b, the sklearn classifiers)")
    raise ValueError(
        f"unknown classifier {kind!r}; choose from {CLASSIFIER_KINDS}")
