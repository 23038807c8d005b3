"""
Classifier factory (port of ``nimrud_tpu/learning/classifiers.py``).
Only ``"linear"`` is ported; the other kinds raise
``NotImplementedError`` (ROADMAP.md).
"""

from nimrud_tpu_torch.learning.linear import SoftmaxClassifier

CLASSIFIER_KINDS = ("svm", "rf", "erf", "nb", "knn", "sgd", "rpte", "linear")


def param_classifier(kind, **kwargs):
    """Build a classifier by abbreviated name (``"linear"``: the softmax
    model trained on the device; kwargs learning_rate, epochs, ...)."""
    if kind == "linear":
        return SoftmaxClassifier(**kwargs)
    if kind in CLASSIFIER_KINDS:
        raise NotImplementedError(
            f"classifier {kind!r} is not ported yet (ROADMAP.md)")
    raise ValueError(
        f"unknown classifier {kind!r}; choose from {CLASSIFIER_KINDS}")
