"""
Evaluation metrics and cloud colorizers (copy of
``nimrud_tpu/learning/metrics.py``, host NumPy).

Capability parity with the reference's metric suite
(reference: nimrud/prototypes/ml.py:434-686), vectorized:
  * mc_confusion      -- full multiclass confusion matrix (:521-552)
  * user_producer     -- per-class user/producer accuracy %, (:465-487)
  * three_metrics     -- per-class tp/fp/fn rates (:491-517)
  * confusion         -- binary completeness/correctness/quality (:559-610)
  * colorize_mc_prob / colorize_multiclass -- colorized clouds (:615-686)
  * dilate_scale      -- matrix upsampling for plots (:434-460)
"""

import numpy as np

# deep pink, blue, green, violet, orange, red, forest green, saddle brown,
# navy, goldenrod -- the reference's 10-class palette
COLOR_MATRIX = np.array([
    [255, 20, 147], [0, 191, 255], [0, 255, 127], [138, 43, 226],
    [255, 140, 0], [192, 0, 0], [34, 139, 34], [139, 69, 19],
    [0, 0, 128], [218, 165, 32]], dtype=np.float64)


def mc_confusion(predicted, known):
    """
    Confusion matrix: ``conf[row, col]`` counts points of known class
    ``col`` assigned label ``row``.  Labels are integers 0..n-1.
    """
    predicted = np.asarray(predicted).astype(np.int64)
    known = np.asarray(known).astype(np.int64)
    n = int(max(predicted.max(), known.max()) + 1)
    conf = np.zeros((n, n), dtype=np.float64)
    np.add.at(conf, (predicted, known), 1)
    return conf


def user_producer(conf):
    """Per-class user % (over rows) and producer % (over columns)."""
    conf = np.asarray(conf, dtype=np.float64)
    diagonal = np.diag(conf)
    user = diagonal / conf.sum(1) * 100
    producer = diagonal / conf.sum(0) * 100
    return user, producer


def three_metrics(conf):
    """
    Per-class [tp, fp, fn] rate columns.  Follows the reference's balanced
    -validation convention: true counts per class assumed equal (uses
    column 0's total as the per-class reference count).  The input MUST
    come from a balanced validation set; an unbalanced confusion would
    silently produce wrong rates, so it is rejected.
    """
    conf = np.asarray(conf, dtype=np.float64)
    col_totals = conf.sum(0)
    if not np.all(col_totals == col_totals[0]):
        raise ValueError(
            "three_metrics requires a balanced confusion matrix (equal "
            f"true counts per class); got column totals {col_totals}. "
            "Use user_producer for unbalanced validation sets.")
    n_real = col_totals[0]
    n_pred = conf.sum(1)
    diagonal = np.diag(conf)
    tp = diagonal / n_real
    fp = (n_real - diagonal) / n_real
    fn = (n_pred - diagonal) / n_pred
    return np.column_stack((tp, fp, fn))


def confusion(predicted, labels):
    """
    Binary completeness / correctness / quality for classes a (=0) and
    b (=1).  ``predicted`` may be a bare label vector or an XYZL cloud.
    Returns (a_comp, a_corr, a_qual, b_comp, b_corr, b_qual) in percent.
    """
    predicted = np.asarray(predicted, dtype=np.float64)
    if predicted.ndim == 2 and predicted.shape[1] == 4:
        predicted = predicted[:, 3]
    labels = np.asarray(labels, dtype=np.float64)

    a_tp = ((1 - predicted) * (1 - labels)).sum()
    a_tn = (predicted * labels).sum()
    a_fp = labels.sum() - a_tn
    a_fn = (labels.size - labels.sum()) - a_tp

    def scores(tp, fp, fn):
        return (100 * tp / (tp + fn),
                100 * tp / (tp + fp),
                100 * tp / (tp + fp + fn))

    a = scores(a_tp, a_fp, a_fn)
    b = scores(a_tn, a_fn, a_fp)
    return a + b


def colorize_multiclass(cloud_with_labels):
    """XYZL cloud -> XYZRGB cloud using the 10-class palette."""
    cloud = np.asarray(cloud_with_labels)
    labels = cloud[:, 3].astype(np.int64)
    return np.hstack((cloud[:, :3], COLOR_MATRIX[labels]))


def colorize_mc_prob(cloud_with_labels, probabilities):
    """
    XYZL cloud + per-class probabilities -> XYZRGB, fading each point
    from white (probability 0) to its class color (probability 1).
    """
    cloud = np.asarray(cloud_with_labels, dtype=np.float64)
    probabilities = np.asarray(probabilities, dtype=np.float64)
    labels = cloud[:, 3].astype(np.int64)
    own_prob = np.take_along_axis(
        probabilities, labels[:, None], axis=1)[:, 0]
    white = np.full((cloud.shape[0], 3), 255.0)
    class_colors = COLOR_MATRIX[labels]
    colors = white - (white - class_colors) * own_prob[:, None]
    return np.hstack((cloud[:, :3], colors))


def dilate_scale(matrix, factor):
    """Upsample a matrix by pixel replication and scale to (0, 1)."""
    matrix = np.asarray(matrix, dtype=np.float64)
    scaled = matrix / matrix.max()
    dilated = np.kron(scaled, np.ones((factor, factor)))
    return dilated.astype(np.float32)
