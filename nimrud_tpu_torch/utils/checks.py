"""
Correctness checks shared by the port's tests and ``chip_smoke.py``:
the forest walk's rounding witness, drawn forests to hold the walk
kernel against its plain twin, the tolerance of chunked against
un-chunked serving probabilities, a fitted classifier's CPU copy, the
feature rows a serving step classifies, and a host classifier that
needs no sklearn (:class:`NearestMean`).
"""

import numpy as np
import torch

# Entry-chunked against un-chunked serving probabilities on the card:
# the served feature rows are bit-equal (the kernel's sums do not
# follow a bucket's capacity), but the classifier runs on other row
# counts (a chunk's against the whole plan's), which moved a
# probability by one f32 ulp below 1.0 (1.19e-7) on an H100.
CHUNK_PROBA_TOLERANCE = 1e-6


def walk_witness(tables, feats, max_depth, rows):
    """Whether f32 rounding of a projection can move the forest walk of
    ``rows`` of ``feats`` (a (n, dim) tensor): each row walks every tree
    of ``tables`` (a forest's dense or sparse tables) in float64, and is
    witnessed where some node on its path has ``|proj - split| <= dim *
    2^-23 * sum(|x_i v_i|)``, the bound on an f32 dot product of ``dim``
    terms summed in any order.  Returns a (k,) bool tensor."""
    dense = "dense_splits" in tables
    pre = "dense_" if dense else ""
    splits = tables[pre + "splits"].cpu().to(torch.float64).numpy()
    vecs = tables[pre + "vecs"].cpu().to(torch.float64).numpy()
    index = None if dense else [
        {int(c): i for i, c in enumerate(t)} for t in tables["tags"].cpu()]
    points = feats[rows.cpu()].cpu().to(torch.float64).numpy()
    dim = points.shape[1]
    held = []
    for x in points:
        near = False
        for t in range(splits.shape[0]):
            code = 1
            for _ in range(max_depth + 1):
                node = code if dense else index[t].get(code)
                if node is None or np.isinf(splits[t, node]):
                    break
                terms = x * vecs[t, node]
                proj = terms.sum()
                near |= bool(abs(proj - splits[t, node])
                             <= dim * 2.0 ** -23 * np.abs(terms).sum())
                code = 2 * code + int(proj > splits[t, node])
        held.append(near)
    return torch.tensor(held, dtype=torch.bool)


def drawn_forest(seed, n_trees, depth, dim, n_classes, n_rows):
    """A random forest's dense tables (the ``dense_*`` keys, float32 on
    the CPU) and ``n_rows`` standard normal (n_rows, dim) feature rows,
    from ``seed``: each tree's root splits, a node below splits with
    probability 0.8 where its parent did, down to level ``depth - 1``
    (so ``2 ** (depth + 2)`` nodes a tree); unit projection vectors,
    splits about the projections' spread, gini in [0, 0.7) and Dirichlet
    proportions at every node.  Walk it ``depth`` levels deep (or fewer,
    to leave pairs at no leaf)."""
    rng = np.random.default_rng(seed)
    size = 1 << (depth + 2)
    internal = np.zeros((n_trees, size), bool)
    internal[:, 1] = depth > 0
    for code in range(2, 1 << depth):
        internal[:, code] = internal[:, code >> 1] \
            & (rng.random(n_trees) < 0.8)
    vecs = rng.normal(size=(n_trees, size, dim))
    vecs /= np.linalg.norm(vecs, axis=2, keepdims=True)
    splits = np.where(internal, rng.normal(0.0, 0.5, (n_trees, size)),
                      np.inf)
    tables = {"dense_splits": splits, "dense_vecs": vecs,
              "dense_ginis": rng.uniform(0.0, 0.7, (n_trees, size)),
              "dense_props": rng.dirichlet(np.ones(n_classes),
                                           (n_trees, size))}
    feats = rng.normal(size=(n_rows, dim))
    return ({k: torch.from_numpy(v.astype(np.float32))
             for k, v in tables.items()},
            torch.from_numpy(feats.astype(np.float32)))


def on_cpu(clf):
    """A fitted classifier's copy on the CPU (linear or forest)."""
    from nimrud_tpu_torch.learning.linear import SoftmaxClassifier
    from nimrud_tpu_torch.learning.rpt import RPTEnsemble
    if isinstance(clf, RPTEnsemble):
        return RPTEnsemble.from_tables(
            {k: v.cpu().numpy() for k, v in clf._tables.items()},
            clf.max_depth_, clf.d_func, "cpu")
    return SoftmaxClassifier.from_state(
        clf.params.w.cpu(), clf.params.b.cpu(), clf.mean_.cpu(),
        clf.scale_.cpu(), device="cpu")


def served_features(model, staged):
    """The feature rows ``model``'s serving step hands its classifier,
    in caller order: the step run once more with ``classify_features``
    swapped for the identity."""
    from nimrud_tpu_torch import pipeline
    classify = pipeline.classify_features
    pipeline.classify_features = lambda params, features: features
    try:
        return model.predict_staged(staged, with_proba=True)[1]
    finally:
        pipeline.classify_features = classify


class NearestMean:
    """Nearest class mean of standardized rows, with ``fit`` and
    ``predict_proba`` only: a host classifier (no ``fit_device``, no
    ``proba_device``) for the host-classifier route where sklearn does
    not import.  Probabilities are the softmax of minus half the squared
    distances, in float64 as sklearn's are."""

    def fit(self, data, labels):
        data = np.asarray(data, np.float64)
        labels = np.asarray(labels)
        self.mean_ = data.mean(0)
        self.scale_ = data.std(0) + 1e-6
        z = (data - self.mean_) / self.scale_
        self.centers_ = np.stack([z[labels == c].mean(0)
                                  for c in range(int(labels.max()) + 1)])
        return self

    def predict_proba(self, data):
        z = (np.asarray(data, np.float64) - self.mean_) / self.scale_
        d2 = ((z[:, None, :] - self.centers_[None]) ** 2).sum(-1)
        e = np.exp(-0.5 * (d2 - d2.min(1, keepdims=True)))
        return e / e.sum(1, keepdims=True)
