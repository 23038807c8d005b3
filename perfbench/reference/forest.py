"""
The random-projection-tree forest of the benchmark: a frozen plain copy
of the host growth of ``nimrud_tpu_torch.learning.rpt.RPTEnsemble.fit``
(itself the reference's NumPy recursion; Dasgupta & Freund 2008), with
the device fit's depth cap, its flattening into the dense tables the
program serves (``dense_splits``, ``dense_vecs``, ``dense_ginis``,
``dense_props``), and a plain walk of those tables.

A tree trains on a disjoint class-balanced subset; a cell splits on a
random unit projection at the median, jittered by the cell's diameter,
until its gini impurity, its population or the depth cap stops it.  A
point walks left where ``projection <= split``; at a leaf, or where the
branch it takes was empty in training, it takes that node's (gini,
proportions); the trees combine by the impurity-weighted mean
(``wmean``).
"""

import numpy as np
import torch

from perfbench.reference.features import tf32

WMEAN_EPS = float(np.float32(np.spacing(32)))
LEAF = np.float32(np.inf)


def _grow(data, labels, tag, impurity, rng, rules, depth, numlabs, min_obs,
          max_depth):
    num = data.shape[0]
    proportions = np.array([(labels == c).sum() for c in range(numlabs)],
                           dtype=np.float64) / num
    gini = 1.0 - (proportions ** 2).sum()
    dim = data.shape[1]
    if gini <= impurity or num <= min_obs or depth >= max_depth:
        rules[tag] = (LEAF, np.zeros(dim), gini, proportions)
        return
    vec = rng.rand(dim)
    vec /= np.linalg.norm(vec)
    projection = data @ vec
    split = np.median(projection)
    anchor = data[rng.randint(num)]
    diameter = np.linalg.norm(data - anchor, axis=1).max()
    split += (rng.rand() - 0.5) * 12 * diameter / np.sqrt(dim)
    rules[tag] = (split, vec, gini, proportions)
    left = projection <= split
    if left.any():
        _grow(data[left], labels[left], tag << 1, impurity, rng, rules,
              depth + 1, numlabs, min_obs, max_depth)
    right = ~left
    if right.any():
        _grow(data[right], labels[right], (tag << 1) | 1, impurity, rng,
              rules, depth + 1, numlabs, min_obs, max_depth)


def _prune_terminal_chains(rules, dim):
    for code in sorted(rules, reverse=True):
        if code not in rules:
            continue
        split, _, gini, prop = rules[code]
        if np.isinf(split):
            continue
        children = [c for c in (code << 1, (code << 1) | 1) if c in rules]
        if len(children) != 1:
            continue
        csplit, _, cgini, cprop = rules[children[0]]
        if np.isinf(csplit) and cgini == gini and np.array_equal(cprop, prop):
            del rules[children[0]]
            rules[code] = (LEAF, np.zeros(dim), gini, prop)


def grow(data, labels, n_estimators, impurity, min_obs, max_depth, seed):
    """The forest's dense tables (NumPy float32), its depth and its
    number of classes, grown from float64 ``data`` and int ``labels``."""
    data = np.asarray(data, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    numlabs = int(labels.max() + 1)
    dim = data.shape[1]
    rng = np.random.RandomState(seed)
    index = np.arange(data.shape[0])
    per_class = [index[labels == c] for c in range(numlabs)]
    for rows in per_class:
        rng.shuffle(rows)
    min_pop = min(rows.size for rows in per_class)
    per_tree = min_pop // n_estimators
    if per_tree < 1:
        raise ValueError("too few samples of the smallest class")
    perm = rng.permutation(min_pop)
    trees = []
    for n in range(n_estimators):
        chosen = perm[n * per_tree:(n + 1) * per_tree]
        rows = np.concatenate([r.take(chosen) for r in per_class])
        rules = {}
        _grow(data.take(rows, axis=0), labels.take(rows), 1, impurity, rng,
              rules, 0, numlabs, min_obs, max_depth)
        _prune_terminal_chains(rules, dim)
        trees.append(rules)
    depth = max(int(code).bit_length() - 1 for rules in trees
                for code in rules)
    size = 1 << (depth + 2)
    splits = np.full((n_estimators, size), np.inf, np.float32)
    vecs = np.zeros((n_estimators, size, dim), np.float32)
    ginis = np.zeros((n_estimators, size), np.float32)
    props = np.zeros((n_estimators, size, numlabs), np.float32)
    for t, rules in enumerate(trees):
        for code, (split, vec, gini, prop) in rules.items():
            splits[t, code] = split
            vecs[t, code] = vec
            ginis[t, code] = gini
            props[t, code] = prop
        present = np.zeros(size, bool)
        present[list(rules)] = True
        for lvl in range(1, depth + 2):
            codes = np.arange(1 << lvl, min(1 << (lvl + 1), size))
            miss = codes[~present[codes]]
            ginis[t, miss] = ginis[t, miss >> 1]
            props[t, miss] = props[t, miss >> 1]
    tables = {"dense_splits": splits, "dense_vecs": vecs,
              "dense_ginis": ginis, "dense_props": props}
    return tables, depth, numlabs


def proba(tables, features, precision="float64"):
    """Class probabilities of feature rows under the dense ``tables``:
    the walk and the weighted mean in float64, or for the control in
    float32 with the projections as TF32 products."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    device = features.device
    t = {k: torch.as_tensor(v, device=device) for k, v in tables.items()}
    splits = t["dense_splits"].to(dtype)
    vecs = t["dense_vecs"].to(dtype)
    data = features.to(dtype)
    if precision != "float64":
        vecs, data = tf32(vecs), tf32(data)
    n_trees, size = splits.shape
    n = data.shape[0]
    tag = torch.ones((n_trees, n), dtype=torch.int64, device=device)
    tree = torch.arange(n_trees, device=device)[:, None].expand(n_trees, n)
    for _ in range(size.bit_length()):
        split = splits[tree, tag]
        leaf = torch.isinf(split)
        projection = (vecs[tree, tag] * data[None]).sum(-1)
        step = (tag << 1) | (projection > split).to(torch.int64)
        tag = torch.where(leaf | (step >= size), tag, step)
    gini = t["dense_ginis"].to(dtype)[tree, tag]            # (trees, n)
    prop = t["dense_props"].to(dtype)[tree, tag]            # (trees, n, c)
    weights = (1.0 - gini).T[:, :, None]
    weights = weights / (weights.sum(1, keepdim=True) + WMEAN_EPS)
    return (prop.permute(1, 0, 2) * weights).sum(1)
