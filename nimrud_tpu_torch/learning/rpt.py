"""
Random-projection-tree ensemble classifier (port of
``nimrud_tpu/learning/rpt.py``; method from Dasgupta & Freund 2008).

Each tree trains on a disjoint class-balanced subset; a cell splits on a
random unit projection at a jittered median until a gini impurity or
population threshold; test points walk down the tree, a dead
(training-empty) branch backing off to its parent's statistics; the
per-tree (gini, class proportions) combine by impurity-weighted mean
(``"wmean"``) or weighted max (``"wmax"``).

The host fit (:meth:`RPTEnsemble.fit`) is the reference's NumPy
recursion, copied operation for operation, so its tables are bit-equal
to the reference's for the same seed.  The fitted forest is flattened
into per-tree tables: sorted branch codes with split, projection
vector, gini and proportions (``tags`` ...), and, for forests shallow
enough (``2 ** (depth + 2) <= 65536`` nodes), dense tables indexed by
branch code with dead branches filled from the parent (``dense_*``).
The device fit (:meth:`RPTEnsemble.fit_device`) grows the dense tables
level by level on the device.  Inference walks every (tree, point) pair
one level a step.  The reference's walk stops when every pair stands at
a leaf; a test of that is a host synchronization a level here, so the
walk runs a fixed number of levels instead: one past the forest's
deepest split (``walk_depth_``, found once when the tables are set),
where every pair stands at a leaf, so the results are the reference's
(a pair at a leaf stays where it is).  On the card the dense walk and
the decision function run in one hand-written kernel
(``ops/kernels/forest_walk``, ``csrc/forest_walk.cu``), which leaves
each tree at its leaf, on the tables with their packing added once when
they are installed (``walk_tables_``); the plain walk is the CPU path
and its oracle.

:meth:`RPTEnsemble.fit_device_mesh` grows the same forest from features
sharded over a device mesh (``parallel.mesh``), bit-identical to
:meth:`~RPTEnsemble.fit_device` on the device-major flattening of the
valid rows.

Not ported: the reference's blocked and one-hot matmul walk tables
(``_blocked_table``, ``add_blocked_tables``, ``_walk_forest_blocked``),
a TPU-only layout of the same dense walk.  The device fit draws from
``torch.Generator``s seeded from ``seed``: it is reproducible against
itself, not against the JAX fit's ``jax.random`` draws.
"""

import numpy as np
import torch

from nimrud_tpu_torch.ops.kernels import forest_walk

# branch codes carry one bit per level plus the root bit: int32 tables
# need depth < 31
MAX_DEPTH = 30
# fit_device's depth cap (the reference's default; the dense table's
# budget is 15)
FIT_DEPTH = 14

_LEAF = np.float32(np.inf)

SPARSE_KEYS = ("tags", "splits", "vecs", "ginis", "props")
DENSE_KEYS = ("dense_splits", "dense_vecs", "dense_ginis", "dense_props")


class RPTEnsemble:
    """
    sklearn-style API: ``fit``, ``fit_device``, ``predict``,
    ``predict_proba``, ``predict_and_proba``, ``proba_device``,
    ``set_params``.

    Parameters (the reference's):
      d_func:       "wmean" (impurity-weighted mean of proportions) or
                    "wmax" (max of weighted proportions).
      n_estimators: trees in the ensemble.
      impurity:     gini threshold to stop splitting; a float, or a
                    (lo, hi) tuple to randomize it per tree.
      min_obs:      minimum training samples in a branch.
      onepass:      test rows a batch of :meth:`predict_proba`.
      seed:         RNG seed of the fits.
      prune_chains: collapse terminal degenerate chains after the host
                    fit (exact).
      device:       where the host fit's tables and ``predict_proba``
                    live; ``fit_device`` takes its features' device.
    """

    def __init__(self, d_func="wmean", n_estimators=10, impurity=0.2,
                 min_obs=20, onepass=10000, seed=None, prune_chains=True,
                 device="cuda"):
        self.d_func = d_func
        self.n_estimators = n_estimators
        self.impurity = impurity
        self.min_obs = min_obs
        self.onepass = onepass
        self.seed = seed
        self.prune_chains = prune_chains
        self.device = torch.device(device)
        self._tables = None

    def set_params(self, **kwargs):
        for key in ("d_func", "n_estimators", "impurity", "min_obs",
                    "onepass", "seed"):
            if key in kwargs:
                setattr(self, key, kwargs[key])
        return self

    @classmethod
    def from_tables(cls, arrays, max_depth, d_func, device, n_estimators=None,
                    onepass=10000):
        """A fitted forest from another implementation's tables as
        arrays: the table dict of a fitted
        ``nimrud_tpu.learning.rpt.RPTEnsemble`` (its ``_tables``, the
        sparse ``tags`` ... and / or the dense ``dense_*`` keys; derived
        ``dense_blk*`` keys are left out), with its ``max_depth_`` and
        ``d_func``."""
        keys = [k for k in SPARSE_KEYS + DENSE_KEYS if k in arrays]
        if not keys:
            raise ValueError("no forest tables among the arrays")
        tables = {k: torch.as_tensor(np.asarray(arrays[k])).to(device)
                  for k in keys}
        vecs = tables.get("dense_vecs", tables.get("vecs"))
        clf = cls(d_func=d_func, onepass=onepass, device=device,
                  n_estimators=vecs.shape[0] if n_estimators is None
                  else n_estimators)
        clf.max_depth_ = int(max_depth)
        clf._set_tables(tables)
        clf.dim = int(vecs.shape[2])
        props = tables.get("dense_props", tables.get("props"))
        clf.numlabs = int(props.shape[2])
        clf.trees_ = None
        return clf

    # -- fitting (host) -------------------------------------------------------

    def fit(self, data, labels):
        data = np.asarray(data, dtype=np.float64)
        labels = np.asarray(labels).astype(np.int64)
        if labels.size != data.shape[0]:
            raise ValueError("training set and label set do not match")
        self.numlabs = int(labels.max() + 1)
        self.dim = data.shape[1]
        rng = np.random.RandomState(self.seed)

        # class-balanced disjoint subsets: shuffle each class's indices,
        # split the smallest class's population across the trees
        index = np.arange(data.shape[0])
        per_class = [index[labels == c] for c in range(self.numlabs)]
        for rows in per_class:
            rng.shuffle(rows)
        min_pop = min(rows.size for rows in per_class)
        per_tree = min_pop // self.n_estimators
        if per_tree < 1:
            raise ValueError(
                f"smallest class has {min_pop} samples; cannot build "
                f"{self.n_estimators} balanced trees")
        perm = rng.permutation(min_pop)

        trees = []
        for n in range(self.n_estimators):
            chosen = perm[n * per_tree:(n + 1) * per_tree]
            rows = np.concatenate([rows.take(chosen) for rows in per_class])
            if isinstance(self.impurity, tuple):
                impurity = max(self.impurity) \
                    - rng.rand() * min(self.impurity)
            else:
                impurity = self.impurity
            rules = {}
            self._grow(data.take(rows, axis=0), labels.take(rows),
                       tag=1, impurity=impurity, rng=rng, rules=rules,
                       depth=0)
            if self.prune_chains:
                _prune_terminal_chains(rules, self.dim)
            trees.append(rules)
        self.trees_ = trees
        self._set_tables({k: torch.from_numpy(v).to(self.device)
                          for k, v in self._flatten(trees).items()})
        return self

    def _set_tables(self, tables):
        """Install fitted tables (``max_depth_`` set), find the tables
        the walk reads (``walk_tables_``: the dense tables with the walk
        kernel's packing added, else the sparse tables) and the depth
        the walk needs: one past the deepest split, at most
        ``max_depth_`` (one device read, here and not in a step)."""
        self._tables = tables
        dense = "dense_splits" in tables
        self.walk_tables_ = forest_walk.pack_tables(tables) if dense \
            else tables
        splits = tables["dense_splits" if dense else "splits"]
        finite = torch.isfinite(splits)
        codes = torch.arange(splits.shape[1], device=splits.device).expand(
            splits.shape)[finite] if dense else tables["tags"][finite]
        deepest = int(codes.max()).bit_length() - 1 if codes.numel() else -1
        self.walk_depth_ = min(deepest + 1, self.max_depth_)

    def _grow(self, data, labels, tag, impurity, rng, rules, depth):
        """Recursively grow one tree into a {branch_code: node} dict."""
        num = data.shape[0]
        proportions = np.array(
            [(labels == c).sum() for c in range(self.numlabs)],
            dtype=np.float64) / num
        gini = 1.0 - (proportions ** 2).sum()

        if gini <= impurity or num <= self.min_obs or depth >= MAX_DEPTH:
            rules[tag] = (_LEAF, np.zeros(self.dim), gini, proportions)
            return

        vec = rng.rand(self.dim)
        vec /= np.linalg.norm(vec)
        projection = data @ vec
        split = np.median(projection)
        # jitter the median by the cell diameter (Dasgupta-Freund rule)
        anchor = data[rng.randint(num)]
        diameter = np.linalg.norm(data - anchor, axis=1).max()
        split += (rng.rand() - 0.5) * 12 * diameter / np.sqrt(self.dim)

        rules[tag] = (split, vec, gini, proportions)
        left = projection <= split
        if left.any():
            self._grow(data[left], labels[left], tag << 1,
                       impurity, rng, rules, depth + 1)
        right = ~left
        if right.any():
            self._grow(data[right], labels[right], (tag << 1) | 1,
                       impurity, rng, rules, depth + 1)

    def _flatten(self, trees):
        """The rule dicts as padded per-tree NumPy tables, plus the
        dense code-indexed tables when the code space fits 2 ** 16
        nodes (dead branches take the parent's statistics as a leaf)."""
        n_nodes = max(len(rules) for rules in trees)
        n_trees = len(trees)
        tags = np.full((n_trees, n_nodes), np.iinfo(np.int32).max,
                       dtype=np.int32)
        splits = np.full((n_trees, n_nodes), np.inf, dtype=np.float32)
        vecs = np.zeros((n_trees, n_nodes, self.dim), dtype=np.float32)
        ginis = np.zeros((n_trees, n_nodes), dtype=np.float32)
        props = np.zeros((n_trees, n_nodes, self.numlabs), dtype=np.float32)
        depth = 0
        for t, rules in enumerate(trees):
            for i, code in enumerate(sorted(rules)):
                split, vec, gini, prop = rules[code]
                tags[t, i] = code
                splits[t, i] = split
                vecs[t, i] = vec
                ginis[t, i] = gini
                props[t, i] = prop
                depth = max(depth, int(code).bit_length() - 1)
        self.max_depth_ = depth
        out = {"tags": tags, "splits": splits, "vecs": vecs,
               "ginis": ginis, "props": props}

        size = 1 << (depth + 2)
        if size <= (1 << 16):
            dsplits = np.full((n_trees, size), np.inf, np.float32)
            dvecs = np.zeros((n_trees, size, self.dim), np.float32)
            dginis = np.zeros((n_trees, size), np.float32)
            dprops = np.zeros((n_trees, size, self.numlabs), np.float32)
            for t, rules in enumerate(trees):
                for code, (split, vec, gini, prop) in rules.items():
                    dsplits[t, code] = split
                    dvecs[t, code] = vec
                    dginis[t, code] = gini
                    dprops[t, code] = prop
                present = np.zeros(size, bool)
                present[list(rules)] = True
                for lvl in range(1, depth + 2):
                    codes = np.arange(1 << lvl, min(1 << (lvl + 1), size))
                    miss = codes[~present[codes]]
                    dginis[t, miss] = dginis[t, miss >> 1]
                    dprops[t, miss] = dprops[t, miss >> 1]
            out.update({"dense_splits": dsplits, "dense_vecs": dvecs,
                        "dense_ginis": dginis, "dense_props": dprops})
        return out

    # -- fitting (device) -----------------------------------------------------

    def fit_device(self, features, labels, n_classes=None, depth=FIT_DEPTH):
        """Grow the whole forest on ``features.device``: projections,
        per-node medians, the Dasgupta-Freund jitter, gini stopping and
        the dense tables, level by level.  ``labels`` may be a host
        array (the class-balanced subsets are host bookkeeping, as in
        the reference).  The reference's two deviations from :meth:`fit`
        hold: the jitter's anchor is the cell's lowest-projection sample,
        and the depth caps at ``depth`` (at most 15, the dense table's
        budget); a split that leaves one side empty is drawn again at
        the next level."""
        labels = np.asarray(labels).astype(np.int64)
        features = torch.as_tensor(features).to(torch.float32)
        device = features.device
        self.numlabs = int(labels.max() + 1) if n_classes is None \
            else int(n_classes)
        self.dim = int(features.shape[1])
        depth = int(min(depth, 15))
        rng = np.random.RandomState(self.seed)

        row_sets, imps = self._plan_subsets(labels, rng)
        seed = rng.randint(0, 2 ** 31 - 1) if self.seed is None \
            else self.seed
        self.max_depth_ = depth
        self._set_tables(_fit_forest_device(
            features, torch.from_numpy(labels).to(device),
            torch.from_numpy(row_sets).to(device), imps, seed,
            self.numlabs, depth, float(self.min_obs)))
        self.device = device
        self.trees_ = None
        return self

    def fit_device_mesh(self, feats, valid, labels, mesh, n_classes=None,
                        depth=FIT_DEPTH):
        """
        Grow the forest across a device mesh (``parallel.mesh.Mesh``):
        the per-shard features never gather whole.  Each shard scatters
        its rows of every tree's class-balanced subset on its own device
        (zeros elsewhere); the contributions are disjoint, so their sum
        over the mesh is exact.  Each device then grows its slice of the
        trees, tree ``t`` with the generator seed ``fit_device`` gives
        tree ``t`` (the forest padded to a multiple of the shard count,
        as in the reference: pad trees recompute tree 0 and are
        dropped).  BIT-IDENTICAL to :meth:`fit_device` on the
        device-major flattening of the valid rows (``feats[valid]``),
        given the same seed.

        Args:
          feats:  (n_shards, rows, dim) float32 per-shard features (an
                  array or tensor, or one tensor a shard, e.g. from
                  ``parallel.mesh.sharded_extract``).
          valid:  (n_shards, rows) bool host array.
          labels: (n_shards, rows) int host array (the subset plan is
                  host bookkeeping, as for ``fit_device``).
          mesh:   the mesh the shards live on (its device-major order).
        """
        from nimrud_tpu_torch.parallel import mesh as pmesh

        n_dev = mesh.size
        valid = np.asarray(valid, bool)
        labels_flat = np.asarray(labels).astype(np.int64)[valid]
        self.numlabs = int(labels_flat.max() + 1) if n_classes is None \
            else int(n_classes)
        shards = pmesh.shards_on(mesh, feats, torch.float32)
        self.dim = int(shards[0].shape[-1])
        depth = int(min(depth, 15))
        rng = np.random.RandomState(self.seed)

        row_sets, imps = self._plan_subsets(labels_flat, rng)
        n_trees, s_t = row_sets.shape
        seed = rng.randint(0, 2 ** 31 - 1) if self.seed is None \
            else self.seed
        seeds = _tree_seeds(seed, n_trees)

        # flat valid index -> (shard, row); np.nonzero is device-major,
        # as labels[valid]'s flattening
        dev_idx, row_idx = np.nonzero(valid)
        sel = row_sets.reshape(-1)
        sel_dev, sel_row = dev_idx[sel], row_idx[sel]
        labs_sub = labels_flat[sel].reshape(n_trees, s_t)

        contribs = []
        for d, f in enumerate(shards):
            mine = torch.from_numpy(sel_dev == d).to(f.device)
            rows = torch.from_numpy(sel_row).to(f.device)
            contribs.append(torch.where(
                mine[:, None], f[torch.clamp(rows, 0, f.shape[0] - 1)], 0.0))
        # the sum over the mesh, replicated on each distinct device
        subsets = {dev: sum(c.to(dev) for c in contribs).reshape(
            n_trees, s_t, -1) for dev in mesh.distinct}

        t_per = -(-n_trees // n_dev)
        order = [t if t < n_trees else 0 for t in range(t_per * n_dev)]
        grown = [None] * n_trees
        for d, dev in enumerate(mesh.flat):
            labs_dev = torch.from_numpy(labs_sub).to(dev)
            for t in order[d * t_per:(d + 1) * t_per]:
                generator = torch.Generator(device=dev).manual_seed(seeds[t])
                tree = _grow_tree_device(
                    subsets[dev][t], labs_dev[t], float(imps[t]), generator,
                    self.numlabs, depth, float(self.min_obs))
                if grown[t] is None:
                    grown[t] = tree
        home = mesh.flat[0]
        self.max_depth_ = depth
        self._set_tables({key: torch.stack([p.to(home) for p in parts])
                          for key, parts in zip(DENSE_KEYS, zip(*grown))})
        self.device = home
        self.trees_ = None
        return self

    def _plan_subsets(self, labels_flat, rng):
        """Class-balanced disjoint per-tree row sets and impurities (host
        bookkeeping, the reference's, draw for draw)."""
        index = np.arange(labels_flat.shape[0])
        per_class = [index[labels_flat == c]
                     for c in range(self.numlabs)]
        for rows in per_class:
            rng.shuffle(rows)
        min_pop = min(rows.size for rows in per_class)
        per_tree = min_pop // self.n_estimators
        if per_tree < 1:
            raise ValueError(
                f"smallest class has {min_pop} samples; cannot build "
                f"{self.n_estimators} balanced trees")
        perm = rng.permutation(min_pop)
        row_sets, imps = [], []
        for n in range(self.n_estimators):
            chosen = perm[n * per_tree:(n + 1) * per_tree]
            row_sets.append(np.concatenate(
                [rows.take(chosen) for rows in per_class]))
            if isinstance(self.impurity, tuple):
                imps.append(max(self.impurity)
                            - rng.rand() * min(self.impurity))
            else:
                imps.append(float(self.impurity))
        return np.stack(row_sets), np.asarray(imps, np.float32)

    # -- inference ------------------------------------------------------------

    def predict_proba(self, data):
        """Class probabilities of host rows, ``onepass`` rows a batch on
        the forest's device, as a NumPy array."""
        data = np.asarray(data, dtype=np.float32)
        if data.shape[1] != self.dim:
            raise ValueError("test data do not match the training "
                             "dimensions")
        device = next(iter(self._tables.values())).device
        out = [self.proba_device(torch.from_numpy(
                   data[start:start + self.onepass]).to(device))
               .cpu().numpy()
               for start in range(0, data.shape[0], self.onepass)]
        return np.concatenate(out, axis=0)

    def proba_device(self, features):
        """Class probabilities of a device feature tensor."""
        return ensemble_proba(self.walk_tables_, features, self.walk_depth_,
                              self.d_func)

    def predict(self, data):
        return self.predict_proba(data).argmax(axis=1)

    def predict_and_proba(self, data):
        proba = self.predict_proba(data)
        return proba.argmax(axis=1), proba


def _prune_terminal_chains(rules, dim):
    """Collapse terminal degenerate chains, exactly: a single-child node
    whose child is a leaf with identical statistics is that leaf (every
    walk through it yields those statistics).  Bottom-up, so whole
    chains go."""
    for code in sorted(rules, reverse=True):
        if code not in rules:
            continue
        split, _, gini, prop = rules[code]
        if np.isinf(split):
            continue
        left, right = code << 1, (code << 1) | 1
        children = [c for c in (left, right) if c in rules]
        if len(children) != 1:
            continue
        csplit, _, cgini, cprop = rules[children[0]]
        if np.isinf(csplit) and cgini == gini \
                and np.array_equal(cprop, prop):
            del rules[children[0]]
            rules[code] = (_LEAF, np.zeros(dim), gini, prop)


def _tree_seeds(seed, n_trees):
    """One generator seed a tree, from the fit's seed."""
    state = np.random.SeedSequence(seed).generate_state(n_trees, np.uint64)
    return [int(s) & (2 ** 63 - 1) for s in state]


def _grow_tree_device(data, labs, impurity, generator, numlabs, depth,
                      min_obs):
    """Grow ONE tree on the device, level-synchronously (the reference's
    ``_grow_tree_device``): every live sample carries its branch code;
    per-node class counts, medians and cell diameters come from one
    count, one two-key sort and one scatter-max a level; the dense
    tables are written in place.  A node whose split leaves a side
    empty stays pending and draws a fresh projection at the next level.
    At level ``lvl`` every live code lies below ``2 ** (lvl + 1)``, so a
    level works on that prefix of the node space only (its draws too),
    and the loop ends once every sample stands at a leaf (one host read
    a level: later levels would change nothing).  Returns the dense
    (splits, vecs, ginis, props)."""
    device = data.device
    size = 1 << (depth + 2)
    n, dim = data.shape
    attempts = 2 * depth + 4
    lvl_of = torch.from_numpy(np.floor(np.log2(np.maximum(
        np.arange(size), 1))).astype(np.int64)).to(device)
    rank = torch.arange(n, device=device)

    splits = torch.full((size,), float("inf"), device=device)
    vecs = torch.zeros((size, dim), device=device)
    ginis = torch.zeros((size,), device=device)
    props = torch.zeros((size, numlabs), device=device)
    written = torch.zeros((size,), dtype=torch.bool, device=device)
    code = torch.ones((n,), dtype=torch.int64, device=device)
    done = torch.zeros((n,), dtype=torch.bool, device=device)
    root_dim = np.float32(np.sqrt(np.float32(dim)))

    for lvl in range(attempts):
        live = ~done
        if not bool(live.any()):
            break
        width = min(size, 1 << (lvl + 1))             # live codes lie below
        safe = torch.where(live, code, width)         # row width: dropped
        counts = torch.bincount(safe * numlabs + labs,
                                minlength=(width + 1) * numlabs)
        counts = counts.reshape(width + 1, numlabs)[:width].to(torch.float32)
        tot = counts.sum(1)
        occ = tot > 0
        prop_d = counts / torch.clamp(tot, min=1.0)[:, None]
        gini_d = 1.0 - (prop_d * prop_d).sum(1)
        ginis[:width] = torch.where(occ, gini_d, ginis[:width])
        props[:width] = torch.where(occ[:, None], prop_d, props[:width])
        written[:width] |= occ
        leaf_d = occ & ((gini_d <= impurity) | (tot <= min_obs)
                        | (lvl >= attempts - 1) | (lvl_of[:width] >= depth))

        # one random unit projection and one jitter draw per node
        vec_d = torch.rand((width, dim), generator=generator, device=device)
        vec_d = vec_d / torch.linalg.vector_norm(vec_d, dim=1, keepdim=True)
        u = torch.rand((width,), generator=generator, device=device)
        node = torch.clamp(code, 0, width - 1)
        proj = (data * vec_d[node]).sum(1)

        # per-node median and lowest-projection anchor: the samples
        # sorted by (code, projection), stably
        by_proj = torch.sort(proj, stable=True).indices
        s_row = by_proj[torch.sort(safe[by_proj], stable=True).indices]
        s_code, s_proj = safe[s_row], proj[s_row]
        head = torch.ones_like(live)
        head[1:] = s_code[1:] != s_code[:-1]
        starts = torch.zeros((width + 1,), dtype=torch.int64, device=device)
        starts[torch.where(head, s_code, width)] = rank
        starts = starts[:width]
        tot_i = tot.to(torch.int64)
        median = 0.5 * (s_proj[torch.clamp(starts + (tot_i - 1) // 2,
                                           0, n - 1)]
                        + s_proj[torch.clamp(starts + tot_i // 2, 0, n - 1)])
        anchor_row = s_row[torch.clamp(starts, 0, n - 1)]
        anchor = data[anchor_row[node]]
        dist = torch.linalg.vector_norm(data - anchor, dim=1)
        diam = torch.zeros((width + 1,), device=device).scatter_reduce(
            0, safe, dist, reduce="amax")[:width]
        split_d = median + (u - 0.5) * 12.0 * diam / float(root_dim)

        go_left = proj <= split_d[node]
        lcnt = torch.bincount(safe[go_left], minlength=width + 1)[:width]
        grow = occ & ~leaf_d & (lcnt > 0) & (lcnt < tot_i)
        splits[:width] = torch.where(grow, split_d, splits[:width])
        vecs[:width] = torch.where(grow[:, None], vec_d, vecs[:width])

        done = done | (live & leaf_d[node])
        advance = ~done & grow[node]
        code = torch.where(advance, (code << 1) | (~go_left).to(torch.int64),
                           code)

    # dead-branch back-off: unvisited cells take the parent's statistics
    for lvl in range(1, depth + 2):
        lo, hi = 1 << lvl, min(1 << (lvl + 1), size)
        miss = ~written[lo:hi]
        ginis[lo:hi] = torch.where(
            miss, ginis[lo >> 1:hi >> 1].repeat_interleave(2), ginis[lo:hi])
        props[lo:hi] = torch.where(
            miss[:, None], props[lo >> 1:hi >> 1].repeat_interleave(2, 0),
            props[lo:hi])
    return splits, vecs, ginis, props


def _fit_forest_device(features, labels, rows, impurities, seed, numlabs,
                       depth, min_obs):
    """Grow every tree on its row set, one generator a tree; returns the
    dense table dict."""
    device = features.device
    trees = []
    for r, imp, tree_seed in zip(rows, impurities,
                                 _tree_seeds(seed, rows.shape[0])):
        generator = torch.Generator(device=device).manual_seed(tree_seed)
        trees.append(_grow_tree_device(features[r], labels[r], float(imp),
                                       generator, numlabs, depth, min_obs))
    return {key: torch.stack(parts)
            for key, parts in zip(DENSE_KEYS, zip(*trees))}


def _walk_one_tree(tags, splits, vecs, ginis, props, data, max_depth):
    """Level-synchronous walk of one sparse tree (sorted branch codes):
    each level finds the pair's node by a binary search, a dead branch
    backing off to its parent's row.  Returns (gini, proportions) a
    point."""
    n_nodes = tags.shape[0]
    batch = data.shape[0]
    tag = torch.ones(batch, dtype=tags.dtype, device=data.device)
    done = torch.zeros(batch, dtype=torch.bool, device=data.device)
    node = torch.zeros(batch, dtype=torch.int64, device=data.device)
    for _ in range(max_depth + 1):
        pos = torch.clamp(torch.searchsorted(tags, tag), 0, n_nodes - 1)
        found = tags[pos] == tag
        parent = torch.clamp(torch.searchsorted(tags, tag >> 1), 0,
                             n_nodes - 1)
        use = torch.where(found, pos, parent)
        is_leaf = ~found | torch.isinf(splits[use])
        node = torch.where(~done & is_leaf, use, node)
        done = done | is_leaf
        projection = (data * vecs[use]).sum(1)
        next_tag = (tag << 1) | (projection > splits[use]).to(tag.dtype)
        tag = torch.where(done, tag, next_tag)
    return ginis[node], props[node]


def _walk_one_tree_dense(dsplits, dvecs, dginis, dprops, data, max_depth):
    """Direct-index walk of one dense tree (node = branch code, dead
    branches filled at pack time): the per-tree form of
    ``forest_walk.walk_dense_plain``, with the same results."""
    size = dsplits.shape[0]
    batch = data.shape[0]
    tag = torch.ones(batch, dtype=torch.int64, device=data.device)
    done = torch.zeros(batch, dtype=torch.bool, device=data.device)
    node = torch.zeros(batch, dtype=torch.int64, device=data.device)
    for _ in range(max_depth + 1):
        at = torch.clamp(tag, max=size - 1)
        split = dsplits[at]
        is_leaf = torch.isinf(split)
        node = torch.where(~done & is_leaf, tag, node)
        done = done | is_leaf
        projection = (data * dvecs[at]).sum(1)
        next_tag = (tag << 1) | (projection > split).to(torch.int64)
        tag = torch.where(done, tag, next_tag)
    return dginis[node], dprops[node]


def ensemble_proba(tables, data, max_depth, d_func):
    """Class probabilities of feature rows ``data`` (points, dim) under
    the forest ``tables``, walked ``max_depth + 1`` levels (the forest's
    ``max_depth_``, or its ``walk_depth_``: the same results): the dense
    walk and decision of ``ops/kernels/forest_walk`` when the dense
    tables exist (for a CUDA tensor the kernel, on the packing of the
    forest's ``walk_tables_``; the plain walk on the CPU), else the
    sparse walk tree by tree, then the decision function."""
    if "dense_splits" in tables:
        return forest_walk.forest_proba(tables, data, max_depth, d_func)
    walks = [_walk_one_tree(*(tables[k][t] for k in SPARSE_KEYS), data,
                            max_depth)
             for t in range(tables["tags"].shape[0])]
    gini = torch.stack([g for g, _ in walks])
    proportions = torch.stack([p for _, p in walks])
    return forest_walk.decide(gini, proportions, d_func)
