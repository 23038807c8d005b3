"""
The random-projection forest's walk over its dense tables and its
decision function: feature rows in, class probabilities out.

Two versions with one result:

* :func:`forest_proba_plain` -- plain PyTorch: the level-synchronous
  walk of every tree together (:func:`walk_dense_plain`), then the
  decision function (:func:`decide`).  It is the oracle: the CPU tests
  hold it against the JAX reference's walk, and ``chip_smoke.py`` holds
  the CUDA kernel against it.
* :func:`forest_proba` -- the wrapper of the hand-written Hopper kernel
  ``csrc/forest_walk.cu`` (design notes at its top; it replaces no TPU
  kernel).  A CPU tensor goes to the plain version; a CUDA tensor
  launches the kernel or raises.  ``forest_proba.launches`` counts
  kernel launches, and while ``utils.profiling`` records each launch
  adds 1 to its counter ``walk_launches``.

The kernel reads the packing of the dense tables that
:func:`pack_tables` adds to a forest's tables (``walk_vecs``,
``walk_stats``); the forest packs them once when its tables are
installed (``learning.rpt.RPTEnsemble._set_tables``, its
``walk_tables_``), not on every call.  It is built by ``cuda_build`` at
first use and loaded through ctypes.
"""

import ctypes
import functools

import numpy as np
import torch

from nimrud_tpu_torch.ops.kernels import cuda_build
from nimrud_tpu_torch.ops.kernels.multiscale_kernel import (
    CUDA_CORE_OPS, HBM_BYTES, check_launch, check_tensors)
from nimrud_tpu_torch.utils import profiling

# the kernel's register instances: padded table-row widths (floats); a
# row holds the D vector entries, zeros, and the split in its last slot.
# Wider rows, or forests of more trees or classes, take the wide kernel.
WIDTHS = (4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 56, 64)
MAX_TREES = 64
MAX_CLASSES = 16
# the dense tables' budget: 2 ** (depth + 2) <= 65536 nodes a tree
MAX_NODES = 1 << 16
WMEAN_EPS = float(np.float32(np.spacing(32)))
D_FUNCS = ("wmean", "wmax")
WALK_KEYS = ("walk_vecs", "walk_stats")


def padded_width(dim):
    """Floats a packed table row takes for ``dim`` features: the
    smallest register instance above ``dim`` (the split needs one slot
    more), or beyond the widest the next multiple of 4."""
    for width in WIDTHS:
        if width > dim:
            return width
    return -(-(dim + 1) // 4) * 4


def instance(tables):
    """The kernel a call on these packed ``tables`` launches:
    ``forest_walk_kernel<width>`` (the feature row in registers) or
    ``forest_walk_wide_kernel``."""
    n_trees, _, width = tables["walk_vecs"].shape
    if width in WIDTHS and n_trees <= MAX_TREES \
            and tables["walk_stats"].shape[2] - 1 <= MAX_CLASSES:
        return f"forest_walk_kernel<{width}>"
    return "forest_walk_wide_kernel"


def pack_tables(tables):
    """A forest's dense tables (``dense_splits`` (T, S), ``dense_vecs``
    (T, S, D), ``dense_ginis`` (T, S), ``dense_props`` (T, S, C)) with
    the kernel's packing of them added, on their device: ``walk_vecs``
    (T, S, :func:`padded_width` (D)) with the vector in slots [0, D),
    zeros, and the split in the last slot; ``walk_stats`` (T, S, 1 + C),
    gini then the proportions."""
    dvecs = tables["dense_vecs"]
    n_trees, size, dim = dvecs.shape
    vecs = torch.zeros((n_trees, size, padded_width(dim)),
                       dtype=torch.float32, device=dvecs.device)
    vecs[:, :, :dim] = dvecs
    vecs[:, :, -1] = tables["dense_splits"]
    stats = torch.cat([tables["dense_ginis"][:, :, None],
                       tables["dense_props"]], dim=2).to(torch.float32)
    return dict(tables, walk_vecs=vecs, walk_stats=stats.contiguous())


def walk_dense_codes(tables, data, max_depth):
    """All trees walked together over the dense tables: the tree axis
    folds into the gather index and the split rides each projection row
    as one more column, so a level is one row gather of (trees, points,
    dim + 1).  Every level to ``max_depth`` runs (no early exit, so no
    host synchronization): pairs at a leaf stay frozen.  Returns each
    (tree, point) pair's last branch code and whether it stands at a
    leaf there (trees, points)."""
    dsplits, dvecs = tables["dense_splits"], tables["dense_vecs"]
    n_trees, size, dim = dvecs.shape
    batch = data.shape[0]
    fvecs = torch.cat([dvecs, dsplits[:, :, None]], dim=2).reshape(
        n_trees * size, dim + 1)
    offs = (torch.arange(n_trees, device=data.device) * size)[:, None]
    tag = torch.ones((n_trees, batch), dtype=torch.int64, device=data.device)
    done = torch.zeros((n_trees, batch), dtype=torch.bool,
                       device=data.device)
    for _ in range(max_depth + 1):
        row = fvecs[(offs + torch.clamp(tag, max=size - 1)).reshape(-1)]
        row = row.reshape(n_trees, batch, dim + 1)
        split = row[:, :, dim]
        done = done | torch.isinf(split)
        projection = (data[None] * row[:, :, :dim]).sum(2)
        next_tag = (tag << 1) | (projection > split).to(torch.int64)
        tag = torch.where(done, tag, next_tag)
    return tag, done


def walk_dense_plain(tables, data, max_depth):
    """The forest's leaves for feature rows ``data`` (points, dim)
    (:func:`walk_dense_codes`; a pair at no leaf reads node 0), as gini
    (trees, points) and proportions (trees, points, classes): gini rides
    the proportion rows, so the leaves are one row gather."""
    tag, done = walk_dense_codes(tables, data, max_depth)
    n_trees, size = tables["dense_splits"].shape
    stats = torch.cat([tables["dense_ginis"][:, :, None],
                       tables["dense_props"]], dim=2).reshape(
        n_trees * size, -1)
    offs = (torch.arange(n_trees, device=data.device) * size)[:, None]
    node = torch.where(done, tag, 0)
    out = stats[(offs + node).reshape(-1)].reshape(n_trees, data.shape[0],
                                                   -1)
    return out[:, :, 0], out[:, :, 1:]


def decide(gini, proportions, d_func):
    """The decision function over per-tree (gini (trees, points),
    proportions (trees, points, classes)): ``"wmean"``, the proportions
    summed under the weights ``1 - gini`` normalized over the trees, or
    ``"wmax"``, the largest weighted proportion."""
    weights = (1.0 - gini).T[:, :, None]               # (points, trees, 1)
    proportions = proportions.permute(1, 0, 2)         # (points, trees, C)
    if d_func == "wmean":
        weights = weights / (weights.sum(1, keepdim=True) + WMEAN_EPS)
        return (proportions * weights).sum(1)
    if d_func == "wmax":
        return (proportions * weights).max(1).values
    raise ValueError(f"unknown decision function {d_func!r}")


def forest_proba_plain(tables, data, max_depth, d_func):
    """Class probabilities (points, classes) of feature rows ``data``
    (points, dim) under a forest's dense ``tables``, walked ``max_depth
    + 1`` levels, plain PyTorch."""
    return decide(*walk_dense_plain(tables, data, max_depth), d_func)


def check_inputs(tables, data, max_depth, d_func):
    """Raise unless the kernel takes this call: a forest's dense
    ``tables`` with the packing of :func:`pack_tables`, within the dense
    budget; ``data`` (points, D) float32 and contiguous like the
    packing, on its device, with the forest's D features; a walk that
    stays inside the tables (``2 ** (max_depth + 2) <= size``); a known
    decision function."""
    if d_func not in D_FUNCS:
        raise ValueError(f"unknown decision function {d_func!r}")
    if any(key not in tables for key in WALK_KEYS):
        raise ValueError("the walk kernel reads the packing of "
                         "forest_walk.pack_tables")
    vecs, stats = tables["walk_vecs"], tables["walk_stats"]
    dim = tables["dense_vecs"].shape[2]
    if vecs.dim() != 3 or stats.dim() != 3 \
            or stats.shape[:2] != vecs.shape[:2] \
            or vecs.shape[:2] != tables["dense_vecs"].shape[:2]:
        raise ValueError("packed tables must be walk_vecs (T, S, Dpad) and "
                         "walk_stats (T, S, 1 + C) of the dense tables")
    n_trees, size, width = vecs.shape
    if size > MAX_NODES:
        raise ValueError(f"{size} nodes a tree: outside the dense walk's "
                         f"budget of {MAX_NODES}")
    if stats.shape[2] < 2:
        raise ValueError("the packed statistics hold no class")
    if width != padded_width(dim):
        raise ValueError(f"packed rows of {width} floats for {dim} "
                         f"features: {padded_width(dim)} expected")
    if data.dim() != 2 or data.shape[1] != dim:
        raise ValueError(f"data must be (points, {dim}), got "
                         f"{tuple(data.shape)}")
    if max_depth < 0 or (1 << (max_depth + 2)) > size:
        raise ValueError(f"a walk of {max_depth + 1} levels leaves tables "
                         f"of {size} nodes")
    check_tensors(vecs.device, data=data, vecs=vecs, stats=stats)
    if vecs.data_ptr() % 16:
        raise ValueError("packed vecs must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.library("forest_walk").forest_walk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    return fn


def forest_proba(tables, data, max_depth, d_func):
    """Class probabilities (points, classes) of feature rows ``data``
    (points, dim) under a forest's dense ``tables`` (see
    :func:`forest_proba_plain`).  CPU tensors take the plain version;
    CUDA tensors launch the Hopper kernel on the tables' packing
    (:func:`pack_tables`) or raise."""
    if "dense_splits" not in tables:
        raise ValueError("the forest walk needs the dense tables: the "
                         "forest is outside the dense budget")
    if data.device.type == "cpu":
        return forest_proba_plain(tables, data, max_depth, d_func)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    check_inputs(tables, data, max_depth, d_func)
    vecs, stats = tables["walk_vecs"], tables["walk_stats"]
    n_trees, size, width = vecs.shape
    n_classes = stats.shape[2] - 1
    out = torch.empty((data.shape[0], n_classes), dtype=torch.float32,
                      device=data.device)
    if data.shape[0] == 0:
        return out
    check_launch("forest_walk", _launcher()(
        data.data_ptr(), vecs.data_ptr(), stats.data_ptr(), out.data_ptr(),
        data.shape[0], data.shape[1], width, n_classes, n_trees, size,
        int(max_depth), int(d_func == "wmax"), WMEAN_EPS,
        data.device.index or 0,
        torch.cuda.current_stream(data.device).cuda_stream))
    forest_proba.launches += 1
    profiling.count("walk_launches", 1)
    return out


forest_proba.launches = 0


def forest_walk_work(tables, data, max_depth):
    """The least time an H100 could take for one call on packed
    ``tables``: the larger of the CUDA-core operations (D products, D -
    1 sums and a compare at each internal node visited; the decision's 2
    + 2C a pair) and the bytes moved once through HBM (the rows, the
    answers, and the table rows the walk touches: the packed row of
    every distinct node it reads, the statistics row of every distinct
    leaf).  Also ``row_bytes``: the table rows the walk reads, a packed
    row a node visited, the traffic the kernel takes from L1 / L2.  The
    visits come from the plain walk (:func:`walk_dense_codes`): a pair
    at a leaf read its code's ancestors and the leaf, a pair at no leaf
    the ancestors of its last code."""
    vecs, stats = tables["walk_vecs"], tables["walk_stats"]
    n_rows, dim = data.shape
    n_trees, size, width = vecs.shape
    n_classes = stats.shape[2] - 1
    tag, done = walk_dense_codes(tables, data, max_depth)
    # a pair's internal nodes: the bits of its last code below the root's
    internal = int(torch.log2(tag.double()).floor().sum())
    leaves = int(done.sum())
    offs = (torch.arange(n_trees, device=data.device) * size)[:, None]
    read = torch.zeros(n_trees * size, dtype=torch.bool, device=data.device)
    for shift in range(max_depth + 2):
        code = tag >> shift
        seen = (code > 0) & (done | (shift > 0))
        read[(offs + code)[seen]] = True
    leaf_rows = torch.zeros_like(read)
    leaf_rows[(offs + torch.where(done, tag, 0)).reshape(-1)] = True
    n_bytes = 4 * (data.numel() + n_rows * n_classes
                   + width * int(read.sum())
                   + (1 + n_classes) * int(leaf_rows.sum()))
    ops = internal * 2 * dim + n_rows * n_trees * (2 + 2 * n_classes)
    terms = {"operations": ops / CUDA_CORE_OPS, "bytes": n_bytes / HBM_BYTES}
    term = max(terms, key=terms.get)
    return {"pairs": n_rows * n_trees, "internal": internal,
            "leaves": leaves, "row_bytes": 4 * width * (internal + leaves),
            "table_bytes": n_bytes - 4 * (data.numel() + n_rows * n_classes),
            "terms_ms": {k: 1e3 * v for k, v in terms.items()},
            "bound_ms": 1e3 * terms[term], "bound_term": term}
