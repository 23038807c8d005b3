"""
The forest walk's kernel wrapper (``ops/kernels/forest_walk.py``) on the
CPU, where no card is needed:

* the packed tables the kernel reads equal the dense tables they come
  from (vectors, zero pad, the split in the last slot, gini and
  proportions), for a device fit and drawn forests of several widths;
* the forest's own calls on CPU tensors still take the plain walk (no
  launch), whose probabilities the tables' packing leaves unchanged;
  the serving parameters carry the packing built when the tables were
  installed, not a new one;
* the wrapper's checks raise on what the kernel does not take: a wrong
  dtype, shape or layout of the rows, rows of another width than the
  forest's, tables without their packing or packed for another width,
  forests past the dense budget, a walk past the tables, another
  device; and take forests of any width, tree count and class count;
* the work reckoning counts the nodes the walk visits and the distinct
  table rows it reads.

The walk on the card is held against the plain walk by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from nimrud_tpu_torch.learning import rpt as trpt
from nimrud_tpu_torch.ops.kernels import cuda_build
from nimrud_tpu_torch.ops.kernels import forest_walk as fw
from nimrud_tpu_torch.utils import checks, workload
from torch_rpt_cases import forest_data
from torch_thread_cases import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def device_fit():
    x, y = forest_data(3000, 0)
    return trpt.RPTEnsemble(seed=0, device="cpu").fit_device(
        torch.from_numpy(x), y, n_classes=3)


def _check_packing(tables):
    dim = tables["dense_vecs"].shape[2]
    vecs, stats = tables["walk_vecs"], tables["walk_stats"]
    assert vecs.shape[2] == fw.padded_width(dim) > dim
    assert vecs.is_contiguous() and stats.is_contiguous()
    assert torch.equal(vecs[:, :, :dim], tables["dense_vecs"])
    assert not vecs[:, :, dim:-1].any()
    assert torch.equal(vecs[:, :, -1], tables["dense_splits"])
    assert torch.equal(stats[:, :, 0], tables["dense_ginis"])
    assert torch.equal(stats[:, :, 1:], tables["dense_props"])


def test_packed_tables_equal_the_device_fit(device_fit):
    walk = device_fit.walk_tables_
    assert walk["walk_vecs"].shape == (10, 1 << 16, 16)
    assert fw.instance(walk) == "forest_walk_kernel<16>"
    for key, value in device_fit._tables.items():
        assert walk[key] is value, key
    _check_packing(walk)


@pytest.mark.parametrize("dim", [1, 3, 4, 11, 12, 24, 31, 63, 64, 70])
def test_packed_tables_equal_drawn_tables(dim):
    tables, _ = checks.drawn_forest(dim, 3, 4, dim, 5, 1)
    packed = fw.pack_tables(tables)
    _check_packing(packed)
    width = packed["walk_vecs"].shape[2]
    assert (width in fw.WIDTHS) == (dim < fw.WIDTHS[-1])
    assert (fw.instance(packed) == "forest_walk_wide_kernel") \
        == (dim >= fw.WIDTHS[-1])
    assert width % 4 == 0


def test_cpu_rows_take_the_plain_walk(device_fit):
    x = torch.from_numpy(forest_data(500, 1)[0])
    before = fw.forest_proba.launches
    got = device_fit.proba_device(x)
    assert fw.forest_proba.launches == before
    want = fw.forest_proba_plain(device_fit._tables, x,
                                 device_fit.walk_depth_, "wmean")
    assert torch.equal(got, want)
    # the forest built from the same tables packs them again, equal
    again = trpt.RPTEnsemble.from_tables(
        {k: v.numpy() for k, v in device_fit._tables.items()},
        device_fit.max_depth_, "wmean", "cpu")
    for key, value in device_fit.walk_tables_.items():
        assert torch.equal(again.walk_tables_[key], value), key
    # a host fit deep enough to keep sparse tables only has no packing
    sparse = trpt.RPTEnsemble(seed=0, device="cpu").fit(
        *forest_data(3000, 0))
    assert "dense_splits" not in sparse._tables
    assert sparse.walk_tables_ is sparse._tables
    assert sparse.proba_device(x).shape == (500, 3)


def test_serving_parameters_carry_the_installed_packing(device_fit):
    cloud, _ = workload.make_bench_cloud(2000, seed=0)
    model = workload.make_bench_model(cloud, device="cpu")
    model.classifier = device_fit
    params = model._fused_classifier()
    assert params["tables"].keys() == device_fit.walk_tables_.keys()
    for key, value in device_fit.walk_tables_.items():
        assert params["tables"][key] is value, key


def _inputs(dim=12, trees=3, classes=4, rows=8, depth=4):
    tables, feats = checks.drawn_forest(0, trees, depth, dim, classes, rows)
    return fw.pack_tables(tables), feats, depth


def _break(case):
    """The arguments of one call the kernel does not take."""
    packed, feats, depth = _inputs()
    d_func = "wmean"
    if case == "dtype":
        feats = feats.double()
    elif case == "shape":
        feats = feats[:, :11].contiguous()
    elif case == "rank":
        feats = feats[None]
    elif case == "layout":
        feats = torch.cat([feats, feats], 1)[:, ::2]
    elif case == "d_func":
        d_func = "mean"
    elif case == "depth":
        depth += 1
    elif case == "trees":
        packed = dict(packed, walk_stats=packed["walk_stats"][1:])
    elif case == "classes":
        packed = dict(packed, walk_stats=packed["walk_stats"][:, :, :1])
    elif case == "width":
        packed = dict(packed, walk_vecs=torch.zeros((3, 64, 32)))
    elif case == "stats":
        packed = dict(packed, walk_stats=packed["walk_stats"][:, :-1])
    elif case == "budget":
        size = 2 * fw.MAX_NODES
        packed = fw.pack_tables({
            "dense_splits": torch.zeros((1, size)),
            "dense_vecs": torch.zeros((1, size, 12)),
            "dense_ginis": torch.zeros((1, size)),
            "dense_props": torch.zeros((1, size, 4))})
    elif case == "features":
        # a 12-feature forest packs to rows of 16: 13 features fit the
        # pad, and would multiply its zeros
        feats = torch.cat([feats, feats[:, :1]], 1)
    elif case == "unpacked":
        packed = {k: v for k, v in packed.items() if k not in fw.WALK_KEYS}
    return packed, feats, depth, d_func


@pytest.mark.parametrize("case", ["dtype", "shape", "rank", "layout",
                                  "d_func", "depth", "trees", "classes",
                                  "width", "stats", "budget", "features",
                                  "unpacked"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    packed, feats, depth, d_func = _break(case)
    with pytest.raises((ValueError, TypeError)):
        fw.check_inputs(packed, feats, depth, d_func)


def test_wrapper_takes_a_sound_call_and_refuses_other_forests():
    packed, feats, depth = _inputs()
    fw.check_inputs(packed, feats, depth, "wmax")
    with pytest.raises(ValueError, match="dense"):
        fw.forest_proba({"tags": None}, feats, depth, "wmean")
    with pytest.raises(ValueError, match="unsupported device"):
        fw.forest_proba(packed, feats.to("meta"), depth, "wmean")


@pytest.mark.parametrize("dim,trees,classes,kernel", [
    (63, 64, 16, "forest_walk_kernel<64>"),
    (64, 3, 4, "forest_walk_wide_kernel"),
    (100, 100, 20, "forest_walk_wide_kernel"),
    (12, 65, 4, "forest_walk_wide_kernel"),
    (12, 3, 17, "forest_walk_wide_kernel")])
def test_wrapper_takes_any_width_tree_and_class_count(dim, trees, classes,
                                                      kernel):
    packed, feats, depth = _inputs(dim=dim, trees=trees, classes=classes)
    fw.check_inputs(packed, feats, depth, "wmean")
    assert fw.instance(packed) == kernel


@pytest.mark.parametrize("depth,walk", [(0, 0), (1, 1), (5, 5), (5, 2)])
def test_work_counts_the_nodes_visited(depth, walk):
    tables, feats = checks.drawn_forest(depth, 4, depth, 6, 3, 300)
    packed = fw.pack_tables(tables)
    internal = leaves = 0
    nodes, leaf_rows = set(), set()
    for t in range(4):
        for x in feats:
            code, level = 1, 0
            while level <= walk:
                nodes.add((t, code))
                split = tables["dense_splits"][t, code]
                if torch.isinf(split):
                    leaves += 1
                    leaf_rows.add((t, code))
                    break
                internal += 1
                proj = (x * tables["dense_vecs"][t, code]).sum()
                code, level = 2 * code + int(proj > split), level + 1
            else:
                leaf_rows.add((t, 0))
    work = fw.forest_walk_work(packed, feats, walk)
    assert (work["internal"], work["leaves"]) == (internal, leaves)
    assert work["row_bytes"] == 4 * 8 * (internal + leaves)
    assert work["table_bytes"] == 4 * (8 * len(nodes) + 4 * len(leaf_rows))
    assert work["bound_ms"] == max(work["terms_ms"].values())
    assert np.isclose(work["terms_ms"]["operations"], 1e3 * (
        internal * 12 + 300 * 4 * 8) / fw.CUDA_CORE_OPS)
    assert np.isclose(work["terms_ms"]["bytes"], 1e3 * (
        4 * 300 * (6 + 3) + work["table_bytes"]) / fw.HBM_BYTES)


def test_kernel_names_read_from_the_mangled_symbols():
    # chip_smoke.py counts the walk's instances by their kernel_name
    names = {
        "_ZN47_GLOBAL__N__89331e8f_14_forest_walk_cu_731a7ecb18forest_walk"
        "_kernelILi16EEEvPKfS2_S2_Pfxiiiiiif": "forest_walk_kernel<16>",
        "_ZN47_GLOBAL__N__89331e8f_14_forest_walk_cu_731a7ecb23forest_walk"
        "_wide_kernelEPKfS1_S1_Pfxiiiiiiif": "forest_walk_wide_kernel"}
    for mangled, name in names.items():
        assert cuda_build.kernel_name(mangled) == name
    assert cuda_build.kernel_name("main") == "main"
