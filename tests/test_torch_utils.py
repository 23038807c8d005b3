"""
The port's host utilities against the JAX package's on the same seeded
inputs, on the CPU: ``utils.generic``, ``utils.geometry`` (the voxel
filter and the three partitioners), ``utils.point_clouds``,
``learning.metrics``, ``utils.memory`` and ``device_grid.packed_cap``.
Each case runs the reference test's body through both packages: the
outputs compare equal, and the reference test's asserts hold for the
port's.
"""

from itertools import product

import numpy as np
import pytest
import torch

from nimrud_tpu.learning import metrics as jmet
from nimrud_tpu.utils import generic as jgen
from nimrud_tpu.utils import geometry as jgeo
from nimrud_tpu.utils import memory as jmem
from nimrud_tpu.utils import point_clouds as jpc

from nimrud_tpu_torch.learning import metrics as tmet
from nimrud_tpu_torch.utils import generic as tgen
from nimrud_tpu_torch.utils import geometry as tgeo
from nimrud_tpu_torch.utils import memory as tmem
from nimrud_tpu_torch.utils import point_clouds as tpc


def _equal(a, b):
    """Nested outputs (arrays, tuples, lists, scalars) equal."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# -- generic -------------------------------------------------------------------

def test_generic_equal():
    data = np.arange(25).reshape(-1, 1)
    for arg in (data, list(range(7))):
        _equal(list(tgen.batcher(arg, 3)), list(jgen.batcher(arg, 3)))
    assert list(tgen.batcher(iter(range(7)), 3)) == [[0, 1, 2], [3, 4, 5],
                                                     [6]]
    assert list(tgen.batcher(iter(range(6)), 3)) == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError):
        list(tgen.batcher([1, 2, 3], 0))
    for v in (0, 1, 8, 9):
        assert tgen.round_up(v, 8) == jgen.round_up(v, 8)
    _equal(tgen.pad_rows(np.ones((3, 2)), 5),
           jgen.pad_rows(np.ones((3, 2)), 5))
    with pytest.raises(ValueError):
        tgen.pad_rows(np.ones((3, 2)), 2)


# -- geometry ------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_voxel_filter_equal(dim):
    rng = np.random.default_rng(10)
    points = rng.random((1000, dim)) * 100
    ref, port = jgeo.VoxelFilter(points, 0.5), tgeo.VoxelFilter(points, 0.5)
    for name in ("minimum_corner", "maximum_corner", "shifts", "widths"):
        _equal(getattr(port, name), getattr(ref, name))
    assert port.masks == ref.masks
    addresses = port.coordinate_to_address(points)
    _equal(addresses, ref.coordinate_to_address(points))
    _equal(port.address_to_coordinate(addresses),
           ref.address_to_coordinate(addresses))
    _equal(port.unique_voxels(points), ref.unique_voxels(points))
    for bad in (rng.random((1, dim)), rng.random((10, 4)), rng.random(10)):
        with pytest.raises(ValueError):
            tgeo.VoxelFilter(bad, 0.5)
    with pytest.raises(ValueError):
        tgeo.VoxelFilter(np.asarray([[0, 0, 0], [100, 100, 100]])[:, :dim],
                         1e-5 if dim == 3 else 1e-8)
    with pytest.raises(ValueError):
        port._check_in_bounds(np.zeros((1, dim)) - 1.0)


def test_voxel_neighbors_equal():
    bounds = np.asarray([[0, 0, 0], [10, 10, 10]])
    ref, port = jgeo.VoxelFilter(bounds, 1.0), tgeo.VoxelFilter(bounds, 1.0)
    wide = tgeo.VoxelFilter(np.asarray([[0, 0, 0], [100, 100, 100]]), 1)
    assert wide.coordinate_to_address(np.arange(3) + 10) == 198026
    for point, full, facing in (([5.0, 5.0, 5.0], 26, 6),
                                ([-0.4, -0.4, -0.4], 7, 3)):
        address = port.coordinate_to_address(np.asarray([point]))
        got = port.find_neighbors(address)
        _equal(got, ref.find_neighbors(address))
        assert np.unique(got).size == full
        got = port.find_facing_neighbors(address)
        _equal(got, ref.find_facing_neighbors(address))
        assert np.unique(got).size == facing


def test_nested_regions_equal():
    rng = np.random.default_rng(11)
    query = rng.random((5000, 3))
    search = rng.random((20000, 3)) * 3 - 1
    for low, high in ((np.full(3, 0.25), np.full(3, 0.75)),
                      (np.full(3, 100.0), np.full(3, 110.0))):
        got = tgeo.nested_regions(query, search, 0.5, low, high)
        _equal(got, jgeo.nested_regions(query, search, 0.5, low, high))
    q_idx, s_idx = got
    assert q_idx.size == 0 and s_idx.size == 0


@pytest.mark.parametrize("algorithm", ["naive", "take_one", "take_three"])
def test_octree_cube_generators_equal(algorithm):
    rng = np.random.default_rng(12)
    query = rng.random((1000, 3))
    search = rng.random((4000, 3)) * 2 - 0.5
    query[0] *= 0
    query[1] = 1.0
    got = list(tgeo.NestedOctree(query, search, 0.1).cube_generator(
        0.5, algorithm=algorithm))
    want = list(jgeo.NestedOctree(query, search, 0.1).cube_generator(
        0.5, algorithm=algorithm))
    assert len(got) == 8
    _equal(got, want)
    with pytest.raises(NameError):
        list(tgeo.NestedOctree(query, search, 0.1).cube_generator(
            0.5, algorithm="bogus"))


def _partitions(cls_port, cls_ref, *args, partition=None):
    port, ref = cls_port(*args), cls_ref(*args)
    if partition is not None:
        port.partition(*partition)
        ref.partition(*partition)
    got = list(port.partition_generator())
    _equal(got, list(ref.partition_generator()))
    return got


def test_octree_and_grid_partitions_equal():
    rng = np.random.default_rng(13)
    query, search = rng.random((4000, 3)) * 8, rng.random((8000, 3)) * 8
    got = _partitions(tgeo.NestedOctree, jgeo.NestedOctree, query, search,
                      0.25, partition=(1500,))
    assert len(got) > 1 and all(s.size <= 1500 for _, s in got)
    seen = np.zeros(len(query), int)
    for q_idx, _ in got:
        seen[q_idx] += 1
    assert (seen >= 1).all()
    # small region relative to the buffer: the octree hands off to grids
    got = _partitions(tgeo.NestedOctree, jgeo.NestedOctree,
                      rng.random((3000, 3)), rng.random((6000, 3)), 0.2,
                      partition=(2500,))
    assert all(s.size <= 2500 for _, s in got)
    got = _partitions(tgeo.NestedGrid, jgeo.NestedGrid,
                      rng.random((3000, 3)) * 4, rng.random((9000, 3)) * 4,
                      0.1, 2000)
    assert all(s.size <= 2000 for _, s in got)
    cloud = np.random.default_rng(1).random((5000, 3)) * 100
    got = _partitions(tgeo.NestedOctree, jgeo.NestedOctree, cloud, cloud,
                      3.0, partition=(300,))
    covered = np.zeros(len(cloud), bool)
    for q_idx, _ in got:
        covered[q_idx] = True
    assert covered.all()
    with pytest.raises(ValueError):
        tgeo.NestedOctree(cloud, cloud, -1.0)


def test_procedural_partitioner_equal():
    rng = np.random.default_rng(3)
    query, search = rng.random((2000, 3)) * 6, rng.random((5000, 3)) * 6
    got = _partitions(tgeo.ProceduralNestedPartitioner,
                      jgeo.ProceduralNestedPartitioner, query, search, 0.5,
                      800)
    assert len(got) > 1
    seen = np.zeros(len(query), int)
    for q_idx, _ in got:
        seen[q_idx] += 1
    assert (seen == 1).all()


# -- point clouds --------------------------------------------------------------

def test_flex_cloud_equal():
    rng = np.random.default_rng(14)
    points = rng.random((1000, 3))
    ref, port = jpc.FlexCloud(points), tpc.FlexCloud(points)
    asset = rng.random((100, 2))
    idx = rng.permutation(1000)[:100]
    for fc in (ref, port):
        fc.add_asset(asset, idx, "a")
        fc.add_asset(np.vstack([asset, asset]), np.hstack([idx, idx]), "b")
        fc.add_asset(rng.random(100) * 0 + 1.0, np.arange(100) + 50, "c")
    for name in ("a", "b", "c"):
        _equal(port.assets[name]["asset"], ref.assets[name]["asset"])
        _equal(port.assets[name]["index"], ref.assets[name]["index"])
    _equal(port.intersection(["a", "c"]), ref.intersection(["a", "c"]))
    _equal(port.take(idx), ref.take(idx))
    _equal(port.take(original_coordinates=False),
           ref.take(original_coordinates=False))
    assert port.asset_names() == ref.asset_names() == ["a", "b", "c"]
    port.remove_asset("a")
    assert "a" not in port
    for bad in (rng.random((10, 2)), rng.random(3)):
        with pytest.raises(ValueError):
            tpc.FlexCloud(bad)
    with pytest.raises(ValueError):
        port.add_asset(asset, idx + 1000, "bad")
    fc = tpc.FlexCloud(points)
    fc.add_asset(np.ones(10), np.arange(10), "x")
    fc.add_asset(np.ones((10, 2)), np.arange(10) + 100, "y")
    idx, block = fc.intersection(["x", "y"])
    assert idx.size == 0 and block.shape == (0, 3)


# -- metrics -------------------------------------------------------------------

def test_metrics_equal():
    known = np.array([0, 0, 1, 1, 2, 2])
    pred = np.array([0, 1, 1, 1, 2, 0])
    conf = tmet.mc_confusion(pred, known)
    _equal(conf, jmet.mc_confusion(pred, known))
    assert np.array_equal(conf, [[1, 0, 1], [1, 2, 0], [0, 0, 1]])
    square = np.array([[8., 2.], [2., 8.]])
    _equal(tmet.user_producer(square), jmet.user_producer(square))
    balanced = np.array([[9., 1.], [1., 9.]])
    _equal(tmet.three_metrics(balanced), jmet.three_metrics(balanced))
    with pytest.raises(ValueError, match="balanced"):
        tmet.three_metrics(np.array([[9., 1.], [1., 19.]]))
    labels = np.array([0, 0, 0, 1, 1, 1], dtype=float)
    guess = np.array([0, 0, 1, 1, 1, 0], dtype=float)
    _equal(tmet.confusion(guess, labels), jmet.confusion(guess, labels))
    assert tmet.confusion(guess, labels)[0] == pytest.approx(100 * 2 / 3)
    rng = np.random.default_rng(15)
    cloud = np.hstack([rng.random((10, 3)), rng.integers(0, 3, (10, 1))])
    probs = rng.random((10, 3))
    _equal(tmet.colorize_multiclass(cloud), jmet.colorize_multiclass(cloud))
    _equal(tmet.colorize_mc_prob(cloud, probs),
           jmet.colorize_mc_prob(cloud, probs))
    _equal(tmet.dilate_scale(balanced, 2), jmet.dilate_scale(balanced, 2))
    _equal(tmet.COLOR_MATRIX, jmet.COLOR_MATRIX)


# -- memory --------------------------------------------------------------------

SCALESETS = ([(0.3, (1.0,))], [(0.25, (0.5,)), (0.5, (1.0,)), (1.0, (2.0,))],
             [(0.0, (0.8, 0.4))])


@pytest.mark.parametrize("scaleset", SCALESETS)
def test_memory_projection_equal(scaleset):
    for n_query, n_search, kwargs in (
            (1000, 1000, {}), (1_000_000, 1_000_000, {}),
            (50_000, 200_000, {"bounds_span": (100.0, 100.0, 9.0)}),
            (10_000_000, 10_000_000, {"q_cap": 128, "m": 2, "n_attr": 2})):
        assert tmem.projected_fused_bytes(n_query, n_search, scaleset,
                                          **kwargs) \
            == jmem.projected_fused_bytes(n_query, n_search, scaleset,
                                          **kwargs)
    for budget in (64 * 1024 ** 3, 2 * 1024 ** 3, 32 * 1024 ** 2):
        assert tmem.auto_partition_population(
            1_000_000, 1_000_000, scaleset, budget=budget) \
            == jmem.auto_partition_population(
                1_000_000, 1_000_000, scaleset, budget=budget)


def test_memory_budget_decisions():
    # tests/test_workflows.py:135-145: a generous budget runs in one piece,
    # and projections are monotone in cloud size
    assert tmem.auto_partition_population(
        20_000, 20_000, [(0.3, (1.0,))], budget=64 * 1024 ** 3) is None
    small = tmem.projected_fused_bytes(1000, 1000, [(0.3, (1.0,))])
    big = tmem.projected_fused_bytes(1_000_000, 1_000_000, [(0.3, (1.0,))])
    assert big > small > 0
    assert tmem.device_hbm_budget("cpu") == jmem.DEFAULT_HBM_BUDGET \
        == tmem.DEFAULT_HBM_BUDGET
    assert tmem.auto_partition_population(
        1_000_000, 1_000_000, [(0.3, (1.0,))], device="cpu") \
        == jmem.auto_partition_population(
            1_000_000, 1_000_000, [(0.3, (1.0,))],
            budget=jmem.DEFAULT_HBM_BUDGET)
    with pytest.raises(ValueError):
        tmem.device_hbm_budget("meta")


# -- packed_cap ----------------------------------------------------------------

def test_packed_cap_equal():
    # the case of tests/test_pallas_kernel.py:179-197
    import jax.numpy as jnp
    from nimrud_tpu.ops import device_grid as jdg
    from nimrud_tpu.ops import packing as jpk
    from nimrud_tpu.ops import unique as jun
    from nimrud_tpu_torch.ops import device_grid as tdg
    from nimrud_tpu_torch.ops import packing as tpk
    from nimrud_tpu_torch.ops import unique as tun

    rng = np.random.default_rng(22)
    pts = (rng.random((4000, 3)) * 6).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    padded = np.vstack([pts, np.zeros((96, 3), np.float32)])
    kwargs = dict(n_query=4096, voxel_edge=0.2, q_cap=64, x_seg=4)
    spec = jdg.make_spec(lo, hi, 0.8, **kwargs)
    q, qv = jnp.asarray(padded), jnp.arange(4096) < 4000
    centers, _, mask = jun.unique_voxels(
        q, jpk.GridSpec.fit_bounds(lo, hi, 0.2), valid=qv)
    t_spec = tdg.make_spec(lo, hi, 0.8, **kwargs)
    tq, tqv = torch.as_tensor(padded), torch.arange(4096) < 4000
    t_centers, _, t_mask = tun.unique_voxels(
        tq, tpk.GridSpec.fit_bounds(lo, hi, 0.2), valid=tqv)
    assert int(tdg._max_candidates(tq, tqv, t_centers, t_mask, t_spec)) \
        == int(jdg._max_candidates(q, qv, centers, mask, spec))
    for margin in (1.0, 1.25, 2.0):
        cap = tdg.packed_cap(tq, tqv, t_centers, t_mask, t_spec,
                             margin=margin)
        assert cap == jdg.packed_cap(q, qv, centers, mask, spec,
                                     margin=margin)
        assert cap % 128 == 0 and cap >= 128
    # at the measured cap nothing drops; below it the drop is counted
    _, full = tdg.fused_extract_packed(
        tq, tqv, t_centers, t_mask, t_spec, (0.8,), "minimal", 4096,
        tdg.packed_cap(tq, tqv, t_centers, t_mask, t_spec, margin=1.0),
        with_stats=True)
    assert int(full["dropped_candidates"]) == 0
    _, tight = tdg.fused_extract_packed(
        tq, tqv, t_centers, t_mask, t_spec, (0.8,), "minimal", 4096, 128,
        with_stats=True)
    assert int(tight["dropped_candidates"]) > 0


def test_cube_bounds_cover_the_reference_corners():
    # the octree's cube corners are the reference's, offsets in
    # itertools.product order
    rng = np.random.default_rng(16)
    query = rng.random((100, 3))
    port = tgeo.NestedOctree(query, query, 0.1)
    lows, highs = port._cube_bounds(0.5)
    want = np.asarray(list(product((0, 1), repeat=3))) * 0.5 + query.min(0)
    _equal(lows, want)
    _equal(highs, want + 0.5)
