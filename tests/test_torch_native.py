"""
The port's C++ host runtime (``nimrud_tpu_torch.ops.native``) against
its NumPy twins and the reference's ``nimrud_tpu.native``: every one of
the eight functions bit for bit on the same inputs, the tiled plan built
on each, the quantization contract on clouds of exact ties and on a
clustered cloud, at sizes whose pass splits over several workers, with
its pad rows (zeros without points), the library's parallel loops
called from several threads of a process that holds torch (and its
OpenMP runtime), and a failed build that raises.  The reference
comparisons skip where the reference's library does not load (it builds
with ``-march=native`` in place).
"""

import os
import threading

import numpy as np
import pytest
import torch

from nimrud_tpu import native as ref_native
from nimrud_tpu import pipeline as jpl
from nimrud_tpu.ops import grid as jgrid

from nimrud_tpu_torch import pipeline as tpl
from nimrud_tpu_torch.ops import grid as tgrid
from nimrud_tpu_torch.ops import native

RNG_SEED = 10


def _reference():
    """The reference's native module, or skip the comparison with it."""
    if ref_native.lib() is None:
        pytest.skip("the reference's native library is unavailable")
    return ref_native


def _equal(a, b):
    """Arrays equal in dtype, shape and bits (tuples element-wise)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _clustered_cloud(n, seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    ground = rng.random((n // 2, 3)) * [40, 40, 0.2]
    blob = rng.normal([25, 25, 4], [5, 5, 1.5], (n - n // 2, 3))
    return np.vstack([ground, blob]).astype(np.float32)


def _grid(cloud, edge, pad):
    lo = cloud.min(0).astype(np.float64) - pad
    dims = np.maximum(np.ceil(
        ((cloud.max(0).astype(np.float64) + pad) - lo) / edge
    ).astype(np.int64), 1)
    return lo, dims


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_tile_sort_matches_twin_and_reference(factor):
    cloud = _clustered_cloud(20_000)
    lo, dims = _grid(cloud, 0.5, 1e-3)
    got = native.tile_sort(cloud, lo, 0.5, dims, factor)
    assert _equal(got, native.tile_sort(cloud, lo, 0.5, dims, factor,
                                        impl="numpy"))
    # a coarse grid past int32 ids is the one size branch: None
    huge = np.array([1 << 11, 1 << 11, 1 << 10])
    assert native.tile_sort(cloud, lo, 0.5, huge, 1) is None
    assert native.tile_sort(cloud, lo, 0.5, huge, 1, impl="numpy") is None
    assert _equal(got, _reference().tile_sort(cloud, lo, 0.5, dims, factor))


def test_fill_table_over_capacity_tiles():
    rng = np.random.default_rng(1)
    order = rng.permutation(5000).astype(np.int32)
    counts = rng.integers(0, 40, 180)
    starts = np.minimum(np.cumsum(counts) - counts, 5000 - 40)
    wanted = rng.permutation(180)[:150]
    cap = 16                                   # many tiles hold more
    assert (counts[wanted] > cap).sum() > 50
    got = native.fill_table(order, starts, counts, wanted, cap)
    assert got.shape == (151, cap) and (got[-1] == -1).all()
    assert _equal(got, native.fill_table(order, starts, counts, wanted, cap,
                                         impl="numpy"))
    with pytest.raises(ValueError, match="outside order"):
        native.fill_table(order, starts + 5000, counts, wanted, cap)
    assert _equal(got, _reference().fill_table(order, starts, counts,
                                               wanted, cap))


def _edge_tiles(qdims):
    """Coarse tiles at every corner and face of the grid, and some
    inside."""
    qx, qy, qz = (int(d) for d in qdims)
    coords = {(x, y, z) for x in (0, qx - 1) for y in (0, qy - 1)
              for z in (0, qz - 1)}
    coords |= {(qx // 2, 0, qz // 2), (0, qy // 2, qz - 1), (1, 1, 1)}
    return np.array(sorted(x + y * qx + z * qx * qy for x, y, z in coords),
                    np.int64)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_neighbor_tables_at_the_grid_edges(m):
    dims = np.array([10, 7, 5], np.int64)       # not multiples of m = 2, 3
    qdims = -(-dims // m)
    n_grid = int(dims.prod())
    tiles = _edge_tiles(qdims)
    mask = native.mark_neighbors(tiles, dims, qdims, m, n_grid)
    assert mask.dtype == bool and mask.any() and not mask.all()
    assert _equal(mask, native.mark_neighbors(tiles, dims, qdims, m, n_grid,
                                              impl="numpy"))
    assert _equal(mask, _reference().mark_neighbors(tiles, dims, qdims, m,
                                                    n_grid))
    grid_row = np.random.default_rng(2).integers(
        0, 50, n_grid).astype(np.int32)
    rows = native.neighbor_rows(tiles, dims, qdims, m, grid_row, 99)
    assert rows.shape == (len(tiles), (m + 2) ** 3)
    assert (rows == 99).any()                   # neighbors past the edges
    assert _equal(rows, native.neighbor_rows(tiles, dims, qdims, m,
                                             grid_row, 99, impl="numpy"))
    assert _equal(rows, ref_native.neighbor_rows(tiles, dims, qdims, m,
                                                 grid_row, 99))


def test_voxel_unique_on_bounds_off_the_edge_grid():
    cloud = _clustered_cloud(20_000)
    edge = 0.3
    # fixed bounds whose span is no multiple of the edge
    lo = cloud.min(0).astype(np.float64) - 0.37 - edge / 2
    hi = cloud.max(0).astype(np.float64) + 0.53 + edge / 2
    dims = np.maximum(np.ceil((hi - lo) / edge).astype(np.int64), 1)
    got = native.voxel_unique(cloud, lo, edge, dims)
    assert 1000 < len(got) < len(cloud)
    assert _equal(got, native.voxel_unique(cloud, lo, edge, dims,
                                           impl="numpy"))
    empty = np.zeros((0, 3), np.float32)
    assert native.voxel_unique(empty, lo, edge, dims).shape == (0, 3)
    assert native.voxel_unique(empty, lo, edge, dims,
                               impl="numpy").shape == (0, 3)
    assert _equal(got, _reference().voxel_unique(cloud, lo, edge, dims))


def _tie_cloud(n=2048):
    """Points at k + 0.5 steps of 1/64 m on the bounds (0, 65000/64):
    the quantization step is 1/64 exactly, so every coordinate is a
    tie."""
    rng = np.random.default_rng(5)
    steps = rng.integers(0, 64999, (n, 3)) + 0.5
    cloud = (steps / 64).astype(np.float32)
    assert np.array_equal(cloud.astype(np.float64) * 64, steps)
    return cloud, np.zeros(3, np.float32), np.full(3, 65000 / 64, np.float32)


def _hold_quantize(cloud, lo, hi, step, pad_to):
    """The library's quantization of ``cloud`` padded to ``pad_to`` rows,
    held bit for bit to its twin and to the reference, its pad rows to
    the last point's, and the staging contract: the port's upload is the
    reference's, row for row (int16 bits of the uint16 steps,
    dequantization scalars)."""
    n = len(cloud)
    got = native.quantize_u16(cloud, lo, step, pad_to=pad_to)
    assert got.shape == (pad_to, 3) and (got[n:] == got[n - 1]).all()
    assert _equal(got, native.quantize_u16(cloud, lo, step, pad_to=pad_to,
                                           impl="numpy"))
    assert _equal(got, _reference().quantize_u16(cloud, lo, step,
                                                 pad_to=pad_to))
    for impl in native.IMPLS:
        quant, dequant = tpl._quantize_upload(cloud, lo, hi, pad_to, "cpu",
                                              impl=impl)
        ref_quant, ref_dequant = jpl._quantize_upload(cloud, lo, hi, pad_to)
        assert _equal(quant.numpy().view(np.uint16), np.asarray(ref_quant))
        assert _equal(dequant.numpy(), np.asarray(ref_dequant))
    return got


# blocks of 16384 rows on the caller's thread (a ragged block before the
# pad, no pad, a ragged last block), and a bucket of 2M rows, which the
# library splits over two workers where the machine has the CPUs (64
# blocks, 1M rows, a worker at the least)
@pytest.mark.parametrize("n,pad_to", [(2048, 2048), (2000, 2048),
                                      (200_001, 262_144),
                                      (262_144, 262_144),
                                      (300_000, 300_000),
                                      (2_000_001, 2_097_152)])
def test_quantize_ties_round_up_as_the_reference(n, pad_to):
    cloud, lo, hi = _tie_cloud(n)
    got = _hold_quantize(cloud, lo, hi, 1 / 64, pad_to)
    # half to even would move every tie of an even step
    even = np.clip(np.round(cloud.astype(np.float64) * 64), 0, 65535)
    assert (np.any(even != got[:n], axis=1)).sum() > n // 3


@pytest.mark.parametrize("n,pad_to", [(163_845, 262_144),
                                      (5 * 16_384, 131_072),
                                      (3 * 2**20 + 16_389, 2**22)])
def test_quantize_pass_across_blocks(n, pad_to):
    """A clustered cloud on its own bounds, as ``_quantize`` steps it,
    whose last point ends inside a block or on a block's end, the pad
    filling the rest of the blocks; the last case's 4M-row bucket runs
    over up to four workers, the fourth writing points and pad."""
    cloud = _clustered_cloud(n)
    lo, hi = cloud.min(0), cloud.max(0)
    step = float((hi.astype(np.float64) - lo).max()) / 65000.0
    got = _hold_quantize(cloud, lo, hi, step, pad_to)
    assert got[:n].max() == 65000 and got[:n].min() == 0


def test_quantize_no_points_pads_zeros():
    empty = np.zeros((0, 3), np.float32)
    for impl in native.IMPLS:
        got = native.quantize_u16(empty, np.zeros(3), 0.01, pad_to=128,
                                  impl=impl)
        assert _equal(got, np.zeros((128, 3), np.uint16))


def test_minmax3_and_empty_input():
    cloud = _clustered_cloud(10_001)
    got = native.minmax3(cloud)
    assert _equal(got, native.minmax3(cloud, impl="numpy"))
    assert _equal(got, tpl._cloud_bounds(cloud))
    empty = np.zeros((0, 3), np.float32)
    for impl in native.IMPLS:
        with pytest.raises(ValueError, match="empty"):
            native.minmax3(empty, impl=impl)
    assert _equal(got, _reference().minmax3(cloud))
    # the reference has no native bounds for it; its NumPy fallback
    # raises as the port does
    assert ref_native.minmax3(empty) is None
    with pytest.raises(ValueError):
        jpl._cloud_bounds(empty)


@pytest.mark.parametrize("delim", [",", " ", ";", "\t"])
def test_parse_ascii_matches_twin_and_reference(tmp_path, delim):
    cloud = np.random.default_rng(6).random((300, 4)).astype(np.float32)
    path = tmp_path / "cloud.txt"
    np.savetxt(path, cloud * 100, delimiter=delim, fmt="%.5f",
               header="x y z i", comments="# ")
    text = path.read_bytes().replace(b"\n", b"\r\n", 7) + b"\n# tail\n"
    got = native.parse_ascii(text)
    assert got.shape == (300, 4)
    assert np.allclose(got, cloud * 100, atol=1e-3)
    assert _equal(got, native.parse_ascii(text, impl="numpy"))
    for impl in native.IMPLS:
        with pytest.raises(ValueError, match="malformed"):
            native.parse_ascii(b"1 2 3\n4 five 6\n", impl=impl)
        with pytest.raises(ValueError, match="no data"):
            native.parse_ascii(b"# only a comment\n\n", impl=impl)
    path.write_bytes(text)
    assert _equal(got, _reference().ascii_loader.load(str(path)))


@pytest.mark.parametrize("m", [1, 2, 3])
def test_build_tiled_problem_native_twin_reference(m):
    cloud = _clustered_cloud(60_000)
    centers = cloud[::3].copy()
    kwargs = dict(query_tile_factor=m, query_capacity=32, entry_batch=64)
    got = tgrid.build_tiled_problem(cloud, centers, 0.7, **kwargs)
    twin = tgrid.build_tiled_problem(cloud, centers, 0.7, impl="numpy",
                                     **kwargs)
    ref = jgrid.build_tiled_problem(cloud, centers, 0.7, **kwargs)
    for field in ("query_index", "neighbor_rows", "candidates",
                  "entry_centers"):
        assert _equal(getattr(got, field), getattr(twin, field)), field
        assert _equal(getattr(got, field), getattr(ref, field)), field
    assert got.stats == twin.stats == ref.stats


def test_parallel_loops_from_threads_beside_torch():
    # torch is imported and its OpenMP pool started; the library's
    # parallel loops (threads of their own) then run from several Python
    # threads at once
    torch.ones(1000).sum()
    rng = np.random.default_rng(7)
    order = rng.permutation(400_000).astype(np.int32)
    counts = rng.integers(0, 60, 20_000)
    starts = np.minimum(np.cumsum(counts) - counts, 400_000 - 60)
    wanted = np.arange(20_000)
    dims = np.array([60, 50, 40], np.int64)
    qdims = -(-dims // 3)
    tiles = np.arange(int(qdims.prod()), dtype=np.int64)
    grid_row = rng.integers(0, 1000, int(dims.prod())).astype(np.int32)
    cloud = _clustered_cloud(400_000)
    lo = cloud.min(0).astype(np.float64)
    table = native.fill_table(order, starts, counts, wanted, 32,
                              impl="numpy")
    rows = native.neighbor_rows(tiles, dims, qdims, 3, grid_row, -7,
                                impl="numpy")
    quant = native.quantize_u16(cloud, lo, 0.001, pad_to=1 << 21,
                                impl="numpy")
    results, errors = [], []

    def work():
        try:
            for _ in range(3):
                results.append(
                    _equal(native.fill_table(order, starts, counts, wanted,
                                             32), table)
                    and _equal(native.neighbor_rows(tiles, dims, qdims, 3,
                                                    grid_row, -7), rows)
                    and _equal(native.quantize_u16(cloud, lo, 0.001,
                                                   pad_to=1 << 21), quant))
        except Exception as err:               # reported below
            errors.append(err)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
        assert not thread.is_alive()
    assert not errors and len(results) == 18 and all(results)
    runtimes = {line.split()[-1] for line in open("/proc/self/maps")
                if "libgomp" in line}
    print(f"OpenMP runtimes in the process: {sorted(runtimes)}")


_BROKEN_CXX = """#!/bin/sh
echo "error: the compiler is broken" >&2
exit 1
"""


def test_failed_build_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text(_BROKEN_CXX)
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="the compiler is broken"):
        native.library()
    cloud = _clustered_cloud(100)
    with pytest.raises(RuntimeError, match="the compiler is broken"):
        native.quantize_u16(cloud, np.zeros(3), 0.01)
    with pytest.raises(RuntimeError, match="the compiler is broken"):
        tpl._cloud_bounds(cloud)
    # the twin needs no library
    assert native.minmax3(cloud, impl="numpy")[0].shape == (3,)
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


def test_build_key_covers_compiler_and_machine(tmp_path, monkeypatch):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'c++ (Stand-in) 1.0'\n")
    cxx.chmod(0o755)
    path = native.library_path()
    assert os.path.basename(path).startswith("tilesort-")
    assert native.library_path(str(cxx)) != path
    monkeypatch.setattr(native.platform, "machine", lambda: "aarch64")
    native._compiler_id.cache_clear()
    try:
        assert native.library_path() != path
    finally:
        monkeypatch.undo()
        native._compiler_id.cache_clear()
    assert native.library_path() == path
