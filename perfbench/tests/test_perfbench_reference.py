"""The plain reference agrees with the port at a tiny size on the CPU:
the upload's points bit for bit, each band's voxel set exactly, and the
served probabilities within the comparison's rounding."""

import numpy as np
import pytest
import torch

from perfbench.core import scene
from perfbench.reference import features as rfeat
from perfbench_tiny import tiny_run

LO = np.zeros(3, np.float32)
HI = np.array([20.0, 20.4, 9.0], np.float32)


def _cloud(n=5000, seed=11):
    return scene.bench_cloud(n, seed, 0.2)[0]


def test_upload_matches_the_port_bit_for_bit():
    from nimrud_tpu_torch import pipeline

    cloud = _cloud()
    quant, dequant = pipeline._quantize_upload(cloud, LO, HI, len(cloud),
                                               "cpu")
    port = pipeline._dequantize(quant, dequant)
    ref = rfeat.Upload(LO, HI).served(torch.from_numpy(cloud))
    assert torch.equal(port.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("edge", [0.25, 0.5, 1.0])
def test_voxel_sets_match_the_port(edge):
    from nimrud_tpu_torch.ops import packing, unique

    points = rfeat.Upload(LO, HI).served(torch.from_numpy(_cloud()))
    spec = packing.GridSpec.fit_bounds(LO, HI, edge)
    centers, count, mask = unique.unique_voxels(points, spec)
    port = {tuple(c) for c in centers[mask].tolist()}
    grid = rfeat.VoxelGrid(points, LO, HI, edge)
    cells = torch.nonzero(grid.occupied)
    ref = {tuple(c) for c in grid.centers(cells).tolist()}
    assert int(count) == grid.count and port == ref


@pytest.mark.parametrize("workload", ["site_linear.rescan_1m",
                                      "site_rpte.rescan_1m",
                                      "site_linear.designated_1m"])
def test_served_probabilities_match_the_reference(workload):
    line, checks, records = tiny_run(workload, points=30000)
    nums = records["numbers"]
    assert line["failed"] == 0 and nums["points"] > 0
    assert nums["gap_median"] < 1e-5
    assert nums["miss_share"] <= 0.01
    assert nums["gap_max"] < 0.5


def test_scene_is_the_ports_bench_cloud():
    from nimrud_tpu_torch.utils.workload import make_bench_cloud

    ours, port = scene.bench_cloud(20000, 5), make_bench_cloud(20000, 5)
    assert np.array_equal(ours[0], port[0])
    assert np.array_equal(ours[1], port[1])


def test_a_site_seed_fixes_the_walls_for_every_run_seed():
    spec = {"generator": "rescan", "loop": "closed", "points": 4000,
            "pool": 2, "site_seed": 3}
    one = scene.make_traffic(spec, 1, LO, HI)
    two = scene.make_traffic(spec, 2, LO, HI)
    walls = [c[0][c[1] == 1] for c in (one.fit, two.fit)]
    # the same wall offsets: every wall point of either scan lies in the
    # union of the site's eight 0.2 x 12 m footprints
    offsets = scene.site_walls(3)
    for pts in walls:
        inside = np.zeros(len(pts), bool)
        for x, y in offsets:
            inside |= ((pts[:, 0] >= x) & (pts[:, 0] <= x + 0.2)
                       & (pts[:, 1] >= y) & (pts[:, 1] <= y + 12))
        assert inside.all()
    assert not np.array_equal(one.pool[0], two.pool[0])
