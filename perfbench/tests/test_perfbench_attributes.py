"""Attributes through the timed path: a tiny cell kept out of
BENCHMARK.json (``perfbench_tiny.attributed_cell``: ``site_linear``'s
bands with the ``vector`` layout on ``rescan_attributed``'s scans, four
columns a point) runs ``bench.run`` on the CPU, and the program agrees
with the ``vector`` reference; the TF32 control fails where the program
passes; a planted fault that hands the program its columns in another
order comes out not correct; the generator leaves ``rescan``'s streams
as they are."""

import numpy as np
import pytest

from perfbench import faults
from perfbench.core import scene
from perfbench.generators import rescan, rescan_attributed
from perfbench_tiny import attributed_cell, tiny_run

LO = np.zeros(3, np.float32)
HI = np.array([20.0, 20.4, 9.0], np.float32)


def test_an_attributed_cell_agrees_with_the_reference():
    line, checks, records = tiny_run(None, trace=True, points=30000,
                                     check_rows=1024)
    nums = records["numbers"]
    assert line["correct"] is True and line["failed"] == 0, checks
    assert nums["points"] == 1024 and nums["gap_max"] < 1e-4
    work = records["work"]
    assert set(work) == {"points", "pairs", "voxels", "interp_pairs",
                         "interp_ambiguous", "attr_cols"}
    assert work["attr_cols"] == [4.0, 4.0, 4.0]
    assert all(p > v for p, v in zip(work["interp_pairs"], work["voxels"]))
    assert 0 <= nums["interp_tie_points"] <= nums["points"]


def test_the_control_fails_where_the_program_passes():
    checks = attributed_cell().config["checks"]
    _, _, records = tiny_run(None, points=30000, control=True,
                             check_rows=1024)
    for name, limit in checks.items():
        assert records["numbers"][name] <= limit, records["numbers"]
    assert any(records["control"][name] > limit
               for name, limit in checks.items()), records["control"]


@pytest.mark.parametrize("fault", sorted(faults.ATTRIBUTE_FAULTS))
def test_columns_in_another_order_are_not_correct(fault):
    line, checks, _ = tiny_run(None, points=30000, seconds=0.1,
                               check_rows=1024, fault=fault)
    assert line["correct"] is False, checks


def test_the_generator_keeps_rescans_streams():
    spec = {"generator": "rescan_attributed", "loop": "closed",
            "points": 4000, "pool": 2, "site_seed": 3, "attributes": 4}
    seed = 2 ** 31 + 5
    plain = rescan.make(spec, seed, LO, HI)
    got = scene.make_traffic(spec, seed, LO, HI)
    assert np.array_equal(got.fit[0], plain.fit[0])
    assert np.array_equal(got.fit[1], plain.fit[1])
    assert all(np.array_equal(a, b) for a, b in zip(got.pool, plain.pool))
    assert plain.attributes is None
    fit, pool = got.attributes
    assert fit.shape == (4000, 4) and fit.dtype == np.float32
    assert len(pool) == 2 and not np.array_equal(pool[0], pool[1])
    # a column is its class's mean plus the noise
    for label in (0, 1):
        mean = fit[got.fit[1] == label].mean(0)
        assert np.allclose(mean, rescan_attributed.MEANS[:4, label],
                           atol=0.01)
    again = scene.make_traffic(spec, seed, LO, HI)
    assert np.array_equal(again.attributes[0], fit)
    with pytest.raises(ValueError, match="attributes must be 1-6"):
        scene.make_traffic(dict(spec, attributes=7), seed, LO, HI)
