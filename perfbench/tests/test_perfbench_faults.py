"""The check catches a broken timed path: a run of a tiny cell on the
CPU (the look for a card skipped) with the path broken underneath
(``perfbench.faults``) comes out not correct, once for each fault a
serving cell can have, and for two faults that break only a part of the
points.  (One chip: there is no exchange between chips to leave out.)"""

import pytest

from perfbench import faults
from perfbench_tiny import tiny_run

CELLS = ["site_linear.rescan_1m", "site_rpte.rescan_1m",
         "site_linear.designated_1m"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(workload, fault):
    # two warm-up scans: the window's first scan differs from the last
    # one staged
    line, checks, records = tiny_run(workload, points=30000, seconds=0.1,
                                     warmup=2, fault=fault)
    assert line["correct"] is False, checks
    failing = {name for name, c in checks.items()
               if name != "failed_clouds" and c["value"] > c["limit"]}
    assert failing, checks
    if fault in faults.LOCAL:
        # confined to a part of the points: the tail catches it
        assert "miss_share" in failing, checks
        assert records["numbers"]["miss_share"] < 0.5, records["numbers"]
