"""The lower-precision control comes out not correct: the reference
computed in TF32 (its masked sums and products with operands rounded to
10 mantissa bits, the rest in float32), put in the program's place on
the same sampled points, fails the number its configuration compares,
while the program passes it.  A tiny cell on the CPU; the readings at
the cells' own sizes on the card are in PERF.md (``readings.py``)."""

import pytest

from perfbench.core.cell import Cell
from perfbench_tiny import tiny_run

CELLS = ["site_linear.rescan_1m", "site_rpte.rescan_1m"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    checks = Cell(workload).config["checks"]
    _, _, records = tiny_run(workload, points=30000, control=True,
                             check_rows=2048)
    for name, limit in checks.items():
        assert records["numbers"][name] <= limit, records["numbers"]
    assert any(records["control"][name] > limit
               for name, limit in checks.items()), records["control"]
