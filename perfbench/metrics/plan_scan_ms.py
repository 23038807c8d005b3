"""The device plan's int64 scans: device milliseconds a served cloud of
the int64 ``cummax`` / ``cummin`` kernels (PyTorch's scans with
indices over ``long``), by name from the profiler's trace."""

import re

SCAN = re.compile(r"scan\w*_with_indices<long")


def read(records):
    trace = records.get("trace")
    if trace is None:
        return None
    us = [hi - lo for name, lo, hi in trace["device"] if SCAN.search(name)]
    if not us:
        return None
    return sum(us) / 1e3 / trace["clouds"]
