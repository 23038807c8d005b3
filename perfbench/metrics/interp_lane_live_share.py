"""The attribute interp's live lanes, in percent: the candidate lanes of
the interp's chebyshev kernel that hold a raw point (counter
``interp_lanes_live``) over the lanes launched (``interp_lanes``:
entries x c_cap over bands and capacity buckets), over the traced
segment; from the program's counters, which the interp's span counts
apart from the extraction's (the scans ``classify_ms.traced`` pairs
with the segment).  None where the program counts nothing under these
names."""

from perfbench.metrics.slot_live_share import share


def read(records):
    return share(records, "interp_lanes_live", "interp_lanes")
