"""The attribute interp kernel's share of its roofline, in percent: the
least time an H100 needs for the ``vector`` layout's interp of a served
cloud (``core.peaks.interp_bound_s``: the reference's interp pairs and
voxel counts of the traced clouds, 1 + A sums a pair) over the device
time a cloud of the kernels named ``packed_interp`` in the profiler's
trace.  None without a trace, without the interp's work (a geometry
layout), or where no such kernel ran."""

from perfbench.core import peaks


def read(records):
    trace, work = records.get("trace"), records.get("work")
    if trace is None or work is None or "interp_pairs" not in work:
        return None
    us = [hi - lo for name, lo, hi in trace["device"]
          if "packed_interp" in name]
    if not us:
        return None
    kernel_s = sum(us) / 1e6 / trace["clouds"]
    bound_s, _ = peaks.interp_bound_s(work["points"], work["interp_pairs"],
                                      work["voxels"],
                                      1 + int(work["attr_cols"][0]))
    return 100.0 * bound_s / kernel_s
