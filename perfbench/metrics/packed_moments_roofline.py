"""The moment kernel's share of its roofline, in percent: the least time
an H100 needs for the moment work of a served cloud
(``core.peaks.moments_bound_s``: the reference's in-radius pairs and
voxel counts of the traced clouds) over the device time a cloud of the
kernels named ``packed_moments`` in the profiler's trace."""

from perfbench.core import peaks


def read(records):
    trace, work = records.get("trace"), records.get("work")
    if trace is None or work is None:
        return None
    us = [hi - lo for name, lo, hi in trace["device"]
          if "packed_moments" in name]
    if not us:
        return None
    kernel_s = sum(us) / 1e6 / trace["clouds"]
    bound_s, _ = peaks.moments_bound_s(work["points"], work["pairs"],
                                       work["voxels"])
    return 100.0 * bound_s / kernel_s
