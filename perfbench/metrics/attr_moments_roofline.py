"""The attribute means' share of their roofline, in percent: the least
time an H100 needs for the ``vector`` layout's second stage of a served
cloud, the means of the centres' interpolated columns over each radius
(``core.peaks.moments_bound_s`` with 1 + A sums a pair and each centre
read with its A columns: the reference's in-radius pairs and voxel
counts of the traced clouds) over the device time a cloud of the
kernels named ``packed_attr`` in the profiler's trace.  None without a
trace, without the attribute columns' work (a geometry layout), or
where no such kernel ran."""

from perfbench.core import peaks


def read(records):
    trace, work = records.get("trace"), records.get("work")
    if trace is None or work is None or "attr_cols" not in work:
        return None
    us = [hi - lo for name, lo, hi in trace["device"]
          if "packed_attr" in name]
    if not us:
        return None
    kernel_s = sum(us) / 1e6 / trace["clouds"]
    cols = int(work["attr_cols"][0])
    bound_s, _ = peaks.moments_bound_s(work["points"], work["pairs"],
                                       work["voxels"], cols=1 + cols,
                                       voxel_bytes=12 + 4 * cols)
    return 100.0 * bound_s / kernel_s
