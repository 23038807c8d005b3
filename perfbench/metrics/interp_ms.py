"""The ``vector`` layout's attribute interp inside the serving step:
milliseconds a scan between the CUDA events that open and close the
program's ``nimrud.predict.search.interp`` spans (one a band: the
interp's plan on the raw cloud and its chebyshev kernel, or another
interp route), summed over a scan's bands, the median over the traced
segment's scans; from ``nimrud_tpu_torch.utils.profiling.collected()``,
the scans ``classify_ms.traced`` pairs with the segment.  None where
the program records no such span (a geometry layout, or a program
without it)."""

import statistics

from perfbench.metrics.classify_ms import traced

SPAN = "nimrud.predict.search.interp"


def read(records):
    got = traced(records)
    if got is None:
        return None
    by_scan = {}
    for span in got["spans"]:
        if span["name"] == SPAN and span["device_ms"] is not None:
            by_scan[span["scan"]] = by_scan.get(span["scan"], 0.0) \
                + span["device_ms"]
    return statistics.median(by_scan.values()) if by_scan else None
