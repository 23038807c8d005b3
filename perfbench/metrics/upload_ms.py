"""Host staging's upload: the median, over the traced segment's scans,
of the host duration of the program's ``nimrud.stage.upload`` range
(the copies of the staged cloud and its dequantization vector to the
card, pageable and so synchronous: the copy's wall on the host, under
the profiler) in the profiler's trace, milliseconds.  None where the
program has no such range."""

import statistics

RANGE = "nimrud.stage.upload"


def range_ms(records, name):
    """The median host duration of the program's range ``name`` in the
    traced segment, ms; None without a trace or such a range."""
    trace = records.get("trace")
    if trace is None:
        return None
    values = [(hi - lo) / 1e3 for n, lo, hi, cat in trace["host"]
              if n == name and cat == "user_annotation"]
    return statistics.median(values) if values else None


def read(records):
    return range_ms(records, RANGE)
