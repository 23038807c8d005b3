"""The classifier inside the serving step: milliseconds a scan between
the CUDA events that open and close the program's
``nimrud.predict.classify`` spans (one an entry chunk), summed over a
scan's chunks, the median over the traced segment's scans; from
``nimrud_tpu_torch.utils.profiling.collected()``.  Device work in
``site_rpte`` (the forest walk on every slot the plan lays out); in the
linear cells the softmax is a few kernels that the card runs as fast as
the host issues them, so the reading is the host's dispatch of the
softmax.  None where the program records no such span."""

import collections
import statistics

from nimrud_tpu_torch.utils import profiling

SPAN = "nimrud.predict.classify"
TOP = "nimrud.predict"


def _pairs(range_us, span_ms):
    """Whether a trace range and a span record time the same call: the
    range holds the record's host start and end and, beside them, only
    its own CUDA events' records."""
    return abs(range_us / 1e3 - span_ms) <= 1.0 + 0.05 * span_ms


def traced(records):
    """The program's records of the traced segment's scans:
    ``{"spans": [...], "counters": {name: int}}`` over the scans of the
    last ``nimrud.predict`` spans of ``collected()``, as many as the
    segment's ``nimrud.predict`` ranges in ``records["trace"]`` and
    pairing with them one by one in order and host duration.  None
    without a trace, without such ranges (a program without spans), or
    where the program's records do not pair with them."""
    trace = records.get("trace")
    collect = getattr(profiling, "collected", None)
    if trace is None or collect is None:
        return None
    lo, hi = trace["window_us"]
    ranges = sorted((a, b) for n, a, b, cat in trace["host"]
                    if n == TOP and cat == "user_annotation"
                    and lo <= a and b <= hi)
    if not ranges:
        return None
    got = collect()
    tops = sorted((s for s in got["spans"] if s["name"] == TOP),
                  key=lambda s: s["start_ns"])[-len(ranges):]
    if len(tops) < len(ranges) or not all(
            _pairs(b - a, s["host_ms"]) for (a, b), s in zip(ranges, tops)):
        return None
    scans = {s["scan"] for s in tops}
    counters = collections.Counter()
    for scan in scans:
        counters.update(got.get("scans", {}).get(scan, {}))
    return {"spans": [s for s in got["spans"] if s["scan"] in scans],
            "counters": dict(counters)}


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
